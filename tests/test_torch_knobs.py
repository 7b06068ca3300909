"""The port's knob registry against the JAX package's: every JAX knob is registered by
the port or named in its exclusions with a reason, and the knobs of the modules ported
last (the native sidecar's, XOT_PAGED_KERNEL) keep JAX's kind and default; the
engine refuses XOT_PAGED_KERNEL=0, whose gathered view is not ported."""
import pytest
import torch

from xotorch_tpu.utils import knobs as j_knobs
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.utils import knobs


def test_every_jax_knob_is_registered_or_excluded_with_a_reason():
  missing = sorted(set(j_knobs.REGISTRY) - set(knobs.REGISTRY) - set(knobs.EXCLUDED))
  assert missing == []
  assert not set(knobs.EXCLUDED) & set(knobs.REGISTRY)
  assert set(knobs.EXCLUDED) <= set(j_knobs.REGISTRY)  # each names a real JAX knob
  assert len(knobs.EXCLUDED) == 14
  assert all(isinstance(r, str) and len(r) > 20 for r in knobs.EXCLUDED.values())
  assert {n for n in knobs.EXCLUDED if n.startswith("XOT_SOAK_")} == {
    n for n in j_knobs.REGISTRY if n.startswith("XOT_SOAK_")}


@pytest.mark.parametrize("name", ["XOT_SIDECAR_BIN", "XOT_SIDECAR_QUANT", "XOT_PAGED_KERNEL"])
def test_the_last_knobs_keep_jaxs_kind_and_default(name):
  mine, theirs = knobs.REGISTRY[name], j_knobs.REGISTRY[name]
  assert (mine.kind, mine.default) == (theirs.kind, theirs.default)
  assert mine.doc


@pytest.mark.parametrize("value,refused", [(None, False), ("1", False), ("0", True), ("false", True)])
def test_paged_kernel_knob(monkeypatch, value, refused):
  if value is None:
    monkeypatch.delenv("XOT_PAGED_KERNEL", raising=False)
  else:
    monkeypatch.setenv("XOT_PAGED_KERNEL", value)
  if refused:
    with pytest.raises(ValueError, match="XOT_PAGED_KERNEL=0 .*gathered paged view.*K3/K4"):
      TorchShardInferenceEngine(device="cpu")
  else:
    engine = TorchShardInferenceEngine(device="cpu")
    engine.executor.shutdown(wait=True)
    assert engine.device == torch.device("cpu")
