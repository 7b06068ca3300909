"""InferenceEngine ABC + factory.

The port's copy of xotorch_tpu/inference/engine.py: the ABC the Node drives,
`CacheExhausted`, `RequestStateLost` and the engine factory. Engines work on numpy at
the boundary, so the orchestration layer never sees device tensors (a bf16 hidden
state or gradient travels as a CPU torch tensor, numpy has no bf16). The contract
serves inference, multi-LoRA adapters (`base@name` shards), `load_checkpoint` /
`save_checkpoint`, the session store, and pipelined training (`train_example`,
`evaluate_example`).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Tuple

import numpy as np

from xotorch_tpu_torch.inference.shard import Shard


class CacheExhausted(Exception):
  """The request's KV cache is full: generation cannot continue, but the tokens
  produced so far are valid — the orchestrator ends the request as a normal 'length'
  finish rather than an error."""


class RequestStateLost(Exception):
  """The engine no longer holds the request's device state. Continuing would silently
  restart from an empty cache; the orchestrator must abort the request instead."""


class InferenceEngine(ABC):
  """One peer's compute backend for a layer-range shard."""

  # Observability hooks, installed by the owning Node (orchestration/node.py):
  # `flight` is the node's FlightRecorder, `metrics` its NodeMetrics, `tracer` its
  # Tracer, and `trace_ctx` a request-id -> TraceContext resolver so engine-depth child
  # spans join the request's trace. `perf` is the engine's own PerfAttribution
  # (XOT_PERF_ATTR). All duck-typed and None by default: a standalone engine (tests,
  # the smoke's kernel phases) records nothing and pays only a None check.
  flight = None
  metrics = None
  tracer = None
  trace_ctx = None
  perf = None
  session: Dict[str, Any]  # save_session / clear_session's store; each engine makes its own

  @abstractmethod
  async def encode(self, shard: Shard, prompt: str) -> np.ndarray:
    ...

  @abstractmethod
  async def sample(self, x: np.ndarray, temp: float = 0.0, top_k: int = 0, top_p: float = 0.0) -> np.ndarray:
    ...

  @abstractmethod
  async def decode(self, shard: Shard, tokens: np.ndarray) -> str:
    ...

  @abstractmethod
  async def infer_tensor(
    self, request_id: str, shard: Shard, input_data: np.ndarray, inference_state: Optional[dict] = None
  ) -> Tuple[np.ndarray, Optional[dict]]:
    """Run this shard's layers. 2-D int input = token ids (first shard); 3-D float
    input = hidden state from the previous shard."""
    ...

  @abstractmethod
  async def ensure_shard(self, shard: Shard) -> None:
    ...

  @abstractmethod
  async def infer_sample_tensor(
    self, request_id: str, shard: Shard, input_data: np.ndarray, temp: float = 0.0, top_k: int = 0,
    inference_state: Optional[dict] = None, top_p: float = 0.0, sampling: Optional[dict] = None,
  ) -> Tuple[int, Optional[dict]]:
    """Run the last shard's layers and sample on the device: the host gets one int.
    `sampling` holds the request's OpenAI extras (seed, logit_bias, presence_penalty,
    frequency_penalty, min_p, logprobs), kept with the request for its later calls
    and decode chunks."""
    ...

  @abstractmethod
  async def generate_chunk(
    self, request_id: str, shard: Shard, prev_token: int, num_tokens: int, temp: float = 0.0,
    top_k: int = 0, top_p: float = 0.0, next_size: Optional[int] = None,
  ) -> Optional[np.ndarray]:
    """Up to `num_tokens` tokens decoded on the device for a prefilled request whose
    shard spans the whole model."""
    ...

  async def clear_request(self, request_id: str) -> None:
    """Free the request's state (its KV cache): the Node calls it when a request ends."""

  def page_pool_stats(self) -> Optional[dict]:
    """The paged KV pool's gauges (/metrics), or None: no pool."""
    return None

  def perf_stats(self) -> Optional[dict]:
    """The roofline EWMA gauges (/metrics), or None: no attribution."""
    return None

  def perf_report(self) -> Optional[dict]:
    """The roofline attribution report (/v1/perf), or None: no attribution."""
    return None

  def perf_compact(self) -> Optional[dict]:
    """The compact perf summary the status bus carries, or None."""
    return None

  def pop_logprobs(self, request_id: str, n: Optional[int] = None) -> Optional[list]:
    """Drain up to `n` (default all) of the request's recorded logprob entries
    ({"logprob", "top": [(id, logprob), ...]} a sampled token, in sampling order); None
    when nothing was recorded."""
    return None

  async def infer_prompt(
    self, request_id: str, shard: Shard, prompt: str, inference_state: Optional[dict] = None,
    images: Optional[list] = None, **engine_kwargs,
  ) -> Tuple[np.ndarray, Optional[dict]]:
    """Default text path: encode -> infer_tensor."""
    if images:
      raise ValueError(
        f"{type(self).__name__} has no vision path; cannot process {len(images)} image(s)"
      )
    tokens = await self.encode(shard, prompt)
    x = tokens.reshape(1, -1)
    return await self.infer_tensor(request_id, shard, x, inference_state, **engine_kwargs)

  async def load_checkpoint(self, shard: Shard, path: str) -> None:
    """Load `path` into `shard`'s weights (an engine without checkpoints ignores it)."""

  async def save_checkpoint(self, shard: Shard, path: str) -> None:
    """Write `shard`'s weights to `path` (an engine without checkpoints ignores it)."""

  async def save_session(self, key: str, value: Any) -> None:
    self.session[key] = value

  async def clear_session(self) -> None:
    self.session.clear()

  async def train_example(
    self, request_id: str, shard: Shard, example: np.ndarray, target: np.ndarray,
    lengths: np.ndarray, forward_fn=None,
  ) -> Tuple[float, Optional[np.ndarray]]:
    """Pipelined train leaf: run this shard's slice, chain downstream through
    `forward_fn(activations, target, lengths, train=True) -> (loss, grad)`, step the
    local optimizer, return (loss, the gradient of this shard's input)."""
    raise NotImplementedError(f"{type(self).__name__} does not support training")

  async def evaluate_example(
    self, request_id: str, shard: Shard, example: np.ndarray, target: np.ndarray,
    lengths: np.ndarray, forward_fn=None,
  ) -> float:
    raise NotImplementedError(f"{type(self).__name__} does not support evaluation")


# Every alias -> canonical classname; the model registry keys repos by classname.
inference_engine_classes: Dict[str, str] = {
  "torch": "TorchShardInferenceEngine",
  "cuda": "TorchShardInferenceEngine",
  "TorchShardInferenceEngine": "TorchShardInferenceEngine",
  "dummy": "DummyInferenceEngine",
  "DummyInferenceEngine": "DummyInferenceEngine",
  # The native C++ sidecar (native/sidecar/), reached over a Unix socket.
  "native": "NativeSidecarInferenceEngine",
  "sidecar": "NativeSidecarInferenceEngine",
  "NativeSidecarInferenceEngine": "NativeSidecarInferenceEngine",
}


def get_inference_engine(inference_engine_name: str, shard_downloader=None,
                         device: Optional[str] = None, quantize: Optional[str] = None,
                         kv_quant: Optional[str] = None) -> InferenceEngine:
  classname = inference_engine_classes.get(inference_engine_name)
  if classname == "TorchShardInferenceEngine":
    from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
    return TorchShardInferenceEngine(shard_downloader, device=device, quantize=quantize,
                                     kv_quant=kv_quant)
  if classname == "DummyInferenceEngine":
    from xotorch_tpu_torch.inference.dummy import DummyInferenceEngine
    return DummyInferenceEngine()
  if classname == "NativeSidecarInferenceEngine":
    from xotorch_tpu_torch.inference.native.engine import NativeSidecarInferenceEngine
    return NativeSidecarInferenceEngine(shard_downloader)
  raise ValueError(f"Unsupported inference engine: {inference_engine_name}")
