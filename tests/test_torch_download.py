"""The downloader's offline half on the port against the JAX package's, on the same
directories: the tokenizer-artifact and completeness rules, the layer-aware file
filter, the model status, seeding, the local downloader and HFShardDownloader's fast
path for a checkpoint already on disk (which the port's engine and `main.py run` then
serve). A checkpoint that is not on disk is fetched from HF_ENDPOINT, here always a
local mirror (download/hf_mirror.py); tests/test_torch_hf_download.py holds the fetch
against JAX's.
"""
import asyncio
import json
import shutil

import pytest
import torch
from safetensors.torch import load_file

from tests.test_model_equivalence import TINY_LLAMA_CFG, make_hf_checkpoint
from xotorch_tpu.download import hf_shard_download as j_hf
from xotorch_tpu.download.shard_download import LocalShardDownloader as JLocalShardDownloader
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.download import hf_shard_download as hf
from xotorch_tpu_torch.download.hf_mirror import HFMirror
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.models import registry

torch.set_num_threads(2)
TORCH, JAX = "TorchShardInferenceEngine", "JAXShardInferenceEngine"
# A two-file checkpoint of a 4-layer model: layers 0-1 and the embedding in the first
# file, layers 2-3, the final norm and the head in the second.
WEIGHT_MAP = {
  "model.embed_tokens.weight": "model-00001-of-00002.safetensors",
  "model.layers.0.mlp.up_proj.weight": "model-00001-of-00002.safetensors",
  "model.layers.1.mlp.up_proj.weight": "model-00001-of-00002.safetensors",
  "model.layers.2.mlp.up_proj.weight": "model-00002-of-00002.safetensors",
  "model.layers.3.mlp.up_proj.weight": "model-00002-of-00002.safetensors",
  "model.norm.weight": "model-00002-of-00002.safetensors",
  "lm_head.weight": "model-00002-of-00002.safetensors",
}
SHARDS = [None, (0, 3), (0, 1), (2, 3), (1, 2)]


def _both_complete(d, n=4):
  """checkpoint_complete of the port and of JAX, for the whole repo and each shard."""
  got = [hf.checkpoint_complete(d, None if s is None else Shard("m", *s, n)) for s in SHARDS]
  want = [j_hf.checkpoint_complete(d, None if s is None else JShard("m", *s, n)) for s in SHARDS]
  assert got == want
  return got


def _touch(d, *names):
  for name in names:
    (d / name).parent.mkdir(parents=True, exist_ok=True)
    (d / name).write_bytes(b"x")


@pytest.mark.parametrize("artifact", ["tokenizer.json", "tokenizer.model", "vocab.json",
                                      "spiece.model", "tokenizer_config.json", None])
def test_tokenizer_artifact_rule_matches_jax(tmp_path, artifact):
  if artifact:
    _touch(tmp_path, artifact)
  assert hf.has_tokenizer_artifact(tmp_path) == j_hf.has_tokenizer_artifact(tmp_path)
  assert hf.has_tokenizer_artifact(tmp_path) == (artifact not in (None, "tokenizer_config.json"))


def test_checkpoint_complete_with_an_index_matches_jax(tmp_path):
  d = tmp_path / "org--m"
  d.mkdir()
  (d / "model.safetensors.index.json").write_text(json.dumps({"weight_map": WEIGHT_MAP}))
  assert _both_complete(d) == [False] * 5  # no config, no tokenizer
  _touch(d, "config.json")
  assert _both_complete(d) == [False] * 5  # no tokenizer
  _touch(d, "tokenizer.json", "model-00002-of-00002.safetensors")
  # Only the second file: the shards that need nothing of the first are complete.
  assert _both_complete(d) == [False, False, False, True, False]
  _touch(d, "model-00001-of-00002.safetensors")
  assert _both_complete(d) == [True] * 5
  (d / "model.safetensors.index.json").write_text(json.dumps({"weight_map": {}}))
  assert _both_complete(d) == [False] * 5  # an empty index
  (d / "model.safetensors.index.json").write_text("{not json")
  assert _both_complete(d) == [False] * 5


def test_checkpoint_complete_without_an_index_matches_jax(tmp_path):
  d = tmp_path / "org--m"
  _touch(d, "config.json", "tokenizer.model")
  assert _both_complete(d) == [False] * 5  # no weights
  _touch(d, "model.safetensors")
  assert _both_complete(d) == [True] * 5
  _touch(d, "extra.safetensors.partial")
  assert _both_complete(d) == [False] * 5  # an interrupted download
  (d / "extra.safetensors.partial").unlink()
  hf.write_download_manifest(d, ["model.safetensors", "more.safetensors"])
  assert _both_complete(d) == [False] * 5  # the manifest names a missing file
  _touch(d, "more.safetensors")
  assert _both_complete(d) == [True] * 5
  # The index one level down, as some repos nest their weights.
  nested = tmp_path / "org--nested"
  _touch(nested, "config.json", "tokenizer.json", "w/model-00001-of-00002.safetensors",
         "w/model-00002-of-00002.safetensors")
  (nested / "w" / "model.safetensors.index.json").write_text(json.dumps({"weight_map": WEIGHT_MAP}))
  assert _both_complete(nested) == [True] * 5


def test_allow_patterns_match_jax():
  for start, end in SHARDS[1:]:
    assert (hf.get_allow_patterns(WEIGHT_MAP, Shard("m", start, end, 4))
            == j_hf.get_allow_patterns(WEIGHT_MAP, JShard("m", start, end, 4)))
  for path in ("config.json", "sub/tokenizer.model", "model-00001-of-00002.safetensors", "a.bin"):
    patterns = ["*.json", "tokenizer.model", "model-00001-of-00002.safetensors"]
    assert hf._matches(path, patterns) == j_hf._matches(path, patterns)


def test_model_status_matches_jax(tmp_path, monkeypatch):
  monkeypatch.setenv("XOT_HOME", str(tmp_path))
  assert hf.xot_home() == j_hf.xot_home() == tmp_path
  assert hf.models_dir() == j_hf.models_dir() == tmp_path / "models"
  d = tmp_path / "models" / "google--gemma-2-2b-it"
  for step in range(3):
    for model in ("gemma2-2b", "synthetic-llama-1b", "no-such-model"):
      got = hf.local_model_status(model, TORCH)
      want = j_hf.local_model_status(model, JAX)
      assert got == want, (step, model)
    if step == 0:
      _touch(d, "config.json", "model.safetensors")  # present, incomplete
    elif step == 1:
      _touch(d, "tokenizer.json")
  assert hf.local_model_status("gemma2-2b", TORCH)["downloaded"] is True


async def test_seed_models_matches_jax(tmp_path, monkeypatch):
  for side in ("port", "jax"):
    seed = tmp_path / side / "seed"
    _touch(seed / "org--a", "config.json")
    _touch(seed / "org--b", "config.json")
    _touch(seed, "loose-file")
    home = tmp_path / side / "home"
    _touch(home / "models" / "org--b", "kept")  # an existing dir is kept, not replaced
    monkeypatch.setenv("XOT_HOME", str(home))
    await (hf.seed_models if side == "port" else j_hf.seed_models)(str(seed))
  listing = {side: sorted(str(p.relative_to(tmp_path / side)) for p in (tmp_path / side).rglob("*"))
             for side in ("port", "jax")}
  assert listing["port"] == listing["jax"]
  assert (tmp_path / "port" / "home" / "models" / "org--a" / "config.json").exists()
  await hf.seed_models(str(tmp_path / "missing"))  # a missing seed dir is no error


async def test_local_downloader_matches_jax(tmp_path, monkeypatch):
  (tmp_path / "root" / "m").mkdir(parents=True)
  port, jax_ = LocalShardDownloader({"x": tmp_path / "x"}), JLocalShardDownloader({"x": tmp_path / "x"})
  assert await port.ensure_shard(Shard("x", 0, 0, 1), TORCH) == tmp_path / "x"
  assert await jax_.ensure_shard(JShard("x", 0, 0, 1), JAX) == tmp_path / "x"
  monkeypatch.setenv("XOT_MODEL_DIR", str(tmp_path / "root"))
  assert await port.ensure_shard(Shard("m", 0, 0, 1), TORCH) == tmp_path / "root" / "m"
  assert await jax_.ensure_shard(JShard("m", 0, 0, 1), JAX) == tmp_path / "root" / "m"
  for dl, shard in ((port, Shard("n", 0, 0, 1)), (jax_, JShard("n", 0, 0, 1))):
    with pytest.raises(FileNotFoundError, match="No local model dir for n"):
      await dl.ensure_shard(shard, TORCH)


@pytest.fixture()
def seeded_card(tmp_path, monkeypatch):
  """A tiny llama checkpoint in XOT_HOME/models/test--tiny-llama, served by a card
  'tiny-llama' of the port's registry."""
  monkeypatch.setenv("XOT_HOME", str(tmp_path / "home"))
  model_dir = make_hf_checkpoint(tmp_path / "make", TINY_LLAMA_CFG, seed=3)
  (model_dir / "tokenizer.model").write_bytes(b"not a real tokenizer")
  monkeypatch.setitem(registry.model_cards, "tiny-llama",
                      {"layers": 4, "repo": {TORCH: "test/tiny-llama"}})
  return model_dir


async def test_offline_fast_path_serves_a_seeded_checkpoint(seeded_card, tmp_path, monkeypatch):
  """A checkpoint missing on disk is fetched from HF_ENDPOINT (a local mirror of the
  seeded one), as JAX's downloader fetches it; once complete, a fresh downloader's fast
  path serves it without a request."""
  dl = hf.HFShardDownloader()
  shard = Shard("tiny-llama", 0, 3, 4)
  target = tmp_path / "home" / "models" / "test--tiny-llama"
  with HFMirror({"test/tiny-llama": seeded_card}) as mirror:
    monkeypatch.setenv("HF_ENDPOINT", mirror.url)
    with pytest.raises(ValueError, match="No repo"):
      await dl.ensure_shard(Shard("synthetic-tiny", 0, 3, 4), TORCH)
    # Concurrent calls share one task; the finished path is remembered.
    paths = await asyncio.gather(*(dl.ensure_shard(shard, TORCH) for _ in range(3)))
    assert paths == [target] * 3 and dl.completed[("tiny-llama", "0-3")] == target
    assert not dl.active_downloads
    served = sorted(p.name for p in seeded_card.iterdir())
    assert sorted(p.name for p in target.iterdir()) == sorted(served + [hf.MANIFEST_NAME])
    for name in served:
      assert (target / name).read_bytes() == (seeded_card / name).read_bytes()
    assert j_hf.HFShardDownloader._local_complete(target, JShard("tiny-llama", 0, 3, 4))
    requests = len(mirror.log)
    assert await hf.HFShardDownloader().ensure_shard(shard, TORCH) == target
    assert len(mirror.log) == requests


async def test_engine_and_run_command_serve_the_seeded_checkpoint(seeded_card, tmp_path, capsys):
  seed = tmp_path / "seed"
  shutil.copytree(seeded_card, seed / "test--tiny-llama")
  args = port_main.build_parser().parse_args(
    ["run", "tiny-llama", "--device", "cpu", "--prompt", "one two three", "--max-generate-tokens",
     "4", "--models-seed-dir", str(seed)])
  await hf.seed_models(args.models_seed_dir)  # what async_main does first
  assert not (seed / "test--tiny-llama").exists()
  node, engine, classname, _ = port_main.build_node(args)
  try:
    assert isinstance(engine.shard_downloader, hf.HFShardDownloader)
    tokens = await port_main.run_model_cli(node, classname, "tiny-llama", args.prompt)
    assert engine.shard == Shard("tiny-llama", 0, 3, 4)
    assert engine._ctx.model_dir == tmp_path / "home" / "models" / "test--tiny-llama"
    # The tokenizer file cannot be built: the fake, with the config's eos.
    assert engine.tokenizer.eos_token_id == TINY_LLAMA_CFG["eos_token_id"]
  finally:
    engine.executor.shutdown(wait=True)
  assert 1 <= len(tokens) <= 4
  assert "dummy" in capsys.readouterr().out
  # The engine's weights are the checkpoint's, in its compute dtype.
  want = load_file(str(tmp_path / "home" / "models" / "test--tiny-llama" / "model.safetensors"))
  assert torch.equal(engine._ctx.params["final_norm"], want["model.norm.weight"].to(engine.dtype))
