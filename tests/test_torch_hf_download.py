"""The downloader's network half on the port against the JAX package's, both fetching
from one local HF endpoint (xotorch_tpu_torch/download/hf_mirror.py, a threaded stdlib
server) into XOT_HOMEs of their own: the files and their bytes, the final progress
event, the layer filter of the first and the last shard, the manifest of a repo
without an index, a resume from a `.partial` (the Range header the mirror logs), a 416
taken as complete, a hash mismatch that raises and deletes the partial, the retried and
cached file list, HF_TOKEN, and delete_model. The repo's files are seeded numpy bytes.
"""
import json

import numpy as np
import pytest

from xotorch_tpu.download import hf_shard_download as j_hf
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import registry as j_registry
from xotorch_tpu_torch.download import hf_shard_download as hf
from xotorch_tpu_torch.download.hf_mirror import HFMirror, MirrorHandler, file_hash
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.models import registry

TORCH, JAX = "TorchShardInferenceEngine", "JAXShardInferenceEngine"
REPO, FLAT = "test/tiny-four", "test/tiny-flat"
CARD, FLAT_CARD = "tiny-four", "tiny-flat"
FIRST, SECOND = "model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"
WEIGHT_MAP = {
  "model.embed_tokens.weight": FIRST,
  "model.layers.0.mlp.up_proj.weight": FIRST,
  "model.layers.1.mlp.up_proj.weight": FIRST,
  "model.layers.2.mlp.up_proj.weight": SECOND,
  "model.layers.3.mlp.up_proj.weight": SECOND,
  "model.norm.weight": SECOND,
  "lm_head.weight": SECOND,
}


def _bytes(rng, n: int) -> bytes:
  return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture()
def repos(tmp_path, monkeypatch):
  """Two repos on disk: a 4-layer one with an index over two weight files (3.5 and 2.25
  MiB, so several 1 MiB chunks each) and a nested notes file, and one without an index.
  The port's and JAX's registries get a card for each."""
  rng = np.random.default_rng(27)
  four = tmp_path / "src" / "four"
  (four / "extra").mkdir(parents=True)
  (four / FIRST).write_bytes(_bytes(rng, 7 << 19))
  (four / SECOND).write_bytes(_bytes(rng, 9 << 18))
  (four / "model.safetensors.index.json").write_text(json.dumps({"weight_map": WEIGHT_MAP}))
  (four / "config.json").write_text(json.dumps({"model_type": "llama", "num_hidden_layers": 4}))
  (four / "tokenizer.json").write_bytes(_bytes(rng, 3000))
  (four / "extra" / "notes.txt").write_bytes(_bytes(rng, 100))
  (four / "ignored.bin").write_bytes(_bytes(rng, 50))  # no pattern takes it
  flat = tmp_path / "src" / "flat"
  flat.mkdir()
  (flat / "model.safetensors").write_bytes(_bytes(rng, 5 << 18))
  (flat / "config.json").write_text("{}")
  (flat / "tokenizer.json").write_bytes(_bytes(rng, 500))
  for reg, key in ((registry.model_cards, TORCH), (j_registry.model_cards, JAX)):
    monkeypatch.setitem(reg, CARD, {"layers": 4, "repo": {key: REPO}})
    monkeypatch.setitem(reg, FLAT_CARD, {"layers": 2, "repo": {key: FLAT}})
  return {REPO: four, FLAT: flat}


class _Side:
  """One package's downloader, shard and XOT_HOME."""

  def __init__(self, name, home):
    self.name, self.home = name, home
    self.port = name == "port"
    self.engine = TORCH if self.port else JAX
    self.events = []

  def downloader(self):
    dl = hf.HFShardDownloader() if self.port else j_hf.HFShardDownloader()
    dl.on_progress.register("test").on_next(lambda shard, event: self.events.append(event))
    return dl

  def shard(self, model, start, end, n):
    return (Shard if self.port else JShard)(model, start, end, n)

  def module(self):
    return hf if self.port else j_hf


@pytest.fixture()
def sides(tmp_path, monkeypatch):
  monkeypatch.delenv("HF_TOKEN", raising=False)
  monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))  # no token file
  out = [_Side("port", tmp_path / "port"), _Side("jax", tmp_path / "jax")]

  def use(side):
    monkeypatch.setenv("XOT_HOME", str(side.home))
    return side
  for side in out:
    side.use = lambda s=side: use(s)
  return out


def _listing(root):
  return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _final(event):
  return (event.repo_id, event.completed_files, event.total_files, event.downloaded_bytes,
          event.total_bytes, event.status)


@pytest.mark.parametrize("layers", [(0, 1), (2, 3), (0, 3)], ids=["first", "last", "whole"])
async def test_shard_download_matches_jax(repos, sides, monkeypatch, layers):
  """Each side fetches one shard: the same files (the shard's weight files by the index,
  config, tokenizer, the nested notes), byte for byte, and the same final event."""
  with HFMirror(repos) as mirror:
    monkeypatch.setenv("HF_ENDPOINT", mirror.url)
    got = {}
    for side in sides:
      side.use()
      dl = side.downloader()
      path = await dl.ensure_shard(side.shard(CARD, *layers, 4), side.engine)
      assert path == side.home / "models" / "test--tiny-four"
      got[side.name] = (_listing(path), _final(side.events[-1]))
  assert got["port"] == got["jax"]
  files = set(got["port"][0])
  weights = {FIRST} if layers == (0, 1) else {SECOND} if layers == (2, 3) else {FIRST, SECOND}
  assert files == {"model.safetensors.index.json", "config.json", "tokenizer.json",
                   "extra/notes.txt"} | weights
  src = repos[REPO]
  assert all(got["port"][0][f] == (src / f).read_bytes() for f in files)
  # The index, fetched on its own first, is counted as a complete file.
  assert got["port"][1][1:3] == (len(files), len(files))
  assert got["port"][1][-1] == "complete"


async def test_no_index_repo_writes_its_manifest_first(repos, sides, monkeypatch):
  with HFMirror(repos) as mirror:
    monkeypatch.setenv("HF_ENDPOINT", mirror.url)
    manifests = {}
    for side in sides:
      side.use()
      shard = side.shard(FLAT_CARD, 0, 1, 2)
      path = await side.downloader().ensure_shard(shard, side.engine)
      manifests[side.name] = json.loads((path / hf.MANIFEST_NAME).read_text())
      assert side.module().checkpoint_complete(path, shard)
  assert manifests["port"] == manifests["jax"] == {
    "files": ["config.json", "model.safetensors", "tokenizer.json"]}


class _Resumable(MirrorHandler):
  """Answers a wrong sha256 for `bad` files; `bad` is the server's set."""

  def etag_headers(self, target, rel):
    headers = super().etag_headers(target, rel)
    if rel in self.server.mirror.bad:
      headers["X-Linked-ETag"] = '"' + "0" * 64 + '"'
    return headers


def _mirror(repos, bad=()):
  mirror = HFMirror(repos, handler=_Resumable)
  mirror.bad = set(bad)
  return mirror


@pytest.mark.parametrize("held", [1 << 20, None], ids=["resume-206", "whole-416"])
async def test_partial_resumes_with_a_range(repos, sides, monkeypatch, held):
  """A `.partial` of the first 1 MiB resumes with `Range: bytes=1048576-` and a 206
  appended; one that holds the whole file gets a 416, taken as complete."""
  src = repos[REPO] / FIRST
  size = src.stat().st_size
  held = size if held is None else held
  with _mirror(repos) as mirror:
    monkeypatch.setenv("HF_ENDPOINT", mirror.url)
    for side in sides:
      side.use()
      target = side.home / "models" / "test--tiny-four"
      target.mkdir(parents=True)
      (target / (FIRST + ".partial")).write_bytes(src.read_bytes()[:held])
      del mirror.log[:]
      await side.downloader().ensure_shard(side.shard(CARD, 0, 1, 4), side.engine)
      ranges = [h.get("range") for _, path, h in mirror.log if path.endswith("/" + FIRST)]
      assert ranges == [f"bytes={held}-"], side.name
      assert (target / FIRST).read_bytes() == src.read_bytes()
      assert not (target / (FIRST + ".partial")).exists()
      ev = side.events[-1].file_progress[FIRST]
      assert (ev.downloaded, ev.total, ev.status) == (size, size, "complete")


async def test_hash_mismatch_raises_and_deletes_the_partial(repos, sides, monkeypatch):
  with _mirror(repos, bad={SECOND}) as mirror:
    monkeypatch.setenv("HF_ENDPOINT", mirror.url)
    for side in sides:
      side.use()
      with pytest.raises(ValueError, match=f"Hash mismatch for {SECOND}"):
        await side.downloader().ensure_shard(side.shard(CARD, 2, 3, 4), side.engine)
      target = side.home / "models" / "test--tiny-four"
      assert not (target / (SECOND + ".partial")).exists() and not (target / SECOND).exists()
      assert (target / "config.json").exists()  # a good file's sha1 ETag checks out


class _Flaky(MirrorHandler):
  """The first two tree listings of each side answer 500."""

  def list_tree(self, repo, sub):
    mirror = self.server.mirror
    if mirror.failures > 0:
      mirror.failures -= 1
      return self._json(500, {"error": "busy"})
    super().list_tree(repo, sub)


async def test_file_list_is_retried_cached_and_authorized(repos, sides, monkeypatch):
  """Two failed listings, then the tree walk (recursively, into extra/), with HF_TOKEN's
  bearer on every request; the list is cached under XOT_HOME/file_lists, so a second
  download lists nothing."""
  monkeypatch.setenv("HF_TOKEN", "tok-27")
  with HFMirror(repos, handler=_Flaky) as mirror:
    monkeypatch.setenv("HF_ENDPOINT", mirror.url)
    cached = {}
    for side in sides:
      side.use()
      mirror.failures = 2
      del mirror.log[:]
      shard = side.shard(CARD, 0, 3, 4)
      await side.downloader().ensure_shard(shard, side.engine)
      trees = [p for _, p, _ in mirror.log if p.startswith("/api/models/")]
      assert trees == [f"/api/models/{REPO}/tree/main"] * 3 + [f"/api/models/{REPO}/tree/main/extra"]
      assert {h.get("authorization") for _, _, h in mirror.log} == {"Bearer tok-27"}
      cache = side.home / "file_lists" / "test--tiny-four--main.json"
      cached[side.name] = json.loads(cache.read_text())
      (side.home / "models" / "test--tiny-four" / SECOND).unlink()
      del mirror.log[:]
      await side.downloader().ensure_shard(shard, side.engine)
      assert [p for _, p, _ in mirror.log] == [f"/{REPO}/resolve/main/{SECOND}"]
  assert cached["port"] == cached["jax"]
  assert sorted(f["path"] for f in cached["port"]) == sorted(_listing(repos[REPO]))


async def test_delete_model_matches_jax(repos, sides, monkeypatch):
  with HFMirror(repos) as mirror:
    monkeypatch.setenv("HF_ENDPOINT", mirror.url)
    for side in sides:
      side.use()
      dl = side.downloader()
      await dl.ensure_shard(side.shard(CARD, 0, 3, 4), side.engine)
      assert await dl.delete_model(CARD, side.engine) is True
      assert not (side.home / "models" / "test--tiny-four").exists() and not dl.completed
      assert await dl.delete_model(CARD, side.engine) is False
      assert await dl.delete_model("no-such-card", side.engine) is False


def test_mirror_hashes_are_hfs():
  """The mirror's sha256 (an LFS file's) and git-blob sha1 (any other's), as sha256sum
  and `git hash-object` give them, on a seeded file."""
  import hashlib
  import tempfile
  from pathlib import Path
  data = _bytes(np.random.default_rng(5), 4097)
  with tempfile.TemporaryDirectory() as d:
    p = Path(d) / "f.bin"
    p.write_bytes(data)
    sha256, blob = file_hash(p, lfs=True), file_hash(p, lfs=False)
  assert sha256 == hashlib.sha256(data).hexdigest()
  assert blob == hashlib.sha1(b"blob 4097\0" + data).hexdigest()
