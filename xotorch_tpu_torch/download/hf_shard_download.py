"""The HF shard downloader: layer-filtered, resumable, hash-checked.

The port of xotorch_tpu/download/hf_shard_download.py on the standard library: the HF
tree API and `resolve/main` fetched with urllib in worker threads, where JAX uses
aiohttp. A model's files live in `XOT_HOME/models/<org>--<name>` (XOT_HOME defaults
to `~/.xot_tpu`); `--models-seed-dir` moves prepared directories there. `ensure_shard`
serves a checkpoint already complete on disk without touching the network; otherwise
it lists the repo (recursively, three attempts, cached under `XOT_HOME/file_lists`),
keeps the files the shard's layer range needs (through the safetensors index), and
fetches them at most `max_parallel_downloads` at a time. A fetch resumes a `.partial`
with `Range: bytes=N-` (206 appends, 200 rewrites, 416 is complete) and checks an
`X-Linked-ETag`/`ETag` of 40 hex digits as a git-blob sha1 and of 64 as a sha256; a
mismatch deletes the partial and raises. `HF_ENDPOINT` and `HF_TOKEN` (or the token
file under `HF_HOME`) work as in JAX. The opener ignores proxy settings, as aiohttp's
default does, so an endpoint on loopback is reached directly. Progress events go to
`on_progress` on the event loop's thread.
"""
from __future__ import annotations

import asyncio
import fnmatch
import hashlib
import json
import os
import re
import shutil
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import AsyncIterator, Dict, List, Optional, Tuple

from xotorch_tpu_torch.download.download_progress import RepoFileProgressEvent, RepoProgressEvent
from xotorch_tpu_torch.download.shard_download import ShardDownloader
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.models.registry import get_repo
from xotorch_tpu_torch.models.vision import is_vision_tensor
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG, spawn_detached

_CHUNK = 1024 * 1024
_TIMEOUT_S = 60.0  # a socket operation's (connect, a read); JAX's connect timeout is 30 s
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def xot_home() -> Path:
  return Path(knobs.get_str("XOT_HOME", None) or (Path.home() / ".xot_tpu"))


def models_dir() -> Path:
  return xot_home() / "models"


def hf_endpoint() -> str:
  return os.getenv("HF_ENDPOINT", "https://huggingface.co")


def _auth_headers() -> Dict[str, str]:
  token = os.getenv("HF_TOKEN")
  if not token:
    token_file = Path(os.getenv("HF_HOME", Path.home() / ".cache/huggingface")) / "token"
    if token_file.exists():
      token = token_file.read_text().strip()
  return {"Authorization": f"Bearer {token}"} if token else {}


def _open(url: str, headers: Optional[Dict[str, str]] = None):
  """One GET (blocking: a worker thread's). An HTTP error status raises
  urllib.error.HTTPError, as aiohttp's raise_for_status does."""
  return _OPENER.open(urllib.request.Request(url, headers={**_auth_headers(), **(headers or {})}),
                      timeout=_TIMEOUT_S)


async def fetch_file_list(repo_id: str, revision: str = "main", path: str = "") -> List[Dict]:
  """The repo's files ({"path", "size"}), walked recursively through the HF tree API
  with three attempts, cached in XOT_HOME/file_lists."""
  cache_file = xot_home() / "file_lists" / f"{repo_id.replace('/', '--')}--{revision}.json"
  if cache_file.exists():
    try:
      return json.loads(cache_file.read_text())
    except json.JSONDecodeError:
      pass
  url = f"{hf_endpoint()}/api/models/{repo_id}/tree/{revision}"

  def walk(subpath: str, files: List[Dict]) -> None:
    with _open(f"{url}/{subpath}" if subpath else url) as resp:
      entries = json.loads(resp.read())
    for entry in entries:
      if entry["type"] == "file":
        files.append({"path": entry["path"], "size": entry["size"]})
      elif entry["type"] == "directory":
        walk(entry["path"], files)

  for attempt in range(3):
    files: List[Dict] = []
    try:
      await asyncio.to_thread(walk, path, files)
      break
    except (OSError, ValueError, KeyError):  # urllib's errors are OSErrors
      if attempt == 2:
        raise
      await asyncio.sleep(1.5 ** attempt)
  cache_file.parent.mkdir(parents=True, exist_ok=True)
  cache_file.write_text(json.dumps(files))
  return files


def get_allow_patterns(weight_map: Dict[str, str], shard: Shard) -> List[str]:
  """Files a layer range needs: its layers' weight files, config and tokenizer files
  always, the embedding's file on the first shard and the head's on the last. A llava
  checkpoint's vision tower and projector go with the first shard whatever its layer
  range (their encoder.layers.N are not text layers), as the loader reads them there
  (models/weights.tensor_names_for_shard)."""
  default = ["*.json", "*.py", "tokenizer.model", "*.tiktoken", "*.txt", "*.jinja"]
  shard_files = set()
  for tensor_name, file_name in weight_map.items():
    if is_vision_tensor(tensor_name):
      if shard.is_first_layer:
        shard_files.add(file_name)
      continue
    m = re.search(r"(?:^|\.)layers\.(\d+)\.", tensor_name)
    if m is not None:
      if shard.start_layer <= int(m.group(1)) <= shard.end_layer:
        shard_files.add(file_name)
      continue
    is_embed = "embed" in tensor_name
    is_tail = "lm_head" in tensor_name or re.search(r"(?:^|\.)norm\.weight", tensor_name)
    if is_embed and shard.is_first_layer:
      shard_files.add(file_name)
    elif is_tail and shard.is_last_layer:
      shard_files.add(file_name)
    elif not (is_embed or is_tail):
      if shard.is_first_layer:
        shard_files.add(file_name)
  return default + sorted(shard_files)


def _matches(path: str, patterns: List[str]) -> bool:
  return any(fnmatch.fnmatch(path, p) or fnmatch.fnmatch(os.path.basename(path), p) for p in patterns)


class HFShardDownloader(ShardDownloader):
  def __init__(self, max_parallel_downloads: int = 8):
    self.max_parallel_downloads = max_parallel_downloads
    self.active_downloads: Dict[Tuple[str, str], asyncio.Task] = {}
    self.completed: Dict[Tuple[str, str], Path] = {}

  async def ensure_shard(self, shard: Shard, inference_engine_name: str) -> Path:
    """The shard's model dir; concurrent calls for one shard share one task, and a
    finished one is remembered."""
    key = (shard.model_id, f"{shard.start_layer}-{shard.end_layer}")
    if key in self.completed:
      return self.completed[key]
    if key in self.active_downloads:
      return await asyncio.shield(self.active_downloads[key])
    task = spawn_detached(self._download_shard(shard, inference_engine_name))
    self.active_downloads[key] = task
    try:
      path = await asyncio.shield(task)
      self.completed[key] = path
      return path
    finally:
      self.active_downloads.pop(key, None)

  async def _download_shard(self, shard: Shard, inference_engine_name: str) -> Path:
    repo_id = get_repo(shard.model_id, inference_engine_name)
    if repo_id is None or repo_id in ("synthetic", "dummy"):
      raise ValueError(f"No repo for {shard.model_id} under {inference_engine_name}")
    target_dir = models_dir() / repo_id.replace("/", "--")
    target_dir.mkdir(parents=True, exist_ok=True)
    if self._local_complete(target_dir, shard):
      if DEBUG >= 2:
        print(f"Local checkpoint complete for {shard}; skipping download")
      return target_dir
    file_list = await fetch_file_list(repo_id)
    weight_map = await self._weight_map(repo_id, target_dir, file_list)
    patterns = get_allow_patterns(weight_map, shard) if weight_map else ["*"]
    wanted = [f for f in file_list if _matches(f["path"], patterns)]
    if not weight_map:
      # A repo without an index: the whole intended file set is recorded before any
      # fetch, so a download killed between files never passes as complete.
      write_download_manifest(target_dir, [f["path"] for f in wanted])
    if DEBUG >= 2:
      print(f"Downloading {len(wanted)}/{len(file_list)} files for {shard}")
    semaphore = asyncio.Semaphore(self.max_parallel_downloads)
    progress: Dict[str, RepoFileProgressEvent] = {}
    started = time.monotonic()

    async def fetch(f):
      async with semaphore:
        await self._download_file(repo_id, f["path"], f["size"], target_dir, progress, shard, started)

    await asyncio.gather(*(fetch(f) for f in wanted))
    return target_dir

  @staticmethod
  def _local_complete(target_dir: Path, shard: Shard) -> bool:
    return checkpoint_complete(target_dir, shard)

  async def _weight_map(self, repo_id: str, target_dir: Path,
                        file_list: List[Dict]) -> Optional[Dict[str, str]]:
    index_name = "model.safetensors.index.json"
    if not any(f["path"] == index_name for f in file_list):
      return None
    index_path = target_dir / index_name
    if not index_path.exists():
      def fetch() -> bytes:
        with _open(f"{hf_endpoint()}/{repo_id}/resolve/main/{index_name}") as resp:
          return resp.read()
      index_path.write_bytes(await asyncio.to_thread(fetch))
    try:
      return json.loads(index_path.read_text()).get("weight_map", {})
    except json.JSONDecodeError:
      return None

  async def _download_file(self, repo_id: str, file_path: str, total: int, target_dir: Path,
                           progress: Dict, shard: Shard, started: float) -> None:
    """One file, resumed from its `.partial` and hash-checked, in a worker thread that
    reports its progress to the loop's thread."""
    out_path = target_dir / file_path
    out_path.parent.mkdir(parents=True, exist_ok=True)
    loop = asyncio.get_running_loop()

    def report(downloaded: int, speed: float, status: str) -> None:
      progress[file_path] = RepoFileProgressEvent(repo_id, file_path, downloaded, total, speed, status)
      self._emit(repo_id, progress, shard, started)

    if out_path.exists() and out_path.stat().st_size == total:
      report(total, 0, "complete")
      return
    partial_path = out_path.with_suffix(out_path.suffix + ".partial")

    def fetch() -> None:
      downloaded = partial_path.stat().st_size if partial_path.exists() else 0
      headers = {"Range": f"bytes={downloaded}-"} if downloaded else {}
      t0 = time.monotonic()
      try:
        resp = _open(f"{hf_endpoint()}/{repo_id}/resolve/main/{file_path}", headers)
      except urllib.error.HTTPError as e:
        if e.code != 416:  # 416: the partial already holds the whole file
          raise
        e.close()
        return
      with resp:
        etag = (resp.headers.get("X-Linked-ETag") or resp.headers.get("ETag") or "").strip('"')
        mode = "ab" if downloaded and resp.status == 206 else "wb"
        if mode == "wb":
          downloaded = 0
        with open(partial_path, mode) as f:
          for chunk in iter(lambda: resp.read(_CHUNK), b""):
            f.write(chunk)
            downloaded += len(chunk)
            speed = downloaded / max(time.monotonic() - t0, 1e-9)
            loop.call_soon_threadsafe(report, downloaded, speed, "in_progress")
      if etag and len(etag) in (40, 64) and all(c in "0123456789abcdef" for c in etag.lower()):
        h = hashlib.sha1() if len(etag) == 40 else hashlib.sha256()
        if len(etag) == 40:  # a git blob's sha1
          h.update(f"blob {partial_path.stat().st_size}\0".encode())
        with open(partial_path, "rb") as f:
          for block in iter(lambda: f.read(_CHUNK), b""):
            h.update(block)
        if h.hexdigest() != etag:
          partial_path.unlink(missing_ok=True)
          raise ValueError(f"Hash mismatch for {file_path}: {h.hexdigest()} != {etag}")

    await asyncio.to_thread(fetch)
    if partial_path.exists():
      partial_path.rename(out_path)
    report(total, 0, "complete")

  def _emit(self, repo_id: str, progress: Dict, shard: Shard, started: float) -> None:
    files = list(progress.values())
    downloaded = sum(f.downloaded for f in files)
    total = sum(f.total for f in files)
    completed = sum(1 for f in files if f.status == "complete")
    elapsed = max(time.monotonic() - started, 1e-9)
    event = RepoProgressEvent(
      repo_id, completed, len(files), downloaded, total, downloaded / elapsed,
      "complete" if completed == len(files) else "in_progress",
      {f.file_path: f for f in files},
    )
    self.on_progress.trigger_all(shard, event)

  async def get_shard_download_status(self, inference_engine_name: str) -> AsyncIterator[tuple]:
    for (model_id, _layers), path in self.completed.items():
      yield (path, RepoProgressEvent(model_id, 1, 1, 0, 0, 0, "complete"))

  async def delete_model(self, model_id: str, inference_engine_name: str) -> bool:
    """Remove the card's model dir (True), or False when there is none."""
    repo_id = get_repo(model_id, inference_engine_name)
    if repo_id is None:
      return False
    target = models_dir() / repo_id.replace("/", "--")
    if target.exists():
      shutil.rmtree(target)
      self.completed = {k: v for k, v in self.completed.items() if k[0] != model_id}
      return True
    return False


# Completion manifest for repos without a safetensors index: the downloader writes it
# before it fetches, listing every file it means to fetch, so a download killed
# between files never passes as complete. Seeded or hand-made dirs have none.
MANIFEST_NAME = ".xot_download_manifest.json"


def write_download_manifest(target_dir: Path, file_paths: List[str]) -> None:
  try:
    (target_dir / MANIFEST_NAME).write_text(json.dumps({"files": sorted(file_paths)}))
  except OSError:
    pass  # best effort: a read-only dir keeps the network-verify path


def has_tokenizer_artifact(target_dir: Path) -> bool:
  """A file a tokenizer can be built from (tokenizer_config.json alone is not one)."""
  return any((target_dir / t).exists()
             for t in ("tokenizer.json", "tokenizer.model", "vocab.json", "spiece.model"))


def _find_index(target_dir: Path) -> Optional[Path]:
  """The safetensors index, top-level or one subdir down."""
  top = target_dir / "model.safetensors.index.json"
  if top.exists():
    return top
  return next(target_dir.glob("*/model.safetensors.index.json"), None)


def checkpoint_complete(target_dir: Path, shard: Optional[Shard] = None) -> bool:
  """The on-disk completeness rule of the offline fast path (shard-filtered) and of
  the model status (whole repo, shard=None): config.json, a tokenizer artifact, and
  every weight file the index names (filtered to the shard's files when a shard is
  given); without an index, every file the download manifest names when there is
  one, else at least one .safetensors file and no .partial leftovers."""
  if not (target_dir / "config.json").exists():
    return False
  if not has_tokenizer_artifact(target_dir):
    return False
  index = _find_index(target_dir)
  if index is not None:
    try:
      weight_map = json.loads(index.read_text()).get("weight_map", {})
    except (OSError, json.JSONDecodeError):
      return False
    if not weight_map:
      return False
    files = set(weight_map.values())
    if shard is not None:
      patterns = get_allow_patterns(weight_map, shard)
      files = {f for f in files if _matches(f, patterns)}
    base = index.parent
    return bool(files) and all((base / f).exists() for f in files)
  if any(target_dir.rglob("*.partial")):
    return False
  manifest = target_dir / MANIFEST_NAME
  if manifest.exists():
    try:
      files = json.loads(manifest.read_text()).get("files", [])
    except (OSError, json.JSONDecodeError):
      return False
    return bool(files) and all((target_dir / f).exists() for f in files)
  return any(p.suffix == ".safetensors" for p in target_dir.iterdir() if p.is_file())


def local_model_status(model_id: str, inference_engine_name: str) -> Dict:
  """A registry model's download status from a scan of the disk alone: synthetic
  cards report downloaded with zero bytes."""
  repo_id = get_repo(model_id, inference_engine_name)
  if repo_id is None:
    return {"downloaded": False, "download_percentage": None,
            "total_size": None, "total_downloaded": 0}
  if repo_id in ("synthetic", "dummy"):
    return {"downloaded": True, "download_percentage": 100,
            "total_size": 0, "total_downloaded": 0}
  target = models_dir() / repo_id.replace("/", "--")
  if not target.exists():
    return {"downloaded": False, "download_percentage": None,
            "total_size": None, "total_downloaded": 0, "repo": repo_id}
  total = sum(p.stat().st_size for p in target.rglob("*") if p.is_file())
  downloaded = checkpoint_complete(target)
  return {
    "downloaded": downloaded,
    "download_percentage": 100 if downloaded else None,
    "total_size": total if downloaded else None,
    "total_downloaded": total,
    "repo": repo_id,
  }


async def seed_models(seed_dir: str) -> None:
  """Move pre-seeded model dirs into XOT_HOME/models (an existing one is kept)."""
  source = Path(seed_dir)
  if not source.exists():
    return
  models_dir().mkdir(parents=True, exist_ok=True)
  for entry in source.iterdir():
    if entry.is_dir():
      dest = models_dir() / entry.name
      if not dest.exists():
        shutil.move(str(entry), str(dest))
