"""The HF shard downloader's offline half: XOT_HOME's model directories, the
layer-aware file filter, the on-disk completeness rule, seeding, and `ensure_shard`'s
fast path for a checkpoint already on disk.

The port of xotorch_tpu/download/hf_shard_download.py without the network fetch (the
HF tree listing, ranged downloads and hash checks over aiohttp, which the card does
not have). A model's files live in `XOT_HOME/models/<org>--<name>` (XOT_HOME defaults
to `~/.xot_tpu`); `--models-seed-dir` moves prepared directories there. A shard whose
checkpoint is not complete on disk raises, naming the directory to seed.
"""
from __future__ import annotations

import asyncio
import fnmatch
import json
import os
import re
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from xotorch_tpu_torch.download.shard_download import ShardDownloader
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.models.registry import get_repo
from xotorch_tpu_torch.models.vision import is_vision_tensor
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG, spawn_detached


def xot_home() -> Path:
  return Path(knobs.get_str("XOT_HOME", None) or (Path.home() / ".xot_tpu"))


def models_dir() -> Path:
  return xot_home() / "models"


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
  def __init__(self):
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
    raise FileNotFoundError(
      f"{shard.model_id}: the checkpoint of {repo_id} is not complete in {target_dir} "
      f"(config.json, a tokenizer file and the safetensors files of layers "
      f"{shard.start_layer}-{shard.end_layer}); fetching over the network is not ported "
      f"to xotorch_tpu_torch yet: seed that directory (--models-seed-dir)")

  @staticmethod
  def _local_complete(target_dir: Path, shard: Shard) -> bool:
    return checkpoint_complete(target_dir, shard)


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
