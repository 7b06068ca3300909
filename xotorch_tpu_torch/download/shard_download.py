"""ShardDownloader, and the local and no-op downloaders.

The port of xotorch_tpu/download/shard_download.py. An engine asks its downloader for
the local directory of a shard's checkpoint; the downloader is layer-aware, so each
peer needs only the files its layer range reads.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import Dict, Optional

from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.utils import knobs


class ShardDownloader(ABC):
  @abstractmethod
  async def ensure_shard(self, shard: Shard, inference_engine_name: str) -> Path:
    """Make the weight files for `shard` available locally, returning the model
    directory. Must dedupe concurrent calls for the same shard."""
    ...


class LocalShardDownloader(ShardDownloader):
  """Serve model dirs already on disk (offline machines, tests): an explicit
  mapping passed to the constructor first, then `$XOT_MODEL_DIR/<model_id>` if it
  exists."""

  def __init__(self, mapping: Optional[Dict[str, Path]] = None) -> None:
    self.mapping = {k: Path(v) for k, v in (mapping or {}).items()}

  async def ensure_shard(self, shard: Shard, inference_engine_name: str) -> Path:
    if shard.model_id in self.mapping:
      return self.mapping[shard.model_id]
    root = knobs.get_str("XOT_MODEL_DIR", None)
    if root and (Path(root) / shard.model_id).exists():
      return Path(root) / shard.model_id
    raise FileNotFoundError(f"No local model dir for {shard.model_id}")


class NoopShardDownloader(ShardDownloader):
  async def ensure_shard(self, shard: Shard, inference_engine_name: str) -> Path:
    return Path("/tmp/noop_shard")
