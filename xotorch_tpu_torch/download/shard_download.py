"""ShardDownloader, and the local and no-op downloaders.

The port of xotorch_tpu/download/shard_download.py. An engine asks its downloader for
the local directory of a shard's checkpoint; the downloader is layer-aware, so each
peer needs only the files its layer range reads.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import AsyncIterator, Dict, Optional

from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.models.registry import split_adapter
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import AsyncCallbackSystem


class ShardDownloader(ABC):
  @abstractmethod
  async def ensure_shard(self, shard: Shard, inference_engine_name: str) -> Path:
    """Make the weight files for `shard` available locally, returning the model
    directory. Must dedupe concurrent calls for the same shard."""
    ...

  @property
  def on_progress(self) -> AsyncCallbackSystem:
    """The downloader's progress events, (shard, RepoProgressEvent) a callback; one that
    fetches nothing never fires them."""
    callbacks = self.__dict__.get("_on_progress")
    if callbacks is None:
      callbacks = self.__dict__["_on_progress"] = AsyncCallbackSystem()
    return callbacks

  async def get_shard_download_status(self, inference_engine_name: str) -> AsyncIterator[tuple]:
    """(model dir, RepoProgressEvent) of each finished download; none by default."""
    return
    yield  # an async generator that yields nothing


class LocalShardDownloader(ShardDownloader):
  """Serve model dirs already on disk (offline machines, tests): an explicit
  mapping passed to the constructor first, then `$XOT_MODEL_DIR/<model_id>` if it
  exists. An adapter id `base@name` that neither names resolves to its base's
  directory."""

  def __init__(self, mapping: Optional[Dict[str, Path]] = None) -> None:
    self.mapping = {k: Path(v) for k, v in (mapping or {}).items()}

  async def ensure_shard(self, shard: Shard, inference_engine_name: str) -> Path:
    for mid in (shard.model_id, split_adapter(shard.model_id)[0]):
      if mid in self.mapping:
        return self.mapping[mid]
      root = knobs.get_str("XOT_MODEL_DIR", None)
      if root and (Path(root) / mid).exists():
        return Path(root) / mid
    raise FileNotFoundError(f"No local model dir for {shard.model_id}")


class NoopShardDownloader(ShardDownloader):
  async def ensure_shard(self, shard: Shard, inference_engine_name: str) -> Path:
    return Path("/tmp/noop_shard")
