from xotorch_tpu_torch.parallel.collectives import all_gather, all_reduce, send_next
from xotorch_tpu_torch.parallel.mesh import (
  Mesh,
  MeshParams,
  cache_piece,
  cache_spec,
  device_bytes,
  local_devices,
  make_mesh,
  param_specs_like,
  shard_batch,
  shard_cache,
  shard_map,
  shard_params,
  spec_for_param,
)

__all__ = [
  "Mesh", "MeshParams", "make_mesh", "local_devices", "shard_params", "shard_batch",
  "shard_cache", "shard_map", "param_specs_like", "device_bytes", "spec_for_param",
  "cache_spec", "cache_piece", "all_reduce", "all_gather", "send_next",
]
