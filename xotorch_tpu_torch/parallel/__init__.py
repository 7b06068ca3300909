from xotorch_tpu_torch.parallel.collectives import all_gather, all_reduce, reduce_scatter, send_next
from xotorch_tpu_torch.parallel.mesh import (
  Mesh,
  MeshParams,
  cache_piece,
  cache_spec,
  device_bytes,
  gather_params,
  local_devices,
  make_mesh,
  param_specs_like,
  shard_batch,
  shard_cache,
  shard_map,
  shard_params,
  spec_for_param,
)
from xotorch_tpu_torch.parallel.zero import (
  MeshAdamW,
  moment_bytes_per_device,
  zero1_constraint,
  zero1_shard_opt_state,
  zero1_spec,
)

__all__ = [
  "Mesh", "MeshParams", "make_mesh", "local_devices", "shard_params", "shard_batch",
  "shard_cache", "shard_map", "param_specs_like", "device_bytes", "spec_for_param",
  "cache_spec", "cache_piece", "gather_params", "all_reduce", "all_gather", "reduce_scatter",
  "send_next", "zero1_spec", "zero1_shard_opt_state", "zero1_constraint",
  "moment_bytes_per_device", "MeshAdamW",
]
