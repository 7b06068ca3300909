"""Registry of the `XOT_*` environment knobs the port reads.

The port's own copy of xotorch_tpu/utils/knobs.py: the same accessors (`raw`,
`get_str`, `get_int`, `get_float`, `get_bool`) with the same names and defaults, over
only the knobs this package reads. A name missing here raises `UnknownKnobError` at
the read site instead of silently returning a default.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


class UnknownKnobError(KeyError):
  """An env read referenced an `XOT_*` name that is not registered."""


@dataclass(frozen=True)
class Knob:
  name: str
  kind: str  # "int" | "float" | "bool" | "str" | "path"
  default: Optional[str]  # env-string form; None = unset
  doc: str


_DEFS: Tuple[Knob, ...] = (
  Knob("XOT_DTYPE", "str", "bfloat16", "Model compute/weight dtype."),
  Knob("XOT_CACHE_LEN", "int", "2048", "Initial per-request KV-cache length (tokens); grows geometrically when exceeded."),
  Knob("XOT_MAX_CACHE_LEN", "int", "32768", "Hard ceiling for per-request KV-cache growth (tokens)."),
  Knob("XOT_PREFILL_CHUNK", "int", "4096", "Prefill chunk length (tokens): prompts longer than this prefill in chunks."),
  Knob("XOT_SCAN_PREFILL", "bool", "1", "Use the lax.scan prefill over equal chunks (one compile for any chunk count)."),
  Knob("XOT_DECODE_CHUNK", "int", "8", "Tokens per fused decode dispatch on a single-partition ring; 1 = per-token ring."),
  Knob("XOT_DECODE_CHUNK_MAX", "int", "64", "Adaptive fused-decode chunk ceiling (doubles per dispatch up to this)."),
  Knob("XOT_FLASH_BLOCK_Q", "int", "128", "K1's query rows a block (positions x query heads of one kv head): 64 or 128. At head_dim 256 K1 takes 64 whatever this says."),
  Knob("XOT_FLASH_BLOCK_K", "int", "128", "K1's keys a shared-memory tile: 64 or 128. At head_dim 256 K1 takes 64 whatever this says."),
  Knob("XOT_FD_BLOCK_Q", "int", "128", "K2/K2q's query rows a block on segments at T > 1 (positions x query heads of one kv head): 64 or 128. At head_dim 256 K2/K2q take 64 whatever this says."),
  Knob("XOT_FD_BLOCK_K", "int", "256", "The most keys one K2/K2q decode split reads (a CUDA block of split-K flash-decoding): a positive multiple of 64."),
  Knob("XOT_MAX_RESIDENT_REQUESTS", "int", "8", "Max request states resident per shard context before LRU eviction."),
  Knob("XOT_DECODE_BATCH", "int", "8", "Max concurrent requests fused into one batched decode dispatch."),
  Knob("XOT_BATCH_WINDOW_MS", "float", "0", "Batching window (ms) the decode batcher waits to coalesce submitters; 0 = one event-loop tick."),
  Knob("XOT_PAGED_KV", "bool", "0", "Serve decode from the shared paged KV pool instead of contiguous per-request caches."),
  Knob("XOT_KV_PAGE", "int", "128", "Page size (tokens) of the paged KV pool: 16 or 128 (the paged kernels' builds)."),
  Knob("XOT_KV_POOL_TOKENS", "int", "0", "Total paged-pool capacity in tokens; 0 sizes it automatically."),
  Knob("XOT_PAGED_PREFILL", "bool", "1", "Prefill straight into pool pages under XOT_PAGED_KV (no contiguous commit copy)."),
  Knob("XOT_RAGGED_PREFILL", "bool", "1", "Paged T>1 segments read pages natively through K4 (K4q). Reserved: `0` (the JAX package's gathered view) is not ported and the engine raises."),
  Knob("XOT_KV_DEFRAG", "bool", "1", "Page-pool defragmentation in batcher-idle slots: migrate high pages into low free holes and rewrite only the virtual maps."),
  Knob("XOT_KV_DEFRAG_MAX_MOVES", "int", "8", "Max page migrations per idle defrag pass."),
  Knob("XOT_QUANTIZE", "str", None, "Weight quantization mode (`int8` or `int4`); unset serves full precision."),
  Knob("XOT_KV_QUANT", "str", None, "KV-cache quantization mode (`int8`); unset keeps KV in compute dtype."),
  Knob("XOT_INT4_KERNEL", "str", "1", "int4 decode GEMV kernel (K5/K5v4): always taken on the card; `force` takes its function on the CPU too (plain version); `0` is reserved for a tensor-parallel mesh (not ported) and acts as `1`."),
  Knob("XOT_INT4_V", "int", "1", "int4 kernel variant: 1-3 the exact W4A16 kernel (K5), 4 the W4A8 kernel (K5v4)."),
  Knob("XOT_INT8_KERNEL", "str", "0", "W8A8 decode GEMV kernel (K6): `1` on the card, `0` off, `force` its function on the CPU too (plain version)."),
  Knob("XOT_HOP_RETRIES", "int", "2", "Retries per ring hop on transient transport failures; 0 = fail-fast."),
  Knob("XOT_HOP_BACKOFF_S", "float", "0.05", "Base backoff (s) for hop retries (exponential + jitter)."),
  Knob("XOT_MAX_SEQ_LEN", "int", None, "Override the model's maximum sequence length (RoPE/table sizing)."),
  Knob("XOT_HOME", "path", None, "Root directory for downloads and state; unset uses `~/.xot_tpu`."),
  Knob("XOT_MODEL_DIR", "path", None, "Local directory of model checkpoints (offline serving)."),
  Knob("XOT_PROBE_TIMEOUT", "float", "120", "Timeout (s) for the device-capability probe; past it a node reports its host's capabilities."),
)

REGISTRY: Dict[str, Knob] = {k.name: k for k in _DEFS}

_UNSET = object()
_FALSE_STRINGS = frozenset(("", "0", "false", "no", "off"))


def _lookup(name: str) -> Knob:
  try:
    return REGISTRY[name]
  except KeyError:
    raise UnknownKnobError(
      f"{name} is not a registered knob — add it to xotorch_tpu_torch/utils/knobs.py"
    ) from None


def raw(name: str, default=_UNSET) -> Optional[str]:
  """The env value as a string, or the registered default. A set-but-empty value is
  returned verbatim; the numeric accessors map it to the default."""
  knob = _lookup(name)
  value = os.environ.get(name)
  if value is None:
    return knob.default if default is _UNSET else default
  return value


def get_str(name: str, default=_UNSET) -> Optional[str]:
  return raw(name, default)


def _numeric(name: str, default, cast):
  value = raw(name, default)
  if isinstance(value, str) and value.strip() == "":
    knob = _lookup(name)
    value = knob.default if default is _UNSET else default
  if value is None:
    if default is not _UNSET:
      return None
    raise RuntimeError(f"knob {name} has no default and is not set in the environment")
  return cast(value)


def get_int(name: str, default=_UNSET) -> Optional[int]:
  return _numeric(name, default, int)


def get_float(name: str, default=_UNSET) -> Optional[float]:
  return _numeric(name, default, float)


def get_bool(name: str, default=_UNSET) -> Optional[bool]:
  """"0"/"false"/"no"/"off" (any case) and set-but-empty are False; any other set
  value is True."""
  value = raw(name, default)
  if value is None:
    if default is not _UNSET:
      return None
    raise RuntimeError(f"knob {name} has no default and is not set in the environment")
  if isinstance(value, bool):
    return value
  return str(value).strip().lower() not in _FALSE_STRINGS
