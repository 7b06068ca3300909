"""Binary wire codec: JSON header + raw tensor payload, bf16-native.

The port's copy of xotorch_tpu/networking/codec.py, the same XOT1 frame:

  magic 'XOT1' | u32 header_len | header JSON | tensor payload

The header carries the scalar fields and one descriptor per tensor (shape, dtype,
offset, nbytes); the tensors' bytes follow raw. numpy has no bfloat16 without
ml_dtypes, so a `torch.bfloat16` tensor (the engine's hidden-state hop output) goes
out as its raw 2-byte elements under dtype "bfloat16" and comes back as a
`torch.bfloat16` CPU tensor; every other dtype travels as numpy. A frame encoded by
the JAX package decodes here to the same bits, and the reverse.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

MAGIC = b"XOT1"

BF16 = "bfloat16"  # the one dtype numpy lacks that crosses the wire: a torch tensor here


def _raw(arr) -> Tuple[list, str, bytes]:
  """(shape, dtype name, bytes) of a numpy array or a CPU torch tensor."""
  if isinstance(arr, torch.Tensor):
    t = arr.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
      return list(t.shape), BF16, t.view(torch.int16).numpy().tobytes()
    arr = t.numpy()
  arr = np.ascontiguousarray(arr)
  return list(arr.shape), arr.dtype.name, arr.tobytes()


def encode_message(fields: Dict[str, Any], tensors: Optional[Dict[str, Any]] = None) -> bytes:
  descriptors = {}
  payload_parts = []
  offset = 0
  for name, arr in (tensors or {}).items():
    shape, dtype, raw = _raw(arr)
    descriptors[name] = {"shape": shape, "dtype": dtype, "offset": offset, "nbytes": len(raw)}
    payload_parts.append(raw)
    offset += len(raw)
  header = json.dumps({"fields": fields, "tensors": descriptors}).encode("utf-8")
  return MAGIC + struct.pack(">I", len(header)) + header + b"".join(payload_parts)


def decode_message(data: bytes) -> Tuple[Dict[str, Any], Dict[str, Any]]:
  """(fields, tensors). Raises ValueError on a frame that is not XOT1."""
  if data[:4] != MAGIC or len(data) < 8:
    raise ValueError("Bad frame magic")
  (header_len,) = struct.unpack(">I", data[4:8])
  try:
    header = json.loads(bytes(data[8:8 + header_len]).decode("utf-8"))
  except (UnicodeDecodeError, json.JSONDecodeError) as e:
    raise ValueError(f"Bad frame header: {e}") from None
  payload = memoryview(data)[8 + header_len:]
  tensors: Dict[str, Any] = {}
  for name, desc in header["tensors"].items():
    raw = payload[desc["offset"]:desc["offset"] + desc["nbytes"]]
    if len(raw) != desc["nbytes"]:
      raise ValueError(f"Truncated frame: tensor {name} has {len(raw)} of {desc['nbytes']} bytes")
    if desc["dtype"] != BF16:
      tensors[name] = np.frombuffer(raw, dtype=np.dtype(desc["dtype"])).reshape(desc["shape"])
    else:
      # A copy (np.array): torch.from_numpy warns on a read-only buffer, and the tensor
      # must not pin the whole frame.
      bits = np.array(np.frombuffer(raw, dtype=np.int16)).reshape(desc["shape"])
      tensors[name] = torch.from_numpy(bits).view(torch.bfloat16)
  return header["fields"], tensors
