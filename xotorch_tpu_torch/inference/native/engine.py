"""NativeSidecarInferenceEngine: a client of the repo's C++ sidecar.

The port's copy of xotorch_tpu/inference/native/engine.py. The transformer's forward
runs in a native process (native/sidecar/, built by `make -C native` into
native/build/xot-sidecar, or the binary XOT_SIDECAR_BIN names), which this engine
spawns and reaches over a Unix socket. A message is length-prefixed (a 4-byte
big-endian header length), a JSON header, then the raw tensor: token ids as int32,
hidden states as bf16 both ways (widened to fp32 here as uint16 << 16), the last
shard's logits as fp32. The sidecar keeps each request's KV cache (a session a request
id), so the wire carries only the new tokens; XOT_SIDECAR_QUANT=int8 (read by the
sidecar, which this process's environment reaches) quantizes its linear layers when it
loads them. Sampling runs on the host, over the logits the sidecar returns.

The binary is a file beside the package, not a module of the JAX package: both
packages' engines may start it.
"""
from __future__ import annotations

import asyncio
import json
import os
import struct
import subprocess
import tempfile
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from xotorch_tpu_torch.download.shard_download import NoopShardDownloader, ShardDownloader
from xotorch_tpu_torch.inference.engine import InferenceEngine
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.tokenizers import tokenizer_for_dir
from xotorch_tpu_torch.ops.sampling import DEFAULT_TEMP, DEFAULT_TOP_K
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG

_REPO_ROOT = Path(__file__).resolve().parents[3]
_DEFAULT_BINARY = _REPO_ROOT / "native" / "build" / "xot-sidecar"
_SPAWN_TIMEOUT_S = 15.0


def ensure_sidecar_binary() -> Path:
  """The sidecar binary: XOT_SIDECAR_BIN's, else native/build/xot-sidecar, built with
  `make -C native` when it is missing (a failed build raises CalledProcessError)."""
  env = knobs.get_str("XOT_SIDECAR_BIN", None)
  if env:
    p = Path(env)
    if not p.exists():
      raise FileNotFoundError(f"XOT_SIDECAR_BIN={env} does not exist")
    return p
  if _DEFAULT_BINARY.exists():
    return _DEFAULT_BINARY
  native_dir = _REPO_ROOT / "native"
  if (native_dir / "Makefile").exists():
    subprocess.run(["make", "-C", str(native_dir)], check=True, capture_output=True)
    if _DEFAULT_BINARY.exists():
      return _DEFAULT_BINARY
  raise FileNotFoundError(
    f"sidecar binary not found at {_DEFAULT_BINARY}; run `make -C native` or set XOT_SIDECAR_BIN")


def decode_payload(meta: dict, payload: bytes) -> np.ndarray:
  shape = tuple(meta["shape"])
  dtype = meta["dtype"]
  if dtype == "float32":
    return np.frombuffer(payload, dtype=np.float32).reshape(shape).copy()
  if dtype == "bfloat16":
    u16 = np.frombuffer(payload, dtype=np.uint16).astype(np.uint32)
    return (u16 << 16).view(np.float32).reshape(shape).copy()
  if dtype == "int32":
    return np.frombuffer(payload, dtype=np.int32).reshape(shape).copy()
  raise ValueError(f"unsupported wire dtype {dtype}")


def encode_input(arr: np.ndarray) -> Tuple[dict, bytes]:
  """(header meta, payload) of an input: 2-D token ids as int32, a 3-D hidden state as
  bf16 rounded to nearest even."""
  if arr.ndim == 2:
    payload = arr.astype(np.int32).tobytes()
    return {"shape": list(arr.shape), "dtype": "int32", "nbytes": len(payload)}, payload
  if arr.ndim == 3:
    f32 = np.ascontiguousarray(arr, dtype=np.float32).view(np.uint32)
    payload = ((f32 + 0x7FFF + ((f32 >> 16) & 1)) >> 16).astype(np.uint16).tobytes()
    return {"shape": list(arr.shape), "dtype": "bfloat16", "nbytes": len(payload)}, payload
  raise ValueError(f"infer_tensor expects 2-D tokens or 3-D hidden state, got ndim={arr.ndim}")


class SidecarClient:
  """One connection to a sidecar process; it owns the process when it spawned it."""

  def __init__(self, socket_path: str, proc: Optional[subprocess.Popen] = None):
    self.socket_path = socket_path
    self.proc = proc
    self._reader: Optional[asyncio.StreamReader] = None
    self._writer: Optional[asyncio.StreamWriter] = None
    self._lock = asyncio.Lock()

  @classmethod
  async def spawn(cls, threads: Optional[int] = None) -> "SidecarClient":
    binary = await asyncio.to_thread(ensure_sidecar_binary)
    socket_path = os.path.join(tempfile.gettempdir(),
                               f"xot_sidecar_{os.getpid()}_{uuid.uuid4().hex[:8]}.sock")
    cmd = [str(binary), "--socket", socket_path]
    if threads:
      cmd += ["--threads", str(threads)]
    proc = subprocess.Popen(cmd, stderr=subprocess.DEVNULL if DEBUG < 2 else None)
    client = cls(socket_path, proc)
    deadline = time.monotonic() + _SPAWN_TIMEOUT_S
    while time.monotonic() < deadline:
      if proc.poll() is not None:
        raise RuntimeError(f"sidecar exited early with code {proc.returncode}")
      if os.path.exists(socket_path):
        try:
          await client.connect()
          await client.request({"cmd": "ping"})
          return client
        except (ConnectionError, OSError):
          await client.close_connection()
      await asyncio.sleep(0.05)
    proc.kill()
    proc.wait()
    raise TimeoutError(f"sidecar did not come up on {socket_path}")

  async def connect(self) -> None:
    self._reader, self._writer = await asyncio.open_unix_connection(self.socket_path)

  async def close_connection(self) -> None:
    if self._writer is not None:
      self._writer.close()
      try:
        await self._writer.wait_closed()
      except (ConnectionError, OSError):
        pass
    self._reader = self._writer = None

  async def request(self, header: dict, payload: bytes = b"") -> Tuple[dict, bytes]:
    """One exchange: the header's length, the JSON header, the raw payload; the answer
    in the same framing (its payload's length is output.nbytes)."""
    async with self._lock:
      if self._writer is None:
        await self.connect()
      raw = json.dumps(header).encode("utf-8")
      self._writer.write(struct.pack("!I", len(raw)) + raw + payload)
      await self._writer.drain()
      (resp_len,) = struct.unpack("!I", await self._reader.readexactly(4))
      resp = json.loads(await self._reader.readexactly(resp_len))
      nbytes = int(resp.get("output", {}).get("nbytes", 0))
      body = await self._reader.readexactly(nbytes) if nbytes else b""
      if resp.get("status") != "ok":
        raise RuntimeError(f"sidecar error: {resp.get('error', resp)}")
      return resp, body

  async def shutdown(self) -> None:
    try:
      await self.request({"cmd": "quit"})
    except (ConnectionError, OSError, RuntimeError, asyncio.IncompleteReadError):
      pass  # already gone
    await self.close_connection()
    if self.proc is not None:
      try:
        await asyncio.to_thread(self.proc.wait, 5)
      except subprocess.TimeoutExpired:
        self.proc.kill()
        self.proc.wait()
      self.proc = None


class NativeSidecarInferenceEngine(InferenceEngine):
  """`threads` is the sidecar's compute threads, 1 by default (JAX's engine leaves the
  sidecar its default, every core): the sidecar's ThreadPool::parallel_for
  (native/sidecar/model.hpp) returns once its counter reaches 0, while the worker that
  took it there may still lock the mutex and signal the condition variable that lived on
  the returned call's stack, and under load the sidecar then dies mid-request. With one
  thread parallel_for runs inline and never touches them."""

  def __init__(self, shard_downloader: Optional[ShardDownloader] = None, threads: Optional[int] = 1):
    self.shard_downloader = shard_downloader or NoopShardDownloader()
    self.session: Dict[str, Any] = {}
    self.shard: Optional[Shard] = None
    self.tokenizer = None
    self.client: Optional[SidecarClient] = None
    self._threads = threads
    self._cache_len = knobs.get_int("XOT_CACHE_LEN")
    self._shard_lock = asyncio.Lock()
    self._rng = np.random.default_rng(knobs.get_int("XOT_SEED", int(time.time())))
    self._model_dir: Optional[Path] = None
    self._is_last = False

  # ------------------------------------------------------------- tokenizing

  async def encode(self, shard: Shard, prompt: str) -> np.ndarray:
    await self.ensure_shard(shard)
    return np.asarray((await self._ensure_tokenizer()).encode(prompt), dtype=np.int64)

  async def decode(self, shard: Shard, tokens: np.ndarray) -> str:
    await self.ensure_shard(shard)
    return (await self._ensure_tokenizer()).decode(np.asarray(tokens).reshape(-1).tolist())

  async def _ensure_tokenizer(self):
    if self.tokenizer is None:
      self.tokenizer = await tokenizer_for_dir(self._model_dir)
    return self.tokenizer

  # --------------------------------------------------------------- sampling

  async def sample(self, x: np.ndarray, temp: float = DEFAULT_TEMP, top_k: int = DEFAULT_TOP_K,
                   top_p: float = 0.0) -> np.ndarray:
    """Host sampling of the last position's logits: argmax at temperature 0, else top-k,
    then top-p, then a Gumbel-max draw from the engine's generator (XOT_SEED)."""
    logits = np.asarray(x, dtype=np.float32)
    if logits.ndim == 3:
      logits = logits[:, -1, :]
    elif logits.ndim == 1:
      logits = logits[None, :]
    if temp <= 0.0:
      return np.argmax(logits, axis=-1).astype(np.int64)
    scaled = logits / max(temp, 1e-6)
    if top_k and 0 < top_k < scaled.shape[-1]:
      kth = np.partition(scaled, -top_k, axis=-1)[:, -top_k][:, None]
      scaled = np.where(scaled < kth, -np.inf, scaled)
    if top_p and 0.0 < top_p < 1.0:
      # The smallest prefix by probability whose mass reaches top_p (one token at least).
      sorted_desc = np.sort(scaled, axis=-1)[:, ::-1]
      exp = np.exp(sorted_desc - sorted_desc[:, :1])
      cumulative = np.cumsum(exp / exp.sum(axis=-1, keepdims=True), axis=-1)
      cutoff_idx = np.sum(cumulative < top_p, axis=-1, keepdims=True)
      cutoff_logit = np.take_along_axis(sorted_desc, cutoff_idx, axis=-1)
      scaled = np.where(scaled < cutoff_logit, -np.inf, scaled)
    gumbel = -np.log(-np.log(self._rng.uniform(size=scaled.shape) + 1e-12) + 1e-12)
    return np.argmax(scaled + gumbel, axis=-1).astype(np.int64)

  # ---------------------------------------------------------------- serving

  async def ensure_shard(self, shard: Shard) -> None:
    if self.shard == shard:
      return
    async with self._shard_lock:
      if self.shard == shard:
        return
      model_dir = await self.shard_downloader.ensure_shard(shard, type(self).__name__)
      if self.client is None:
        self.client = await SidecarClient.spawn(self._threads)
      resp, _ = await self.client.request({
        "cmd": "load", "model_path": str(model_dir), "layer_start": shard.start_layer,
        "layer_end": shard.end_layer, "layer_total": shard.n_layers, "cache_len": self._cache_len,
      })
      self._is_last = bool(resp.get("is_last"))
      self._model_dir = Path(model_dir)
      self.tokenizer = None
      await self._ensure_tokenizer()
      self.shard = shard
      if DEBUG >= 1:
        print(f"Native sidecar ready for {shard} ({resp.get('family')}, load "
              f"{resp.get('load_ns', 0) / 1e6:.0f} ms)", flush=True)

  async def infer_tensor(self, request_id: str, shard: Shard, input_data: np.ndarray,
                         inference_state: Optional[dict] = None) -> Tuple[np.ndarray, Optional[dict]]:
    await self.ensure_shard(shard)
    meta, payload = encode_input(np.asarray(input_data))
    resp, body = await self.client.request({"cmd": "infer", "session_id": request_id, "input": meta},
                                           payload)
    return decode_payload(resp["output"], body), inference_state

  async def infer_sample_tensor(self, request_id: str, shard: Shard, input_data: np.ndarray,
                                temp: float = 0.0, top_k: int = 0,
                                inference_state: Optional[dict] = None, top_p: float = 0.0,
                                sampling: Optional[dict] = None) -> Tuple[int, Optional[dict]]:
    """The last shard's logits from the sidecar, sampled here (the request's OpenAI
    extras are not applied: the sidecar has no sampler of its own)."""
    out, inference_state = await self.infer_tensor(request_id, shard, input_data, inference_state)
    token = await self.sample(out, temp=temp, top_k=top_k, top_p=top_p)
    return int(np.asarray(token).reshape(-1)[0]), inference_state

  async def generate_chunk(self, request_id: str, shard: Shard, prev_token: int, num_tokens: int,
                           temp: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                           next_size: Optional[int] = None) -> Optional[np.ndarray]:
    """Up to `num_tokens` tokens, one sidecar call each, ending at the tokenizer's eos."""
    tokens = []
    eos = getattr(self.tokenizer, "eos_token_id", None)
    for _ in range(num_tokens):
      prev_token, _ = await self.infer_sample_tensor(request_id, shard, np.array([[prev_token]]),
                                                     temp=temp, top_k=top_k, top_p=top_p)
      tokens.append(prev_token)
      if prev_token == eos:
        break
    return np.array(tokens, dtype=np.int64)

  async def clear_request(self, request_id: str) -> None:
    if self.client is not None:
      try:
        await self.client.request({"cmd": "reset", "session_id": request_id})
      except (ConnectionError, OSError, RuntimeError, asyncio.IncompleteReadError) as e:
        if DEBUG >= 2:
          print(f"sidecar reset of {request_id} failed: {e!r}")

  async def stop(self) -> None:
    if self.client is not None:
      await self.client.shutdown()
      self.client = None
