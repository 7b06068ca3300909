"""Node: one peer that owns the whole model and serves prompts.

The port of the single-partition path of xotorch_tpu/orchestration/node.py: no
discovery, networking or topology — the node's one partition is the whole model.
`process_prompt` keeps the JAX Node's signature and `on_token` callback system. A
prompt is prefilled and its first token sampled in one engine call
(`infer_sample_tensor`), then a fused decode loop asks the engine for chunks of
tokens with the same adaptive ladder (XOT_DECODE_CHUNK doubling up to
XOT_DECODE_CHUNK_MAX), applying the request's max_tokens, temperature and top_p and
finishing on EOS or length.
"""
from __future__ import annotations

import time
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from xotorch_tpu_torch.inference.engine import CacheExhausted, InferenceEngine
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG, AsyncCallbackSystem, spawn_detached


class Node:
  def __init__(
    self,
    _id: str,
    inference_engine: InferenceEngine,
    max_generate_tokens: int = 1024,
    default_sample_temp: float = 0.6,
    default_sample_top_k: int = 35,
    decode_chunk_size: Optional[int] = None,
  ):
    self.id = _id
    self.inference_engine = inference_engine
    self.max_generate_tokens = max_generate_tokens
    self.default_sample_temp = default_sample_temp
    self.default_sample_top_k = default_sample_top_k
    # Tokens per fused decode call; each call doubles the next one up to the ceiling,
    # so the first chunk stays small for streaming latency.
    self.decode_chunk_size = (decode_chunk_size if decode_chunk_size is not None
                              else knobs.get_int("XOT_DECODE_CHUNK"))
    self.max_decode_chunk_size = max(self.decode_chunk_size, knobs.get_int("XOT_DECODE_CHUNK_MAX"))
    self.buffered_token_output: Dict[str, Tuple[List[int], bool]] = {}
    self.on_token: AsyncCallbackSystem = AsyncCallbackSystem()
    self.outstanding_requests: Dict[str, str] = {}
    # Why a request aborted (bounded LRU; the API pops entries when reporting).
    self.request_errors: "OrderedDict[str, str]" = OrderedDict()
    self._request_max_tokens: Dict[str, int] = {}
    self._request_temp: Dict[str, float] = {}
    self._request_top_p: Dict[str, float] = {}
    self._request_eos: Dict[str, Tuple[int, ...]] = {}
    self._request_started: Dict[str, float] = {}
    self._cancelled: "OrderedDict[str, None]" = OrderedDict()
    self._tasks: set = set()

  def _spawn(self, coro):
    return spawn_detached(coro, self._tasks)

  async def stop(self) -> None:
    for task in list(self._tasks):
      task.cancel()

  def full_shard(self, base_shard: Shard) -> Shard:
    """This node's partition: every layer of the model."""
    return Shard(base_shard.model_id, 0, base_shard.n_layers - 1, base_shard.n_layers)

  async def process_prompt(self, base_shard: Shard, prompt: str, request_id: Optional[str] = None,
                           traceparent: Optional[str] = None, max_tokens: Optional[int] = None,
                           images: Optional[List[np.ndarray]] = None,
                           temperature: Optional[float] = None,
                           top_p: Optional[float] = None,
                           sampling: Optional[dict] = None,
                           ring_map: Optional[list] = None,
                           deadline: Optional[float] = None) -> None:
    """Prefill `prompt` and start decoding; tokens arrive through `on_token`.
    `traceparent`, `ring_map` and `deadline` belong to the multi-peer ring and are
    accepted and ignored here; images and sampling extras are not ported yet and
    abort the request."""
    if request_id is None:
      request_id = str(uuid.uuid4())
    self._request_started.setdefault(request_id, time.monotonic())
    if max_tokens is not None:
      self._request_max_tokens[request_id] = self._clamp_max_tokens(max_tokens)
    if temperature is not None:
      self._request_temp[request_id] = max(0.0, float(temperature))
    if top_p is not None:
      self._request_top_p[request_id] = min(1.0, max(0.0, float(top_p)))
    if images or sampling:
      what = "images" if images else f"sampling extras {sorted(sampling)}"
      await self._abort_request(request_id, f"{what} are not supported by xotorch_tpu_torch yet")
      return
    try:
      await self._process_prompt(base_shard, prompt, request_id)
    except CacheExhausted as e:
      # The prompt itself does not fit the KV budget: a client error, answered 400.
      await self._abort_request(request_id, f"context_length_exceeded: {e}")
    except Exception as e:
      print(f"Error processing prompt [{request_id}]: {e!r}")
      if DEBUG >= 2:
        import traceback
        traceback.print_exc()
      await self._abort_request(request_id, f"prompt processing failed on {self.id}: {e!r}")

  async def _process_prompt(self, base_shard: Shard, prompt: str, request_id: str) -> None:
    shard = self.full_shard(base_shard)
    self.outstanding_requests[request_id] = "processing prompt"
    tokens = await self.inference_engine.encode(shard, prompt)
    token, _ = await self.inference_engine.infer_sample_tensor(
      request_id, shard, np.asarray(tokens).reshape(1, -1),
      temp=self._temp_for(request_id), top_k=self.default_sample_top_k,
      top_p=self._top_p_for(request_id))
    await self.process_sampled_token(base_shard, int(token), request_id)

  async def process_sampled_token(self, base_shard: Shard, token_int: int, request_id: str) -> None:
    """Buffer the first sampled token, then stop (EOS/cap) or start the decode loop.
    The loop runs detached, so process_prompt returns after the first token and
    streaming starts at once."""
    buffered, _ = self.buffered_token_output.setdefault(request_id, ([], False))
    if self._ingest_sampled_tokens(request_id, [token_int], buffered, base_shard):
      await self._finish_generation(request_id)
      return
    self._spawn(self._fused_decode_loop(base_shard, self.full_shard(base_shard), request_id, buffered))

  async def _fused_decode_loop(self, base_shard: Shard, shard: Shard, request_id: str,
                               buffered: List[int]) -> None:
    """Chunked decode until EOS or the cap; tokens past EOS inside a chunk are
    discarded."""
    try:
      self.outstanding_requests[request_id] = "generating"
      size = self.decode_chunk_size
      while True:
        if request_id in self._cancelled:
          await self._finish_generation(request_id)
          return
        limit = self._request_max_tokens.get(request_id, self.max_generate_tokens)
        remaining = max(1, limit - len(buffered))
        # Never compute far past the cap: the last chunk shrinks to the next power
        # of two covering what the cap still allows.
        this_size = min(size, 1 << (remaining - 1).bit_length())
        rem_after = remaining - this_size
        next_hint = (min(min(size * 2, self.max_decode_chunk_size),
                         1 << (rem_after - 1).bit_length()) if rem_after >= 1 else None)
        chunk = await self.inference_engine.generate_chunk(
          request_id, shard, buffered[-1], this_size, temp=self._temp_for(request_id),
          top_k=self.default_sample_top_k, top_p=self._top_p_for(request_id),
          next_size=next_hint)
        if chunk is None:
          raise RuntimeError(f"engine cannot decode {shard} in fused chunks")
        if self._ingest_sampled_tokens(request_id, chunk.reshape(-1).tolist(), buffered, base_shard):
          await self._finish_generation(request_id)
          return
        size = min(size * 2, self.max_decode_chunk_size)
    except CacheExhausted as e:
      if DEBUG >= 1:
        print(f"[{request_id}] cache exhausted, finishing as length: {e}")
      await self._finish_as_length(request_id)
    except Exception as e:
      print(f"Error in fused decode for [{request_id}]: {e!r}")
      if DEBUG >= 2:
        import traceback
        traceback.print_exc()
      await self._abort_request(request_id, f"fused decode failed on {self.id}: {e!r}")

  def _ingest_sampled_tokens(self, request_id: str, new_tokens: List[int], buffered: List[int],
                             base_shard: Optional[Shard] = None) -> bool:
    """Append tokens to the request's buffer, stopping at EOS or the cap, and fire
    the callbacks. Returns finished."""
    if request_id in self._cancelled:
      return True
    eos = self._request_eos.get(request_id)
    if eos is None:
      eos = self._eos_token_ids(base_shard)
      if eos:
        self._request_eos[request_id] = eos
    limit = self._request_max_tokens.get(request_id, self.max_generate_tokens)
    finished = False
    for t in new_tokens:
      buffered.append(int(t))
      if int(t) in eos or len(buffered) >= limit:
        finished = True
        break
    self.buffered_token_output[request_id] = (buffered, finished)
    self.trigger_on_token_callbacks(request_id, buffered, finished)
    return finished

  async def _finish_generation(self, request_id: str) -> None:
    self.finish_request_state(request_id)
    self.buffered_token_output.pop(request_id, None)
    await self.inference_engine.clear_request(request_id)

  async def _finish_as_length(self, request_id: str) -> None:
    """End a request whose cache filled as a normal 'length' completion."""
    buffered, _ = self.buffered_token_output.get(request_id, ([], False))
    self.trigger_on_token_callbacks(request_id, buffered, True)
    await self._finish_generation(request_id)

  async def _abort_request(self, request_id: str, error: str) -> None:
    self.request_errors[request_id] = error
    while len(self.request_errors) > 512:
      self.request_errors.popitem(last=False)
    buffered, _ = self.buffered_token_output.get(request_id, ([], False))
    self.trigger_on_token_callbacks(request_id, buffered, True)
    await self._finish_generation(request_id)

  async def cancel_request(self, request_id: str) -> None:
    """Stop a request at its next chunk boundary (client gone, stop sequence)."""
    self._cancelled[request_id] = None
    while len(self._cancelled) > 512:
      self._cancelled.popitem(last=False)

  def finish_request_state(self, request_id: str) -> None:
    self.outstanding_requests.pop(request_id, None)
    self._request_started.pop(request_id, None)
    self._request_max_tokens.pop(request_id, None)
    self._request_temp.pop(request_id, None)
    self._request_top_p.pop(request_id, None)
    self._request_eos.pop(request_id, None)

  def trigger_on_token_callbacks(self, request_id: str, tokens: List[int], is_finished: bool) -> None:
    self.on_token.trigger_all(request_id, tokens, is_finished)

  def _temp_for(self, request_id: str) -> float:
    return self._request_temp.get(request_id, self.default_sample_temp)

  def _top_p_for(self, request_id: str) -> float:
    return self._request_top_p.get(request_id, 0.0)

  def _clamp_max_tokens(self, cap: Any) -> int:
    return max(1, min(int(cap), self.max_generate_tokens))

  def _eos_token_ids(self, base_shard: Optional[Shard] = None) -> Tuple[int, ...]:
    """EOS ids of the request's model, from the engine."""
    if base_shard is None:
      base_shard = self.inference_engine.shard
      if base_shard is None:
        return ()
    return tuple(self.inference_engine.eos_token_ids_for(self.full_shard(base_shard)))
