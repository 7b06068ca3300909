"""Deterministic fake engine for orchestration and transport tests and CLI dry runs.

The port's copy of xotorch_tpu/inference/dummy.py (numpy only): identity forward (+1
on the last shard), EOS after 10 sampled tokens, the count shared by every request of
the engine. The port's Node drives every last shard through `infer_sample_tensor` and
a whole-model shard's decode through `generate_chunk`, so the fake has both, built
on `infer_tensor` and `sample`: they give the tokens the JAX package's Node gets from
its per-token ring over the JAX fake, and a chunk stops at EOS, so the count never
runs past it. Training and evaluation answer a loss of 0.42 from the last shard and
chain through `forward_fn` elsewhere, as JAX's fake does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from xotorch_tpu_torch.inference.engine import InferenceEngine
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer


class DummyInferenceEngine(InferenceEngine):
  def __init__(self) -> None:
    self.shard: Optional[Shard] = None
    self.tokenizer = DummyTokenizer()
    self.num_generate_dummy_tokens = 10
    self._count = 0
    self.session = {}

  async def encode(self, shard: Shard, prompt: str) -> np.ndarray:
    await self.ensure_shard(shard)
    return np.array(self.tokenizer.encode(prompt), dtype=np.int64)

  async def sample(self, x: np.ndarray, temp: float = 0.0, top_k: int = 0, top_p: float = 0.0) -> np.ndarray:
    # Count-based EOS so ring tests end deterministically.
    self._count += 1
    if self._count >= self.num_generate_dummy_tokens:
      self._count = 0
      return np.array([self.tokenizer.eos_token_id])
    return np.array([np.argmax(x[0, -1]) % self.tokenizer.vocab_size if x.ndim == 3 else 1])

  async def decode(self, shard: Shard, tokens: np.ndarray) -> str:
    await self.ensure_shard(shard)
    return self.tokenizer.decode(tokens)

  async def infer_tensor(self, request_id: str, shard: Shard, input_data: np.ndarray,
                         inference_state=None) -> Tuple[np.ndarray, Optional[dict]]:
    await self.ensure_shard(shard)
    input_data = np.asarray(input_data)
    if input_data.ndim == 2:  # token ids -> a fake hidden state
      x = input_data[..., None].astype(np.float32) * np.ones((1, 1, 8), dtype=np.float32)
    else:
      x = input_data.astype(np.float32)
    out = x + 1 if shard.is_last_layer else x
    return out, inference_state

  async def infer_sample_tensor(self, request_id: str, shard: Shard, input_data: np.ndarray,
                                temp: float = 0.0, top_k: int = 0, inference_state: Optional[dict] = None,
                                top_p: float = 0.0, sampling: Optional[dict] = None) -> Tuple[int, Optional[dict]]:
    out, inference_state = await self.infer_tensor(request_id, shard, input_data, inference_state)
    token = await self.sample(out, temp=temp, top_k=top_k, top_p=top_p)
    return int(np.asarray(token).reshape(-1)[0]), inference_state

  async def generate_chunk(self, request_id: str, shard: Shard, prev_token: int, num_tokens: int,
                           temp: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                           next_size: Optional[int] = None) -> Optional[np.ndarray]:
    tokens = []
    for _ in range(num_tokens):
      prev_token, _ = await self.infer_sample_tensor(request_id, shard, np.array([[prev_token]]),
                                                     temp=temp, top_k=top_k, top_p=top_p)
      tokens.append(prev_token)
      if prev_token == self.tokenizer.eos_token_id:
        break
    return np.array(tokens, dtype=np.int64)

  async def ensure_shard(self, shard: Shard) -> None:
    self.shard = shard

  async def train_example(self, request_id, shard, example, target, lengths, forward_fn=None):
    await self.ensure_shard(shard)
    if shard.is_last_layer:
      return 0.42, np.zeros_like(np.asarray(example, dtype=np.float32))
    assert forward_fn is not None
    activations = np.asarray(example, dtype=np.float32)
    loss, _ = await forward_fn(activations, target, lengths, True)
    return loss, np.zeros_like(activations)

  async def evaluate_example(self, request_id, shard, example, target, lengths,
                             forward_fn=None) -> float:
    await self.ensure_shard(shard)
    if shard.is_last_layer:
      return 0.42
    assert forward_fn is not None
    loss, _ = await forward_fn(np.asarray(example, dtype=np.float32), target, lengths, False)
    return loss
