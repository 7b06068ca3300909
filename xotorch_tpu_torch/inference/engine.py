"""InferenceEngine ABC + factory.

The port's copy of xotorch_tpu/inference/engine.py: the ABC the Node drives,
`CacheExhausted`, `RequestStateLost` and the engine factory. Engines work on numpy at
the boundary, so the orchestration layer never sees device tensors.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Optional, Tuple

import numpy as np

from xotorch_tpu_torch.inference.shard import Shard


class CacheExhausted(Exception):
  """The request's KV cache is full: generation cannot continue, but the tokens
  produced so far are valid — the orchestrator ends the request as a normal 'length'
  finish rather than an error."""


class RequestStateLost(Exception):
  """The engine no longer holds the request's device state. Continuing would silently
  restart from an empty cache; the orchestrator must abort the request instead."""


class InferenceEngine(ABC):
  """One peer's compute backend for a layer-range shard."""

  @abstractmethod
  async def encode(self, shard: Shard, prompt: str) -> np.ndarray:
    ...

  @abstractmethod
  async def sample(self, x: np.ndarray, temp: float = 0.0, top_k: int = 0, top_p: float = 0.0) -> np.ndarray:
    ...

  @abstractmethod
  async def decode(self, shard: Shard, tokens: np.ndarray) -> str:
    ...

  @abstractmethod
  async def infer_tensor(
    self, request_id: str, shard: Shard, input_data: np.ndarray, inference_state: Optional[dict] = None
  ) -> Tuple[np.ndarray, Optional[dict]]:
    """Run this shard's layers. 2-D int input = token ids (first shard); 3-D float
    input = hidden state from the previous shard."""
    ...

  @abstractmethod
  async def ensure_shard(self, shard: Shard) -> None:
    ...

  @abstractmethod
  async def infer_sample_tensor(
    self, request_id: str, shard: Shard, input_data: np.ndarray, temp: float = 0.0, top_k: int = 0,
    inference_state: Optional[dict] = None, top_p: float = 0.0, sampling: Optional[dict] = None,
  ) -> Tuple[int, Optional[dict]]:
    """Run the last shard's layers and sample on the device: the host gets one int.
    `sampling` holds the request's OpenAI extras (seed, logit_bias, presence_penalty,
    frequency_penalty, min_p, logprobs), kept with the request for its later calls
    and decode chunks."""
    ...

  @abstractmethod
  async def generate_chunk(
    self, request_id: str, shard: Shard, prev_token: int, num_tokens: int, temp: float = 0.0,
    top_k: int = 0, top_p: float = 0.0, next_size: Optional[int] = None,
  ) -> Optional[np.ndarray]:
    """Up to `num_tokens` tokens decoded on the device for a prefilled request whose
    shard spans the whole model."""
    ...

  def pop_logprobs(self, request_id: str, n: Optional[int] = None) -> Optional[list]:
    """Drain up to `n` (default all) of the request's recorded logprob entries
    ({"logprob", "top": [(id, logprob), ...]} a sampled token, in sampling order); None
    when nothing was recorded."""
    return None

  async def infer_prompt(
    self, request_id: str, shard: Shard, prompt: str, inference_state: Optional[dict] = None,
    images: Optional[list] = None, **engine_kwargs,
  ) -> Tuple[np.ndarray, Optional[dict]]:
    """Default text path: encode -> infer_tensor."""
    if images:
      raise ValueError(
        f"{type(self).__name__} has no vision path; cannot process {len(images)} image(s)"
      )
    tokens = await self.encode(shard, prompt)
    x = tokens.reshape(1, -1)
    return await self.infer_tensor(request_id, shard, x, inference_state, **engine_kwargs)


# Every alias -> canonical classname; the model registry keys repos by classname.
inference_engine_classes: Dict[str, str] = {
  "torch": "TorchShardInferenceEngine",
  "cuda": "TorchShardInferenceEngine",
  "TorchShardInferenceEngine": "TorchShardInferenceEngine",
}


def get_inference_engine(inference_engine_name: str, shard_downloader=None,
                         device: Optional[str] = None, quantize: Optional[str] = None,
                         kv_quant: Optional[str] = None) -> InferenceEngine:
  classname = inference_engine_classes.get(inference_engine_name)
  if classname == "TorchShardInferenceEngine":
    from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
    return TorchShardInferenceEngine(shard_downloader, device=device, quantize=quantize,
                                     kv_quant=kv_quant)
  raise ValueError(f"Unsupported inference engine: {inference_engine_name}")
