"""Tokenizers. The port's copy of `DummyTokenizer` from xotorch_tpu/inference/tokenizers.py,
which synthetic cards use. Resolving a Hugging Face tokenizer imports `transformers`
lazily, inside the call, and no synthetic path reaches it.
"""
from __future__ import annotations

from typing import List


class DummyTokenizer:
  """Fixed-vocab fake: one token per whitespace-separated word."""

  def __init__(self) -> None:
    self.eos_token_id = 69
    self.vocab_size = 1000

  def apply_chat_template(self, messages, tokenize: bool = True, add_generation_prompt: bool = True, tools=None) -> str:
    # Content-preserving, so token counts track the conversation.
    parts = [f"{m.get('role', 'user')}:" + " " + str(m.get("content", "")) for m in messages]
    if add_generation_prompt:
      parts.append("assistant:")
    return " ".join(parts)

  def encode(self, text: str) -> List[int]:
    return [1] * max(1, len(text.split()))

  def decode(self, tokens) -> str:
    return "dummy" + " dummy" * (len(tokens) - 1) if len(tokens) else ""


async def resolve_tokenizer(model_id_or_path: str):
  """A Hugging Face tokenizer from a local directory or repo id ("dummy" gives the
  fake)."""
  if str(model_id_or_path) in ("dummy", "dummy-model"):
    return DummyTokenizer()
  from transformers import AutoTokenizer
  return AutoTokenizer.from_pretrained(str(model_id_or_path), trust_remote_code=True)
