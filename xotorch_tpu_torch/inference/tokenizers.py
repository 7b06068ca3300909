"""Tokenizers: a model dir's own Hugging Face tokenizer, or the fixed-vocab fake.

The port of xotorch_tpu/inference/tokenizers.py. `resolve_tokenizer` prefers a local
directory that holds a tokenizer artifact (a repo id maps to its directory under
`XOT_HOME/models`), then builds it with `transformers`, imported lazily inside the
call: no module of the port imports it at load, and a machine without it still serves
(`tokenizer_for_dir` falls back to `DummyTokenizer` with the config's eos, as the JAX
engine does). Synthetic cards use `DummyTokenizer`.
"""
from __future__ import annotations

import asyncio
import os
from pathlib import Path
from typing import List, Union

from xotorch_tpu_torch.utils.helpers import DEBUG


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


async def resolve_tokenizer(model_id_or_path: Union[str, "os.PathLike"], allow_dummy: bool = True):
  """The tokenizer of a local directory or a repo id ("dummy" gives the fake)."""
  if str(model_id_or_path) in ("dummy", "dummy-model") and allow_dummy:
    return DummyTokenizer()
  return await _resolve_hf_tokenizer(_prefer_local_dir(str(model_id_or_path)))


async def tokenizer_for_dir(model_dir: Union[str, "os.PathLike"]):
  """The tokenizer of a checkpoint's directory, as the engine serves it: where none can
  be built there (no tokenizer file, or no `transformers` on this machine), the
  DummyTokenizer with the first eos id of the directory's config.json."""
  try:
    return await resolve_tokenizer(model_dir)
  except Exception as e:
    if DEBUG >= 1:
      print(f"Tokenizer resolution failed for {model_dir}: {e!r}; using dummy tokenizer")
    from xotorch_tpu_torch.models.config import load_model_config
    tokenizer = DummyTokenizer()
    eos = load_model_config(Path(model_dir)).eos_token_ids
    if eos:
      tokenizer.eos_token_id = eos[0]
    return tokenizer


def _prefer_local_dir(repo_or_path: str) -> str:
  """Map a repo id to its local directory under XOT_HOME/models when that directory
  holds a tokenizer artifact, so that no hub lookup is tried for files on disk. An
  existing directory counts as a local path only when it holds such an artifact: a
  repo id like 'org/name' is also a relative path."""
  from xotorch_tpu_torch.download.hf_shard_download import has_tokenizer_artifact, models_dir
  if (os.path.sep in repo_or_path and os.path.isdir(repo_or_path)
      and has_tokenizer_artifact(Path(repo_or_path))):
    return repo_or_path
  local = models_dir() / repo_or_path.replace("/", "--")
  if local.is_dir() and has_tokenizer_artifact(local):
    return str(local)
  return repo_or_path


async def _resolve_hf_tokenizer(repo_or_path: str):
  """`transformers`' tokenizer (or processor) for a directory or repo id, built on a
  worker thread: its import and file parsing take seconds, and a serving process's event
  loop must go on answering health checks meanwhile."""
  return await asyncio.get_running_loop().run_in_executor(None, _load_hf_tokenizer, repo_or_path)


def _load_hf_tokenizer(repo_or_path: str):
  from transformers import AutoProcessor, AutoTokenizer

  try:
    if DEBUG >= 4:
      print(f"Trying AutoProcessor for {repo_or_path}")
    processor = AutoProcessor.from_pretrained(repo_or_path, use_fast=True, trust_remote_code=True)
    inner = getattr(processor, "tokenizer", None)
    if inner is not None:
      # The plain-tokenizer surface on a processor.
      if not hasattr(processor, "eos_token_id") or processor.eos_token_id is None:
        processor.eos_token_id = inner.eos_token_id
      if not hasattr(processor, "encode"):
        processor.encode = inner.encode
      if not hasattr(processor, "decode"):
        processor.decode = inner.decode
    return processor
  except Exception as e:
    if DEBUG >= 4:
      print(f"AutoProcessor failed for {repo_or_path}: {e!r}; falling back to AutoTokenizer")

  return AutoTokenizer.from_pretrained(repo_or_path, trust_remote_code=True)
