"""A terminal chat with live tokens a second: the port's copy of
xotorch_tpu/viz/chat_tui.py.

Each line read from stdin is a user turn: the history goes through the tokenizer's
chat template (JAX's plain "role: content" fallback when it has none), the reply's
tokens print as the ring streams them, then `[n tokens, r tok/s]`, the rate from the
first token to the last as the sampler delivered them. EOF, `exit` or `quit` ends it.
"""
from __future__ import annotations

import asyncio
import time
import uuid
from typing import List

from xotorch_tpu_torch.models.registry import build_base_shard


async def run_chat_tui(node, inference_engine_classname: str, model_id: str, tokenizer) -> None:
  shard = build_base_shard(model_id, inference_engine_classname)
  if shard is None:
    print(f"Unsupported model: {model_id}")
    return
  print(f"Chatting with {model_id}. Ctrl-D or 'exit' to quit.", flush=True)
  history: List[dict] = []
  loop = asyncio.get_running_loop()
  eos = getattr(tokenizer, "eos_token_id", None)
  while True:
    try:
      user_input = await loop.run_in_executor(None, lambda: input("\n> "))
    except (EOFError, KeyboardInterrupt):
      break
    if user_input.strip() in ("exit", "quit"):
      break
    if not user_input.strip():
      continue
    history.append({"role": "user", "content": user_input})
    try:
      prompt = tokenizer.apply_chat_template(history, tokenize=False, add_generation_prompt=True)
    except Exception:  # a tokenizer without a chat template: JAX's fallback
      prompt = "\n".join(f"{m['role']}: {m['content']}" for m in history) + "\nassistant:"
    request_id = str(uuid.uuid4())
    done = asyncio.Event()
    state = {"tokens": [], "started": None, "printed": 0}

    def on_token(req_id, tokens, is_finished):
      if req_id != request_id:
        return
      if state["started"] is None:
        state["started"] = time.monotonic()
      state["tokens"] = list(tokens)
      new = tokens[state["printed"]:]
      state["printed"] = len(tokens)
      print(tokenizer.decode([t for t in new if t != eos]), end="", flush=True)
      if is_finished:
        done.set()

    node.on_token.register(f"chat-tui-{request_id}").on_next(on_token)
    try:
      await node.process_prompt(shard, prompt, request_id)
      await asyncio.wait_for(done.wait(), timeout=300)
      elapsed = time.monotonic() - (state["started"] or time.monotonic())
      n = len(state["tokens"])
      if elapsed > 0 and n:
        print(f"\n[{n} tokens, {n / elapsed:.1f} tok/s]", flush=True)
      history.append({"role": "assistant",
                      "content": tokenizer.decode([t for t in state["tokens"] if t != eos])})
    except asyncio.TimeoutError:
      print("\n[timed out]", flush=True)
    finally:
      node.on_token.deregister(f"chat-tui-{request_id}")
