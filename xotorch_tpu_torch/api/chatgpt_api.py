"""OpenAI-compatible chat completions over the standard library only.

The port of the serving core of xotorch_tpu/api/chatgpt_api.py on
`asyncio.start_server` with a minimal HTTP/1.1 handler (one request per connection):

- POST /v1/chat/completions: `stream: false` (one JSON body with `usage` and
  `finish_reason`) and `stream: true` (server-sent events ending in `data: [DONE]`);
  `max_tokens`/`max_completion_tokens`, `temperature` and `top_p` (snapped to the JAX
  package's 0.05 grid) are honoured. The fields the JAX package also serves
  (`UNSERVED`: stop sequences, seed, the sampling extras, logprobs, n, tools) are
  answered 400 naming the field unless their value is neutral, which is served as if
  absent: none is dropped without a word. No card of the port takes images, so a
  message with an `image_url` part is answered 400 naming the model, as the JAX
  package answers for a card without vision (an undecodable data URI too);
- GET /v1/models lists the cards this engine serves; GET /healthcheck.

Synthetic models use DummyTokenizer, with the model's own EOS id.
"""
from __future__ import annotations

import asyncio
import base64
import binascii
import io
import json
import time
import uuid
from typing import Dict, List, Optional, Tuple

from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer, resolve_tokenizer, tokenizer_for_dir
from xotorch_tpu_torch.models.registry import build_base_shard, get_model_card, get_repo, get_supported_models
from xotorch_tpu_torch.utils.helpers import DEBUG, spawn_detached

REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
           500: "Internal Server Error"}


class HTTPError(Exception):
  def __init__(self, status: int, body: dict):
    super().__init__(body)
    self.status = status
    self.body = body


def _invalid(message: str) -> HTTPError:
  return HTTPError(400, {"error": {"type": "invalid_request_error", "message": message}})


def _number(value) -> bool:
  return isinstance(value, (int, float)) and not isinstance(value, bool)


# Request fields the JAX package serves and this package does not yet, each with the
# test for its neutral values (those mean "off" and are served as if absent).
UNSERVED = (
  ("n", lambda v: type(v) is int and v == 1),
  ("stop", lambda v: v in ("", [])),
  ("seed", lambda v: False),
  ("min_p", lambda v: _number(v) and v == 0),
  ("presence_penalty", lambda v: _number(v) and v == 0),
  ("frequency_penalty", lambda v: _number(v) and v == 0),
  ("logit_bias", lambda v: v == {}),
  ("logprobs", lambda v: v is False),
  ("top_logprobs", lambda v: type(v) is int and v == 0),
  ("tools", lambda v: v == []),
)


def decode_image_data_uri(uri: str):
  """data:image/...;base64,... -> the decoded RGB image. Every malformed input raises
  ValueError, so the API answers 400 and not 500 (the JAX package's
  `models/vision.decode_image_data_uri`)."""
  if not uri.startswith("data:"):
    raise ValueError("only data: image URIs are supported (zero-egress serving)")
  if "," not in uri:
    raise ValueError("malformed data URI: missing ',' payload separator")
  try:
    blob = base64.b64decode(uri.split(",", 1)[1], validate=True)
  except (binascii.Error, ValueError) as e:
    raise ValueError(f"invalid base64 image payload: {e}") from e
  try:
    from PIL import Image
  except ImportError as e:
    raise ValueError("PIL is required to decode image payloads") from e
  try:
    return Image.open(io.BytesIO(blob)).convert("RGB")
  except Exception as e:  # UnidentifiedImageError, truncated files, ...
    raise ValueError(f"undecodable image payload: {e}") from e


def extract_images(messages: List[dict]) -> list:
  """The decoded image of every image_url content part, in prompt order (the JAX
  package's `extract_images`, without its arrays: the port serves no vision card)."""
  images = []
  for m in messages:
    content = m.get("content", "")
    if not isinstance(content, list):
      continue
    for part in content:
      if isinstance(part, dict) and part.get("type") == "image_url":
        images.append(decode_image_data_uri((part.get("image_url") or {}).get("url", "")))
  return images


def refuse_images(model: str, messages: List[dict]) -> None:
  """400 naming the model for any image_url part: no card of the port has vision. An
  undecodable data URI is refused with the decoder's reason."""
  try:
    images = extract_images(messages)
  except ValueError as e:
    raise _invalid(f"model {model} does not support image input ({e})") from None
  if images:
    raise _invalid(f"model {model} does not support image input")


def build_prompt(tokenizer, messages: List[dict]) -> str:
  """Chat-template prompt (text parts only), with a plain fallback."""
  chat = []
  for m in messages:
    content = m.get("content", "")
    if isinstance(content, list):
      content = "\n".join(p.get("text", "") for p in content
                          if isinstance(p, dict) and p.get("type") == "text")
    chat.append({"role": m.get("role", "user"), "content": content})
  try:
    return tokenizer.apply_chat_template(chat, tokenize=False, add_generation_prompt=True)
  except Exception:
    return "\n".join(f"{m['role']}: {m['content']}" for m in chat) + "\nassistant:"


class ChatGPTAPI:
  def __init__(self, node, inference_engine_classname: str, response_timeout: int = 90,
               default_model: Optional[str] = None, system_prompt: Optional[str] = None):
    self.node = node
    self.inference_engine_classname = inference_engine_classname
    self.response_timeout = response_timeout
    self.default_model = default_model or "synthetic-llama-1b"
    self.system_prompt = system_prompt
    self.token_queues: Dict[str, asyncio.Queue] = {}
    self._tasks: set = set()
    self._tokenizers: Dict[str, object] = {}
    node.on_token.register("chatgpt-api-token-handler").on_next(self._enqueue_tokens)

  def _enqueue_tokens(self, request_id: str, tokens: List[int], is_finished: bool) -> None:
    q = self.token_queues.get(request_id)
    if q is not None:
      q.put_nowait((list(tokens), is_finished))

  # ------------------------------------------------------------------ HTTP

  async def start(self, host: str = "0.0.0.0", port: int = 52415) -> asyncio.AbstractServer:
    server = await asyncio.start_server(self._handle_connection, host, port)
    if DEBUG >= 0:
      print(f"ChatGPT-compatible API on http://{host}:{port}", flush=True)
    return server

  async def _handle_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
    try:
      method, path, body = await self._read_request(reader)
      await self._route(method, path, body, writer)
    except HTTPError as e:
      await self._write_json(writer, e.status, e.body)
    except (asyncio.IncompleteReadError, ConnectionError):
      pass  # the client went away
    except Exception as e:
      print(f"API error: {e!r}")
      try:
        await self._write_json(writer, 500, {"error": {"type": "server_error", "message": repr(e)}})
      except ConnectionError:
        pass
    finally:
      writer.close()
      try:
        await writer.wait_closed()
      except ConnectionError:
        pass

  async def _read_request(self, reader: asyncio.StreamReader) -> Tuple[str, str, bytes]:
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) < 2:
      raise _invalid(f"malformed request line {lines[0]!r}")
    headers = {}
    for line in lines[1:]:
      if ":" in line:
        key, value = line.split(":", 1)
        headers[key.strip().lower()] = value.strip()
    length = int(headers.get("content-length", "0") or 0)
    body = await reader.readexactly(length) if length else b""
    return parts[0].upper(), parts[1].split("?", 1)[0], body

  async def _write_json(self, writer: asyncio.StreamWriter, status: int, body: dict) -> None:
    payload = json.dumps(body).encode()
    writer.write((f"HTTP/1.1 {status} {REASONS.get(status, 'Error')}\r\n"
                  "Content-Type: application/json\r\n"
                  f"Content-Length: {len(payload)}\r\n"
                  "Connection: close\r\n\r\n").encode() + payload)
    await writer.drain()

  async def _route(self, method: str, path: str, body: bytes, writer: asyncio.StreamWriter) -> None:
    if path == "/healthcheck" and method == "GET":
      await self._write_json(writer, 200, {"status": "ok"})
    elif path in ("/v1/models", "/models") and method == "GET":
      await self._write_json(writer, 200, self.models_body())
    elif path in ("/v1/chat/completions", "/chat/completions"):
      if method != "POST":
        raise HTTPError(405, {"detail": f"{method} not allowed on {path}"})
      try:
        data = json.loads(body or b"{}")
      except json.JSONDecodeError as e:
        raise _invalid(f"request body is not JSON: {e}") from None
      await self.handle_post_chat_completions(data, writer)
    else:
      raise HTTPError(404, {"detail": f"no route {method} {path}"})

  def models_body(self) -> dict:
    return {"object": "list", "data": [
      {"id": m, "object": "model", "owned_by": "xotorch", "ready": True}
      for m in get_supported_models(self.inference_engine_classname)]}

  # ------------------------------------------------------- chat completions

  def _resolve_model(self, model: Optional[str]) -> str:
    if not model or model.startswith("gpt-"):
      return self.default_model
    return model

  async def _tokenizer_for(self, model: str):
    tok = self._tokenizers.get(model)
    if tok is None:
      card = get_model_card(model) or {}
      if "synthetic_config" in card:
        tok = DummyTokenizer()
        eos = card["synthetic_config"].get("eos_token_id")
        if eos is not None:
          tok.eos_token_id = eos if isinstance(eos, int) else eos[0]
      else:
        tok = await self._checkpoint_tokenizer(model)
      self._tokenizers[model] = tok
    return tok

  async def _checkpoint_tokenizer(self, model: str):
    """A checkpoint's tokenizer: the engine's when it serves `model`, else the one its
    downloader's directory gives (the DummyTokenizer where none can be built there,
    as the engine does), else the repo id's."""
    engine = self.node.inference_engine
    shard = getattr(engine, "shard", None)
    if shard is not None and shard.model_id == model and engine.tokenizer is not None:
      return engine.tokenizer
    downloader = getattr(engine, "shard_downloader", None)
    if downloader is not None:
      try:
        local = await downloader.ensure_shard(build_base_shard(model, self.inference_engine_classname),
                                              self.inference_engine_classname)
      except Exception as e:
        if DEBUG >= 1:
          print(f"local tokenizer resolve for {model} failed ({e!r}); trying its repo id")
      else:
        return await tokenizer_for_dir(local)
    return await resolve_tokenizer(get_repo(model, self.inference_engine_classname))

  def _eos_ids(self, tokenizer) -> set:
    ids = set(self.node._eos_token_ids())
    eos = getattr(tokenizer, "eos_token_id", None)
    if eos is not None:
      ids.add(eos)
    return ids

  @staticmethod
  def _parse_sampling(data: dict) -> Tuple[Optional[int], Optional[float], Optional[float]]:
    for name, neutral in UNSERVED:
      value = data.get(name)
      if value is not None and not neutral(value):
        raise HTTPError(400, {"error": {
          "type": "invalid_request_error", "param": name,
          "message": f"{name}={value!r} is not served by xotorch_tpu_torch yet (the JAX package "
                     f"serves it); leave {name} out or neutral"}})
    max_tokens = data.get("max_completion_tokens")
    if max_tokens is None:
      max_tokens = data.get("max_tokens")
    if max_tokens is not None and (isinstance(max_tokens, bool) or not isinstance(max_tokens, int)
                                   or max_tokens < 1):
      raise _invalid(f"max_tokens must be a positive integer, got {max_tokens!r}")
    temperature = data.get("temperature")
    if temperature is not None:
      if (isinstance(temperature, bool) or not isinstance(temperature, (int, float))
          or not 0 <= temperature <= 2):
        raise _invalid(f"temperature must be a number in [0, 2], got {temperature!r}")
      temperature = float(temperature)
    top_p = data.get("top_p")
    if top_p is not None:
      if isinstance(top_p, bool) or not isinstance(top_p, (int, float)) or not 0 < top_p <= 1:
        raise _invalid(f"top_p must be a number in (0, 1], got {top_p!r}")
      # The JAX package's 0.05 grid: top_p is a static of every captured decode graph
      # (a compile-time constant of JAX's executable), so a client's every distinct
      # value would otherwise capture graphs of its own. The floor of 0.05 keeps a tiny
      # top_p restrictive; a value that snaps to 1 (the OpenAI default) is off.
      top_p = max(0.05, round(float(top_p) * 20) / 20)
      top_p = top_p if top_p < 1 else None
    return max_tokens, temperature, top_p

  async def handle_post_chat_completions(self, data: dict, writer: asyncio.StreamWriter) -> None:
    model = self._resolve_model(data.get("model"))
    shard = build_base_shard(model, self.inference_engine_classname)
    if shard is None:
      raise HTTPError(400, {"detail": f"Invalid model: {model}. Supported: "
                                      f"{get_supported_models(self.inference_engine_classname)}"})
    max_tokens, temperature, top_p = self._parse_sampling(data)
    messages = data.get("messages", [])
    refuse_images(model, messages)
    if self.system_prompt and not any(m.get("role") == "system" for m in messages):
      messages = [{"role": "system", "content": self.system_prompt}] + messages
    tokenizer = await self._tokenizer_for(model)
    prompt = build_prompt(tokenizer, messages)

    request_id = str(uuid.uuid4())
    self.token_queues[request_id] = asyncio.Queue()
    spawn_detached(self.node.process_prompt(shard, prompt, request_id, max_tokens=max_tokens,
                                            temperature=temperature, top_p=top_p), self._tasks)
    try:
      if data.get("stream"):
        include_usage = bool((data.get("stream_options") or {}).get("include_usage"))
        await self._stream_response(writer, request_id, model, tokenizer,
                                    prompt if include_usage else None)
      else:
        tokens, error = await self._await_completion(request_id)
        status, body = self._full_response(request_id, tokens, error, model, tokenizer, prompt)
        await self._write_json(writer, status, body)
    except asyncio.TimeoutError:
      await self.node.cancel_request(request_id)
      raise HTTPError(500, {"error": {"type": "server_error",
                                      "message": f"no token for {self.response_timeout} s"}}) from None
    finally:
      self.token_queues.pop(request_id, None)

  async def _await_completion(self, request_id: str):
    tokens: List[int] = []
    finished = False
    while not finished:
      payload, finished = await asyncio.wait_for(self.token_queues[request_id].get(),
                                                 timeout=self.response_timeout)
      if len(payload) >= len(tokens):
        tokens = payload  # an empty finish signal must not wipe the completion
    return tokens, self.node.request_errors.pop(request_id, None)

  def _full_response(self, request_id: str, tokens: List[int], error: Optional[str], model: str,
                     tokenizer, prompt: str) -> Tuple[int, dict]:
    if error is not None:
      if error.startswith("context_length_exceeded"):
        return 400, {"error": {"type": "invalid_request_error",
                               "code": "context_length_exceeded", "message": error}}
      return 500, {"error": {"type": "server_error", "message": error}}
    eos_ids = self._eos_ids(tokenizer)
    finish_reason = "stop" if (tokens and tokens[-1] in eos_ids) else "length"
    content_tokens = [t for t in tokens if t not in eos_ids]
    prompt_tokens = len(tokenizer.encode(prompt))
    return 200, {
      "id": f"chatcmpl-{request_id}",
      "object": "chat.completion",
      "created": int(time.time()),
      "model": model,
      "choices": [{
        "index": 0,
        "message": {"role": "assistant",
                    "content": tokenizer.decode(content_tokens) if content_tokens else ""},
        "logprobs": None,
        "finish_reason": finish_reason,
      }],
      "usage": {"prompt_tokens": prompt_tokens, "completion_tokens": len(content_tokens),
                "total_tokens": prompt_tokens + len(content_tokens)},
    }

  def _chunk(self, request_id: str, model: str, content: str, finish_reason: Optional[str]) -> dict:
    return {
      "id": f"chatcmpl-{request_id}",
      "object": "chat.completion.chunk",
      "created": int(time.time()),
      "model": model,
      "choices": [{"index": 0,
                   "delta": {"role": "assistant", "content": content} if content else {},
                   "logprobs": None, "finish_reason": finish_reason}],
    }

  async def _stream_response(self, writer: asyncio.StreamWriter, request_id: str, model: str,
                             tokenizer, usage_prompt: Optional[str] = None) -> None:
    """Server-sent events: one chunk per batch of new tokens, the finish reason on the
    last, then `data: [DONE]`. With `usage_prompt` (OpenAI stream_options
    include_usage) a final chunk with empty choices carries the usage. The headers go
    out with the first event, so an error before any token still gets a plain JSON
    error response."""
    eos_ids = self._eos_ids(tokenizer)
    sent = 0
    started = False

    async def send(obj) -> None:
      nonlocal started
      if not started:
        started = True
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n")
      data = obj if isinstance(obj, str) else json.dumps(obj)
      writer.write(f"data: {data}\n\n".encode())
      await writer.drain()

    finished = False
    completion = 0
    while not finished:
      tokens, finished = await asyncio.wait_for(self.token_queues[request_id].get(),
                                                timeout=self.response_timeout)
      error = self.node.request_errors.pop(request_id, None) if finished else None
      if error is not None:
        if not started:
          status, body = self._full_response(request_id, [], error, model, tokenizer, "")
          raise HTTPError(status, body)
        etype = ("invalid_request_error" if error.startswith("context_length_exceeded")
                 else "server_error")
        await send({"error": {"type": etype, "message": error}})
        return
      delta = tokens[sent:]
      sent = max(sent, len(tokens))
      finish_reason = None
      if finished:
        finish_reason = "stop" if (delta and delta[-1] in eos_ids) else "length"
      new_tokens = [t for t in delta if t not in eos_ids]
      completion += len(new_tokens)
      content = tokenizer.decode(new_tokens) if new_tokens else ""
      await send(self._chunk(request_id, model, content, finish_reason))
    if usage_prompt is not None:
      prompt_tokens = len(tokenizer.encode(usage_prompt))
      chunk = self._chunk(request_id, model, "", None)
      chunk["choices"] = []
      chunk["usage"] = {"prompt_tokens": prompt_tokens, "completion_tokens": completion,
                        "total_tokens": prompt_tokens + completion}
      await send(chunk)
    await send("[DONE]")
