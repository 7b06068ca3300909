"""OpenAI-compatible chat completions over the standard library only.

The port of the serving core of xotorch_tpu/api/chatgpt_api.py on
`asyncio.start_server` with a minimal HTTP/1.1 handler (one request per connection):

- POST /v1/chat/completions: `stream: false` (one JSON body with `usage` and
  `finish_reason`) and `stream: true` (server-sent events ending in `data: [DONE]`).
  Every field the JAX package serves is served with its validation and messages:
  `max_tokens`/`max_completion_tokens`, `temperature`, `top_p` (snapped to the 0.05
  grid), `stop` (1-4 strings; the answer is cut before the first occurrence and the
  request cancelled; a stream holds back max(len(stop)) - 1 characters so it never
  sends part of one), `seed`, `min_p`, `presence_penalty`, `frequency_penalty`,
  `logit_bias` (the sampling extras, applied on the device by the sampler peer),
  `logprobs`/`top_logprobs` (per token, in both response shapes), `n` (1-8
  completions, sub-requests "rid#i") and `tools` (handed to the chat template). No
  card of the port takes images, so a message with an `image_url` part is answered
  400 naming the model, as the JAX package answers for a card without vision (an
  undecodable data URI too);
- POST /v1/chat/token/encode (and /chat/token/encode) builds a request's prompt as a
  completion would (system prompt and tools included) and returns its tokens;
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
from typing import Dict, List, NamedTuple, Optional, Tuple

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


class Params(NamedTuple):
  """A chat completion's validated request fields (the JAX package's handler)."""
  max_tokens: Optional[int]
  temperature: Optional[float]
  top_p: Optional[float]  # snapped to the 0.05 grid; None = off
  stop: Optional[List[str]]
  sampling: Optional[dict]  # the extras the sampler applies; None for a plain request
  logprobs: bool
  tools: Optional[list]
  n: int


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


def build_prompt(tokenizer, messages: List[dict], tools: Optional[list] = None) -> str:
  """Chat-template prompt with `tools` handed to the template, and a plain fallback
  (the JAX package's: an image_url part becomes an <image> placeholder where it
  stands)."""
  chat = []
  for m in messages:
    content = m.get("content", "")
    if isinstance(content, list):
      pieces = []
      for part in content:
        if not isinstance(part, dict):
          continue
        if part.get("type") == "text":
          pieces.append(part.get("text", ""))
        elif part.get("type") == "image_url":
          pieces.append("<image>")
      content = "\n".join(pieces)
    chat.append({"role": m.get("role", "user"), "content": content})
  try:
    kwargs = {"tokenize": False, "add_generation_prompt": True}
    if tools:
      kwargs["tools"] = tools
    return tokenizer.apply_chat_template(chat, **kwargs)
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
    elif path in ("/v1/chat/completions", "/chat/completions",
                  "/v1/chat/token/encode", "/chat/token/encode"):
      if method != "POST":
        raise HTTPError(405, {"detail": f"{method} not allowed on {path}"})
      try:
        data = json.loads(body or b"{}")
      except json.JSONDecodeError as e:
        raise _invalid(f"request body is not JSON: {e}") from None
      if path.endswith("/token/encode"):
        await self._write_json(writer, 200, await self.handle_post_chat_token_encode(data))
      else:
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

  async def _request_prompt(self, model: str, messages: List[dict], tools: Optional[list]):
    """(prompt, tokenizer) of a request, the system prompt injected as a completion
    gets it."""
    if self.system_prompt and not any(m.get("role") == "system" for m in messages):
      messages = [{"role": "system", "content": self.system_prompt}] + messages
    tokenizer = await self._tokenizer_for(model)
    return build_prompt(tokenizer, messages, tools), tokenizer

  async def handle_post_chat_token_encode(self, data: dict) -> dict:
    """Tokenize a chat request without running it: the prompt a completion would run
    (system prompt and tools included), as the JAX package answers."""
    model = self._resolve_model(data.get("model"))
    if build_base_shard(model, self.inference_engine_classname) is None:
      raise HTTPError(400, {"detail": f"Invalid model: {model}"})
    prompt, tokenizer = await self._request_prompt(model, data.get("messages", []),
                                                   data.get("tools"))
    tokens = tokenizer.encode(prompt)
    tokens = tokens.tolist() if hasattr(tokens, "tolist") else list(tokens)
    return {"length": len(prompt), "num_tokens": len(tokens), "encoded_tokens": tokens,
            "encoded_prompt": prompt}

  @staticmethod
  def _parse_sampling(data: dict) -> Params:
    """The request's fields, validated with the JAX package's checks and messages (each
    a 400). Neutral values (a zero penalty or min_p, an empty logit_bias, logprobs
    false, n 1, no tools) parse as absent."""
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
    stop = data.get("stop")
    if stop is not None:
      if isinstance(stop, str):
        stop = [stop]
      if (not isinstance(stop, list) or not stop or len(stop) > 4
          or not all(isinstance(s, str) and s for s in stop)):
        raise _invalid(f"stop must be a non-empty string or list of 1-4 strings, got {stop!r}")
    sampling: dict = {}
    seed = data.get("seed")
    if seed is not None:
      if isinstance(seed, bool) or not isinstance(seed, int) or not -(2**63) <= seed < 2**63:
        raise _invalid(f"seed must be a 64-bit integer, got {seed!r}")
      sampling["seed"] = seed
    min_p = data.get("min_p")
    if min_p is not None:
      if isinstance(min_p, bool) or not isinstance(min_p, (int, float)) or not 0 <= min_p <= 1:
        raise _invalid(f"min_p must be a number in [0, 1], got {min_p!r}")
      if min_p:
        sampling["min_p"] = float(min_p)
    for key in ("presence_penalty", "frequency_penalty"):
      pen = data.get(key)
      if pen is not None:
        if isinstance(pen, bool) or not isinstance(pen, (int, float)) or not -2 <= pen <= 2:
          raise _invalid(f"{key} must be a number in [-2, 2], got {pen!r}")
        if pen:
          sampling[key] = float(pen)
    logit_bias = data.get("logit_bias")
    if logit_bias is not None:
      # isascii(): isdigit() alone admits non-ASCII digits that int() refuses.
      ok = (isinstance(logit_bias, dict) and len(logit_bias) <= 300
            and all(isinstance(k, (str, int)) and str(k).isascii() and str(k).isdigit()
                    and isinstance(v, (int, float)) and not isinstance(v, bool)
                    and -100 <= v <= 100
                    for k, v in logit_bias.items()))
      if not ok:
        raise _invalid("logit_bias must map up to 300 non-negative token ids "
                       "to numbers in [-100, 100]")
      if logit_bias:
        sampling["logit_bias"] = {str(k): float(v) for k, v in logit_bias.items()}
    want_logprobs = data.get("logprobs")
    top_logprobs = data.get("top_logprobs")
    if want_logprobs is not None and not isinstance(want_logprobs, bool):
      raise _invalid(f"logprobs must be a boolean, got {want_logprobs!r}")
    if top_logprobs is not None:
      if (isinstance(top_logprobs, bool) or not isinstance(top_logprobs, int)
          or not 0 <= top_logprobs <= 20):
        raise _invalid(f"top_logprobs must be an integer in [0, 20], got {top_logprobs!r}")
      if not want_logprobs:
        raise _invalid("top_logprobs requires logprobs to be true")
    if want_logprobs:
      sampling["logprobs"] = int(top_logprobs or 0)
    n = data.get("n")
    if n is None:
      n = 1  # an explicit null means the default, as in the OpenAI API
    if isinstance(n, bool) or not isinstance(n, int) or not 1 <= n <= 8:
      raise _invalid(f"n must be an integer in [1, 8], got {n!r}")
    return Params(max_tokens, temperature, top_p, stop, sampling or None, bool(want_logprobs),
                  data.get("tools") or None, n)

  async def handle_post_chat_completions(self, data: dict, writer: asyncio.StreamWriter) -> None:
    model = self._resolve_model(data.get("model"))
    shard = build_base_shard(model, self.inference_engine_classname)
    if shard is None:
      raise HTTPError(400, {"detail": f"Invalid model: {model}. Supported: "
                                      f"{get_supported_models(self.inference_engine_classname)}"})
    p = self._parse_sampling(data)
    messages = data.get("messages", [])
    refuse_images(model, messages)
    prompt, tokenizer = await self._request_prompt(model, messages, p.tools)

    # n completions of one prompt: sub-requests "rid#0".."rid#n-1" (seeded siblings
    # draw distinct streams; plain ones coalesce in the engine's batcher).
    base = str(uuid.uuid4())
    request_ids = [base] if p.n == 1 else [f"{base}#{i}" for i in range(p.n)]
    for rid in request_ids:
      self.token_queues[rid] = asyncio.Queue()
    for rid in request_ids:
      spawn_detached(self.node.process_prompt(shard, prompt, rid, max_tokens=p.max_tokens,
                                              temperature=p.temperature, top_p=p.top_p,
                                              sampling=p.sampling), self._tasks)
    try:
      if data.get("stream"):
        include_usage = bool((data.get("stream_options") or {}).get("include_usage"))
        await self._stream_response(writer, request_ids, model, tokenizer,
                                    prompt if include_usage else None, p.stop, p.logprobs)
      else:
        eos_ids = self._eos_ids(tokenizer)
        results = await asyncio.gather(*(self._await_completion(rid, tokenizer, eos_ids, p.stop)
                                         for rid in request_ids))
        error = next((err for _, err in results if err), None)
        status, body = self._full_response(request_ids, results, error, model, tokenizer, prompt,
                                           eos_ids, p.stop, p.logprobs)
        await self._write_json(writer, status, body)
    except asyncio.TimeoutError:
      raise HTTPError(500, {"error": {"type": "server_error",
                                      "message": f"no token for {self.response_timeout} s"}}) from None
    finally:
      for rid in request_ids:
        self.token_queues.pop(rid, None)
        # A sub-request that ended early here (an error, a timeout, a stop sequence, a
        # client gone) must not decode on to its cap; a finished one is a no-op.
        await self.node.cancel_request(rid)

  async def _await_completion(self, request_id: str, tokenizer, eos_ids: set,
                              stop: Optional[List[str]]):
    """One sub-request's full token list and error. With `stop`, the node is cancelled
    once a stop sequence shows in the new tokens (decoded with a stop-sized overlap of
    tokens before them)."""
    tokens: List[int] = []
    finished = False
    cancel_sent = False
    scanned = 0
    while not finished:
      payload, finished = await asyncio.wait_for(self.token_queues[request_id].get(),
                                                 timeout=self.response_timeout)
      if len(payload) >= len(tokens):
        tokens = payload  # an empty finish signal must not wipe the completion
      if stop and not cancel_sent and not finished and len(tokens) > scanned:
        overlap = max(len(s) for s in stop)
        window = [t for t in tokens[max(0, scanned - overlap):] if t not in eos_ids]
        scanned = len(tokens)
        if any(s in tokenizer.decode(window) for s in stop):
          cancel_sent = True
          await self.node.cancel_request(request_id)
    return tokens, self.node.request_errors.pop(request_id, None)

  @staticmethod
  def _error_body(error: str) -> Tuple[int, dict]:
    if error.startswith("context_length_exceeded"):
      return 400, {"error": {"type": "invalid_request_error",
                             "code": "context_length_exceeded", "message": error}}
    return 500, {"error": {"type": "server_error", "message": error}}

  def _logprob_content(self, tokenizer, token_ids: List[int], entries: list) -> list:
    """OpenAI logprobs content items: each token's text, logprob, UTF-8 bytes and the
    top alternatives the sampler reported (entries 1:1 with token_ids)."""
    items = []
    for tid, ent in zip(token_ids, entries):
      text = tokenizer.decode([tid])
      tops = []
      for alt_id, alt_lp in ent.get("top", ()):
        alt_text = tokenizer.decode([alt_id])
        tops.append({"token": alt_text, "logprob": alt_lp, "bytes": list(alt_text.encode("utf-8"))})
      items.append({"token": text, "logprob": ent["logprob"], "bytes": list(text.encode("utf-8")),
                    "top_logprobs": tops})
    return items

  def _full_response(self, request_ids: List[str], results, error: Optional[str], model: str,
                     tokenizer, prompt: str, eos_ids: set, stop: Optional[List[str]] = None,
                     logprobs: bool = False) -> Tuple[int, dict]:
    """The JSON completion from the sub-requests' (tokens, error) results (the JAX
    package's `_build_full_response`): each choice cut before its first stop sequence
    (finish "stop"), its logprobs drained from the node, EOS dropped."""
    if error is not None:
      return self._error_body(error)
    choices = []
    total = 0
    for idx, (tokens, _) in enumerate(results):
      finish_reason = "stop" if (tokens and tokens[-1] in eos_ids) else "length"
      content_tokens = [t for t in tokens if t not in eos_ids]
      content = tokenizer.decode(content_tokens) if content_tokens else ""
      stop_cut = False
      if stop:
        cut = min((i for i in (content.find(s) for s in stop) if i >= 0), default=-1)
        if cut >= 0:
          # OpenAI: the completion ends BEFORE the stop sequence.
          content, finish_reason, stop_cut = content[:cut], "stop", True
          content_tokens = list(tokenizer.encode(content)) if content else []
      total += len(content_tokens)
      lp_obj = None
      if logprobs:
        # None where another peer sampled: the token broadcast carries ids only.
        entries = self.node.pop_request_logprobs(request_ids[idx])
        if entries is not None:
          pairs = [(t, e) for t, e in zip(tokens, entries) if t not in eos_ids]
          if stop_cut:
            # Cut at the sampled tokens' boundary: keep tokens until their decode covers
            # the kept text (a re-encode may tokenize the cut text otherwise).
            kept: list = []
            for pair in pairs:
              if len(tokenizer.decode([q[0] for q in kept])) >= len(content):
                break
              kept.append(pair)
            pairs = kept
          lp_obj = {"content": self._logprob_content(tokenizer, [q[0] for q in pairs],
                                                     [q[1] for q in pairs])}
      choices.append({"index": idx, "message": {"role": "assistant", "content": content},
                      "logprobs": lp_obj, "finish_reason": finish_reason})
    prompt_tokens = len(tokenizer.encode(prompt))
    return 200, {
      "id": f"chatcmpl-{request_ids[0].split('#')[0]}",
      "object": "chat.completion",
      "created": int(time.time()),
      "model": model,
      "choices": choices,
      "usage": {"prompt_tokens": prompt_tokens, "completion_tokens": total,
                "total_tokens": prompt_tokens + total},
    }

  def _chunk(self, request_id: str, model: str, content: str, finish_reason: Optional[str],
             index: int = 0, logprobs: Optional[dict] = None) -> dict:
    return {
      "id": f"chatcmpl-{request_id.split('#')[0]}",
      "object": "chat.completion.chunk",
      "created": int(time.time()),
      "model": model,
      "choices": [{"index": index,
                   "delta": {"role": "assistant", "content": content} if content else {},
                   "logprobs": logprobs, "finish_reason": finish_reason}],
    }

  async def _stream_response(self, writer: asyncio.StreamWriter, request_ids: List[str], model: str,
                             tokenizer, usage_prompt: Optional[str] = None,
                             stop: Optional[List[str]] = None, logprobs: bool = False) -> None:
    """Server-sent events over one or more completions (OpenAI n): the sub-requests'
    queues merged, one chunk per batch of new tokens carrying its choice index, the
    finish reason on each choice's last, then `data: [DONE]`. With `stop`, each choice's
    whole text is decoded again per batch and the last max(len(stop)) - 1 characters
    are held back until it finishes, so no part of a stop sequence reaches the client;
    a stop cuts the choice there (finish "stop") and cancels its request. With
    `logprobs` (and no stop) each chunk carries its tokens' logprobs. With
    `usage_prompt` (OpenAI stream_options include_usage) a final chunk with empty
    choices carries the usage. The headers go out with the first event, so an error
    before any token still gets a plain JSON error response."""
    eos_ids = self._eos_ids(tokenizer)
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

    n = len(request_ids)
    acc, sent_chars = [""] * n, [0] * n
    sent_tokens, completion, done = [0] * n, [0] * n, [False] * n
    holdback = max(len(s) for s in stop) - 1 if stop else 0
    merged: asyncio.Queue = asyncio.Queue()

    async def pump(idx: int, rid: str) -> None:
      while True:
        tokens, fin = await self.token_queues[rid].get()
        await merged.put((idx, rid, tokens, fin))
        if fin:
          return

    pumps = [spawn_detached(pump(i, rid)) for i, rid in enumerate(request_ids)]
    try:
      while not all(done):
        idx, rid, tokens, finished = await asyncio.wait_for(merged.get(),
                                                            timeout=self.response_timeout)
        if done[idx]:
          continue  # a straggler after a stop-sequence cut
        error = self.node.request_errors.pop(rid, None) if finished else None
        if error is not None:
          if not started:
            raise HTTPError(*self._error_body(error))
          etype = ("invalid_request_error" if error.startswith("context_length_exceeded")
                   else "server_error")
          await send({"error": {"type": etype, "message": error}})
          return
        delta = tokens[sent_tokens[idx]:]
        sent_tokens[idx] = max(sent_tokens[idx], len(tokens))
        finish_reason = None
        if finished:
          finish_reason = "stop" if (delta and delta[-1] in eos_ids) else "length"
        if stop:
          non_eos = [t for t in tokens if t not in eos_ids]
          text = tokenizer.decode(non_eos) if non_eos else ""
          scan_from = max(0, len(acc[idx]) - holdback)
          if len(text) >= len(acc[idx]):
            acc[idx] = text  # an empty finish signal must not wipe the text
          cut = min((i for i in (acc[idx].find(s, scan_from) for s in stop) if i >= 0), default=-1)
          if cut >= 0:
            content, finished, finish_reason = acc[idx][sent_chars[idx]:cut], True, "stop"
            completion[idx] = len(tokenizer.encode(acc[idx][:cut])) if cut else 0
            await self.node.cancel_request(rid)
          else:
            emit_to = len(acc[idx]) if finished else max(sent_chars[idx], len(acc[idx]) - holdback)
            content = acc[idx][sent_chars[idx]:emit_to]
            completion[idx] = len(non_eos)
          sent_chars[idx] += len(content)
        else:
          new_tokens = [t for t in delta if t not in eos_ids]
          completion[idx] += len(new_tokens)
          content = tokenizer.decode(new_tokens) if new_tokens else ""
        lp_obj = None
        if logprobs and not stop and delta:
          # Token-aligned: exactly this delta's entries. (A stop stream sends character
          # slices that cross token boundaries, so its chunks carry none.)
          entries = self.node.pop_request_logprobs(rid, len(delta))
          if entries is not None:
            pairs = [(t, e) for t, e in zip(delta, entries) if t not in eos_ids]
            lp_obj = {"content": self._logprob_content(tokenizer, [q[0] for q in pairs],
                                                       [q[1] for q in pairs])}
        done[idx] = done[idx] or finished
        await send(self._chunk(rid, model, content, finish_reason, index=idx, logprobs=lp_obj))
    finally:
      for task in pumps:
        task.cancel()
    if usage_prompt is not None:
      prompt_tokens = len(tokenizer.encode(usage_prompt))
      chunk = self._chunk(request_ids[0], model, "", None)
      chunk["choices"] = []
      total = sum(completion)
      chunk["usage"] = {"prompt_tokens": prompt_tokens, "completion_tokens": total,
                        "total_tokens": prompt_tokens + total}
      await send(chunk)
    await send("[DONE]")
