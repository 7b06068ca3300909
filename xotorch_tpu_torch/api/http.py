"""The port's HTTP/1.1 on asyncio streams, standard library only: the server half the
chat API and the router answer with, and the client half the router forwards with.

One request a connection (`Connection: close`), as the API has always served: a body
is framed by Content-Length, or a response without one (a server-sent event stream)
runs to the end of the connection. No chunked transfer coding, no keep-alive.
"""
from __future__ import annotations

import asyncio
import json
from typing import AsyncIterator, Dict, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

REASONS = {200: "OK", 202: "Accepted", 400: "Bad Request", 403: "Forbidden", 404: "Not Found",
           405: "Method Not Allowed", 429: "Too Many Requests", 500: "Internal Server Error",
           501: "Not Implemented", 502: "Bad Gateway", 503: "Service Unavailable"}

_CHUNK = 1 << 16


class BadRequest(ValueError):
  """A request line the server cannot parse."""


def _headers(lines) -> Dict[str, str]:
  out = {}
  for line in lines:
    if ":" in line:
      key, value = line.split(":", 1)
      out[key.strip().lower()] = value.strip()
  return out


async def read_request(reader: asyncio.StreamReader) -> Tuple[str, str, dict, bytes, Dict[str, str]]:
  """One request: (method, path, query, body, lower-cased headers)."""
  head = await reader.readuntil(b"\r\n\r\n")
  lines = head.decode("latin-1").split("\r\n")
  parts = lines[0].split(" ")
  if len(parts) < 2:
    raise BadRequest(f"malformed request line {lines[0]!r}")
  headers = _headers(lines[1:])
  length = int(headers.get("content-length", "0") or 0)
  body = await reader.readexactly(length) if length else b""
  path, _, query = parts[1].partition("?")
  return parts[0].upper(), path, dict(parse_qsl(query, keep_blank_values=True)), body, headers


def response_head(status: int, content_type: str, length: Optional[int] = None,
                  headers: Optional[dict] = None) -> bytes:
  """A response's status line and headers; without `length` the body runs to the end of
  the connection (a stream)."""
  extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
  framing = f"Content-Length: {length}\r\n" if length is not None else "Cache-Control: no-cache\r\n"
  return (f"HTTP/1.1 {status} {REASONS.get(status, 'Error')}\r\n"
          f"Content-Type: {content_type}\r\n{framing}{extra}"
          "Connection: close\r\n\r\n").encode()


async def write_response(writer: asyncio.StreamWriter, status: int, payload: bytes,
                         content_type: str, headers: Optional[dict] = None) -> None:
  writer.write(response_head(status, content_type, len(payload), headers))
  writer.write(payload)  # apart from the head: a packed KV entry is tens of MB
  await writer.drain()


async def write_json(writer: asyncio.StreamWriter, status: int, body, headers: Optional[dict] = None) -> None:
  await write_response(writer, status, json.dumps(body).encode(), "application/json", headers)


async def close_writer(writer: asyncio.StreamWriter) -> None:
  writer.close()
  try:
    await writer.wait_closed()
  except (ConnectionError, OSError):
    pass


# ------------------------------------------------------------------ client


class Response:
  """An upstream response whose head has been read. The body is read with `read()`
  (whole) or `chunks()` (as it arrives); `close()` drops the connection, which is how
  a caller abandons a request the server is still working on."""

  def __init__(self, status: int, headers: Dict[str, str], reader: asyncio.StreamReader,
               writer: asyncio.StreamWriter):
    self.status = status
    self.headers = headers
    self._reader = reader
    self._writer = writer

  @property
  def content_type(self) -> str:
    return self.headers.get("content-type", "application/octet-stream").split(";")[0].strip()

  async def read(self) -> bytes:
    try:
      length = self.headers.get("content-length")
      if length is not None:
        return await self._reader.readexactly(int(length))
      return await self._reader.read()
    finally:
      self.close()

  async def json(self):
    return json.loads(await self.read() or b"null")

  async def chunks(self) -> AsyncIterator[bytes]:
    """The body as it arrives, until the server closes the connection."""
    while True:
      chunk = await self._reader.read(_CHUNK)
      if not chunk:
        return
      yield chunk

  async def first_chunk(self) -> bytes:
    return await self._reader.read(_CHUNK)

  def close(self) -> None:
    self._writer.close()


async def _open(method: str, url: str, body: Optional[bytes], content_type: str) -> Response:
  parts = urlsplit(url)
  host, port = parts.hostname, parts.port or 80
  reader, writer = await asyncio.open_connection(host, port)
  try:
    target = parts.path or "/"
    if parts.query:
      target += "?" + parts.query
    head = (f"{method} {target} HTTP/1.1\r\nHost: {host}:{port}\r\n"
            f"Content-Length: {len(body or b'')}\r\n")
    if body:
      head += f"Content-Type: {content_type}\r\n"
    writer.write((head + "Connection: close\r\n\r\n").encode("latin-1") + (body or b""))
    await writer.drain()
    raw = await reader.readuntil(b"\r\n\r\n")
    lines = raw.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) < 2 or not parts[1].isdigit():
      raise ValueError(f"malformed status line {lines[0]!r}")
    return Response(int(parts[1]), _headers(lines[1:]), reader, writer)
  except BaseException:
    writer.close()
    raise


async def request(method: str, url: str, body=None, timeout: Optional[float] = None) -> Response:
  """Send one request and read the response's head within `timeout` seconds. `body`:
  bytes, or any other value sent as JSON. Raises OSError (ConnectionError among them)
  when the server cannot be reached, asyncio.TimeoutError past the timeout, ValueError
  on a malformed status line."""
  if body is not None and not isinstance(body, (bytes, bytearray)):
    body = json.dumps(body).encode()
  return await asyncio.wait_for(_open(method, url, body, "application/json"), timeout)


async def fetch_json(method: str, url: str, body=None, timeout: Optional[float] = None):
  """(status, parsed JSON body) of one request, the whole exchange within `timeout`."""
  async def go():
    resp = await _open(method, url, None if body is None else json.dumps(body).encode(),
                       "application/json")
    return resp.status, await resp.json()
  return await asyncio.wait_for(go(), timeout)
