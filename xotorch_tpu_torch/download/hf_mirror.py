"""A local HF endpoint: model directories served as Hugging Face repos over HTTP.

The two APIs the downloader reads, on the standard library: the tree listing
(`GET /api/models/<org>/<name>/tree/<revision>[/<dir>]`, one directory level of
{"type", "path", "size"} entries a request) and the files
(`GET /<org>/<name>/resolve/<revision>/<path>`), with `Range: bytes=N-` answered 206
(416 past the end) and the content hashes HF sends: an `X-Linked-ETag` sha256 for the
weight files (HF's LFS files) and an `ETag` git-blob sha1 for the rest. The downloader's
tests and `chip_smoke.py` point HF_ENDPOINT at one on loopback:

    with HFMirror({"unsloth/Llama-3.2-1B-Instruct": "/data/llama-3.2-1b"}) as mirror:
        os.environ["HF_ENDPOINT"] = mirror.url

Every revision name serves the directory as it is. Each request is logged in
`HFMirror.log` as (method, path, headers), a handler class of its own may be given
(the downloader's checks answer errors and wrong hashes through one), and a file's
hash is computed once, when it is first served.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional, Tuple
from urllib.parse import unquote

# Files HF keeps in LFS, whose X-Linked-ETag is the content's sha256.
LFS_SUFFIXES = (".safetensors", ".bin", ".model", ".gguf", ".pt", ".pth", ".h5", ".msgpack")
_CHUNK = 1 << 20


def file_hash(path: Path, lfs: bool) -> str:
  """The content hash HF sends for a file: sha256 of an LFS file, else its git-blob
  sha1 (of "blob <size>\\0" and the bytes)."""
  h = hashlib.sha256() if lfs else hashlib.sha1(f"blob {path.stat().st_size}\0".encode())
  with open(path, "rb") as f:
    for block in iter(lambda: f.read(_CHUNK), b""):
      h.update(block)
  return h.hexdigest()


class MirrorHandler(BaseHTTPRequestHandler):
  server: "_Server"

  def log_message(self, format, *args) -> None:  # noqa: A002 - the base class's name
    pass  # requests are logged in HFMirror.log

  def _json(self, status: int, body) -> None:
    payload = json.dumps(body).encode()
    self.send_response(status)
    self.send_header("Content-Type", "application/json")
    self.send_header("Content-Length", str(len(payload)))
    self.end_headers()
    self.wfile.write(payload)

  def do_GET(self) -> None:  # noqa: N802 - the base class's name
    mirror = self.server.mirror
    path = unquote(self.path.split("?", 1)[0])
    mirror.log.append(("GET", path, {k.lower(): v for k, v in self.headers.items()}))
    if path.startswith("/api/models/"):
      repo, rest = mirror.split_repo(path[len("/api/models/"):], "/tree/")
      if repo is None:
        return self._json(404, {"error": "Repository not found"})
      _rev, _, sub = rest.partition("/")
      return self.list_tree(repo, sub.strip("/"))
    repo, rest = mirror.split_repo(path.lstrip("/"), "/resolve/")
    if repo is None:
      return self._json(404, {"error": "Repository not found"})
    _rev, _, rel = rest.partition("/")
    target = mirror.file(repo, rel)
    if target is None:
      return self._json(404, {"error": "Entry not found"})
    self.send_file(target, rel)

  def list_tree(self, repo: str, sub: str) -> None:
    root = self.server.mirror.repos[repo]
    here = (root / sub).resolve()
    if not here.is_dir() or (here != root and root not in here.parents):
      return self._json(404, {"error": "Entry not found"})
    entries = []
    for p in sorted(here.iterdir()):
      rel = p.relative_to(root).as_posix()
      if p.is_dir():
        entries.append({"type": "directory", "path": rel, "size": 0})
      elif p.is_file():
        entries.append({"type": "file", "path": rel, "size": p.stat().st_size})
    self._json(200, entries)

  def etag_headers(self, target: Path, rel: str) -> Dict[str, str]:
    """The file's hash header, as HF sends it: `X-Linked-ETag` with an LFS file's
    sha256, else `ETag` with its git-blob sha1."""
    lfs = rel.endswith(LFS_SUFFIXES)
    digest = self.server.mirror.hash(target, lfs)
    return {"X-Linked-ETag": f'"{digest}"'} if lfs else {"ETag": f'"{digest}"'}

  def send_file(self, target: Path, rel: str) -> None:
    size = target.stat().st_size
    start = 0
    spec = self.headers.get("Range", "")
    if spec.startswith("bytes=") and spec[6:].split("-")[0].isdigit():
      start = int(spec[6:].split("-")[0])
      if start >= size:
        self.send_response(416)
        self.send_header("Content-Range", f"bytes */{size}")
        self.send_header("Content-Length", "0")
        self.end_headers()
        return
    self.send_response(206 if start else 200)
    for key, value in self.etag_headers(target, rel).items():
      self.send_header(key, value)
    self.send_header("Content-Type", "application/octet-stream")
    self.send_header("Content-Length", str(size - start))
    if start:
      self.send_header("Content-Range", f"bytes {start}-{size - 1}/{size}")
    self.end_headers()
    self.wfile.flush()
    with open(target, "rb") as f:
      self.connection.sendfile(f, start)


class _Server(ThreadingHTTPServer):
  daemon_threads = True
  mirror: "HFMirror"


class HFMirror:
  """`repos` ({"org/name": directory}) served on host:port (0: a free port) from a
  thread of this process; `start()` returns the endpoint's URL."""

  def __init__(self, repos: Dict[str, os.PathLike], host: str = "127.0.0.1", port: int = 0,
               handler=MirrorHandler):
    self.repos = {name: Path(d).resolve() for name, d in repos.items()}
    self.log: List[tuple] = []
    self._hashes: Dict[Path, str] = {}
    self._hash_lock = threading.Lock()
    self._server = _Server((host, port), handler)
    self._server.mirror = self
    self._thread: Optional[threading.Thread] = None

  @property
  def url(self) -> str:
    host, port = self._server.server_address[:2]
    return f"http://{host}:{port}"

  def start(self) -> str:
    self._thread = threading.Thread(target=self._server.serve_forever, name="hf-mirror", daemon=True)
    self._thread.start()
    return self.url

  def stop(self) -> None:
    self._server.shutdown()
    self._server.server_close()
    if self._thread is not None:
      self._thread.join(timeout=5)

  def __enter__(self) -> "HFMirror":
    self.start()
    return self

  def __exit__(self, *exc) -> None:
    self.stop()

  def split_repo(self, path: str, marker: str) -> Tuple[Optional[str], str]:
    """(repo, what follows `marker`) of a request path, or (None, "")."""
    head, sep, rest = path.partition(marker)
    return (head, rest) if sep and head in self.repos else (None, "")

  def file(self, repo: str, rel: str) -> Optional[Path]:
    root = self.repos[repo]
    target = (root / rel).resolve()
    return target if target.is_file() and root in target.parents else None

  def hash(self, path: Path, lfs: bool) -> str:
    with self._hash_lock:
      if path not in self._hashes:
        self._hashes[path] = file_hash(path, lfs)
      return self._hashes[path]

