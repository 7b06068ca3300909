"""The download routes, the image route and the web UI of the port's API against the
JAX package's aiohttp handlers, on the same inputs: POST /download and /v1/download,
GET /v1/download/progress, DELETE /models/{name} and /v1/models/{name}, POST
/v1/image/generations, GET / and /static. Each side's node has its own downloader and
XOT_HOME and fetches from one local HF endpoint (download/hf_mirror.py); the status
and the JSON body must be equal (a download's speed aside). The page the port serves
is the JAX package's byte for byte, a path out of its directory is refused, and every
URL the page fetches reaches a route of the port's router (test_tinychat.py's rule).
"""
import asyncio
import http.client
import json
import re
import time
from pathlib import Path

import numpy as np
import pytest

from xotorch_tpu.download import hf_shard_download as j_hf
from xotorch_tpu.download.shard_download import LocalShardDownloader as JLocalShardDownloader
from xotorch_tpu.models import registry as j_registry
from xotorch_tpu_torch.api.chatgpt_api import ChatGPTAPI, WEB_DIR
from xotorch_tpu_torch.download import hf_shard_download as hf
from xotorch_tpu_torch.download.hf_mirror import HFMirror
from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
from xotorch_tpu_torch.inference.dummy import DummyInferenceEngine
from xotorch_tpu_torch.main import wire_events
from xotorch_tpu_torch.models import registry
from xotorch_tpu_torch.orchestration.node import Node
from xotorch_tpu_torch.topology.partitioning import RingMemoryWeightedPartitioningStrategy

ROOT = Path(__file__).resolve().parent.parent
TORCH, JAX = "TorchShardInferenceEngine", "JAXShardInferenceEngine"
REPO, CARD, NODE_ID = "test/tiny-routes", "tiny-routes", "routes-node"
PAGE = ROOT / "xotorch_tpu" / "tinychat" / "index.html"


@pytest.fixture()
def repo(tmp_path, monkeypatch):
  rng = np.random.default_rng(31)
  src = tmp_path / "src"
  src.mkdir()
  (src / "model.safetensors").write_bytes(rng.integers(0, 256, 3 << 19, dtype=np.uint8).tobytes())
  (src / "config.json").write_text("{}")
  (src / "tokenizer.json").write_text("{}")
  monkeypatch.setitem(registry.model_cards, CARD, {"layers": 2, "repo": {TORCH: REPO}})
  monkeypatch.setitem(j_registry.model_cards, CARD, {"layers": 2, "repo": {JAX: REPO}})
  return src


class _Jax:
  """JAX's handlers behind an aiohttp test client, on a node with `downloader`."""

  def __init__(self, downloader):
    self.downloader = downloader

  async def __aenter__(self):
    from aiohttp.test_utils import TestClient, TestServer
    from xotorch_tpu import main as j_main
    from xotorch_tpu.api.chatgpt_api import ChatGPTAPI as JChatGPTAPI
    from xotorch_tpu.inference.dummy import DummyInferenceEngine as JDummy
    from xotorch_tpu.orchestration.node import Node as JNode
    from xotorch_tpu.topology.partitioning import RingMemoryWeightedPartitioningStrategy as JRing
    engine = JDummy()
    self.node = JNode(NODE_ID, None, engine, None, self.downloader, JRing())
    if self.downloader is not None:
      j_main._wire_events(self.node, engine, JAX, None, self.downloader)
    self.client = TestClient(TestServer(JChatGPTAPI(self.node, JAX).app))
    await self.client.start_server()
    return self

  async def __aexit__(self, *exc):
    await self.client.close()

  async def call(self, method, path, body=None):
    resp = await self.client.request(method, path, data=None if body is None else json.dumps(body))
    raw = await resp.read()
    return resp.status, raw, resp.headers.get("Content-Type", "")


class _Port:
  """The port's API on a loopback port, on a node with `downloader`."""

  def __init__(self, downloader):
    self.downloader = downloader

  async def __aenter__(self):
    engine = DummyInferenceEngine()
    self.node = Node(NODE_ID, None, engine, None, RingMemoryWeightedPartitioningStrategy(),
                     shard_downloader=self.downloader)
    if self.downloader is not None:
      wire_events(self.node, engine, self.downloader)
    self.server = await ChatGPTAPI(self.node, TORCH).start("127.0.0.1", 0)
    self.port = self.server.sockets[0].getsockname()[1]
    return self

  async def __aexit__(self, *exc):
    self.server.close()
    await self.server.wait_closed()

  def _call(self, method, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=30)
    try:
      conn.request(method, path, body=None if body is None else json.dumps(body))
      resp = conn.getresponse()
      return resp.status, resp.read(), resp.getheader("Content-Type", "")
    finally:
      conn.close()

  async def call(self, method, path, body=None):
    return await asyncio.get_running_loop().run_in_executor(None, self._call, method, path, body)


async def _both(sides, method, path, body=None):
  out = []
  for side in sides:
    status, raw, _ = await side.call(method, path, body)
    out.append((status, json.loads(raw)))
  assert out[0] == out[1], (method, path, out)
  return out[0]


def _without_speed(progress):
  """A progress body with its run-dependent speeds taken out."""
  out = json.loads(json.dumps(progress))
  for p in out.values():
    p.pop("speed", None)
    for f in p.get("file_progress", {}).values():
      f.pop("speed", None)
  return out


async def _until_complete(side, timeout=30.0):
  """The progress body once it reads complete over all three files (an event counts
  the files that have reported so far, in both packages)."""
  deadline = time.monotonic() + timeout
  while time.monotonic() < deadline:
    status, raw, _ = await side.call("GET", "/v1/download/progress")
    body = json.loads(raw)
    mine = body.get(NODE_ID, {})
    if status == 200 and mine.get("status") == "complete" and len(mine.get("file_progress", {})) == 3:
      return body
    await asyncio.sleep(0.05)
  raise AssertionError(f"no complete progress: {body}")


async def test_download_progress_and_delete_match_jax(repo, tmp_path, monkeypatch):
  with HFMirror({REPO: repo}) as mirror:
    monkeypatch.setenv("HF_ENDPOINT", mirror.url)
    bodies = {}
    for name in ("jax", "port"):
      monkeypatch.setenv("XOT_HOME", str(tmp_path / name))
      dl = j_hf.HFShardDownloader() if name == "jax" else hf.HFShardDownloader()
      async with (_Jax if name == "jax" else _Port)(dl) as side:
        got = [await side.call("GET", "/v1/download/progress")]
        for path in ("/download", "/v1/download"):
          got.append(await side.call("POST", path, {"model": "no-such-model"}))
          got.append(await side.call("POST", path, {"model": "dummy"}))  # another engine's card
        got.append(await side.call("POST", "/v1/download", {"model": CARD}))
        progress = await _until_complete(side)
        got.append(await side.call("GET", "/v1/download/progress"))
        target = tmp_path / name / "models" / "test--tiny-routes"
        assert (target / "model.safetensors").read_bytes() == (repo / "model.safetensors").read_bytes()
        for path in (f"/v1/models/{CARD}@fin", f"/v1/models/{CARD}", f"/models/{CARD}",
                     f"/models/{CARD}", "/v1/models/no-such-model"):
          got.append(await side.call("DELETE", path))
        assert not target.exists()
        bodies[name] = ([(s, json.loads(raw)) for s, raw, _ in got], _without_speed(progress))
  port, jax_ = bodies["port"], bodies["jax"]
  progress = 6  # the progress read after the download: its speeds differ by run
  assert port[0][:progress] + port[0][progress + 1:] == jax_[0][:progress] + jax_[0][progress + 1:]
  assert _without_speed(port[0][progress][1]) == _without_speed(jax_[0][progress][1])
  assert port[1] == jax_[1]
  assert [s for s, _ in port[0]] == [200, 400, 400, 400, 400, 200, 200, 400, 200, 404, 404, 404]


@pytest.mark.parametrize("downloader", ["none", "local"])
async def test_download_routes_without_a_downloader_match_jax(repo, downloader):
  """No downloader: a download answers 503, a delete 400; a downloader that cannot
  delete: the delete answers 400."""
  dls = (None, None) if downloader == "none" else (JLocalShardDownloader(), LocalShardDownloader())
  async with _Jax(dls[0]) as j, _Port(dls[1]) as p:
    if downloader == "none":
      assert await _both((j, p), "POST", "/v1/download", {"model": CARD}) == (
        503, {"detail": "No shard downloader configured on this node"})
      assert await _both((j, p), "DELETE", f"/v1/models/{CARD}") == (400, {"detail": "No downloader"})
    else:
      assert await _both((j, p), "DELETE", f"/models/{CARD}") == (
        400, {"detail": "Downloader cannot delete"})
    assert (await _both((j, p), "DELETE", f"/v1/models/{CARD}@a"))[0] == 400
    assert await _both((j, p), "POST", "/v1/image/generations", {"prompt": "a cat"}) == (
      501, {"error": {"type": "invalid_request_error",
                      "message": "image generation is not supported: no diffusion model family "
                                 "is registered (text and vision-language models only)"}})


async def test_web_ui_is_jaxs_page_and_stays_in_its_directory():
  assert (WEB_DIR / "index.html").read_bytes() == PAGE.read_bytes()
  async with _Jax(None) as j, _Port(None) as p:
    jstatus, jraw, _ = await j.call("GET", "/")
    for path in ("/", "/static/index.html", "/static/./index.html"):
      status, raw, ctype = await p.call("GET", path)
      assert (status, raw) == (jstatus, jraw) == (200, PAGE.read_bytes()), path
      assert ctype == "text/html; charset=utf-8"
    for path in ("/static/../api/chatgpt_api.py", "/static/%2e%2e/api/http.py",
                 "/static/..%2fapi%2fhttp.py", "/static/%2Fetc%2Fpasswd", "/static//etc/passwd",
                 "/static/..\\api\\http.py"):
      status, raw, _ = await p.call("GET", path)
      assert status == 403 and json.loads(raw) == {"detail": "forbidden path"}, path
    status, _, _ = await p.call("GET", "/static/missing.js")
    assert status == 404


def _fetches(html: str):
  """(method, path) of every fetch() of the page: the options' method, else POST when
  they carry a body, else GET; a path built by `+` ends in "{tail}"."""
  out = set()
  for m in re.finditer(r"fetch\(\s*\"(/[^\"?]*)\"(\s*\+\s*[\w.]+(?:\([^)]*\))?)?\s*(?:,\s*\{([^}]*))?", html):
    path, tail, opts = m.group(1), m.group(2), m.group(3) or ""
    method = re.search(r"method:\s*\"(\w+)\"", opts)
    out.add((method.group(1) if method else "POST" if "body" in opts else "GET",
             path + ("{tail}" if tail else "")))
  return out


async def test_every_url_the_page_fetches_is_a_route(repo):
  """test_tinychat.py's rule on the port's router: each fetched URL, with the method the
  page uses, reaches a handler (never the router's own 404)."""
  fetched = _fetches(PAGE.read_text())
  assert {("GET", "/v1/download/progress"), ("POST", "/v1/download"),
          ("DELETE", "/v1/models/{tail}"), ("POST", "/v1/chat/completions")} <= fetched
  async with _Port(LocalShardDownloader()) as p:
    for method, path in sorted(fetched):
      body = {"model": "no-such-model", "messages": []} if method == "POST" else None
      status, raw, _ = await p.call(method, path.replace("{tail}", "no-such-model"), body)
      detail = json.loads(raw).get("detail", "") if raw.startswith(b"{") else ""
      assert not str(detail).startswith("no route"), (method, path, status, raw[:200])
