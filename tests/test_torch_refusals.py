"""What the port refuses, and where, on the CPU.

- Kernel shape limits (no CUDA kernel takes them) raise ValueError when the engine
  is built (tile knobs, a page of no position) or when a shard is loaded (head_dim and
  q heads per kv head, which only the model's config knows), never at a launch in the middle
  of a request: the CPU runs the plain versions and would never see them there.
- The chat API serves every request field the JAX package serves (stop, seed, the
  sampling extras, logprobs, n, tools) with the JAX handler's validation: an invalid
  value is answered 400 in the JAX handler's words, naming the field, and the neutral
  values are served as if they were absent: the same greedy stream as a request
  without them.
"""
import asyncio
import json
import urllib.error
import urllib.request

import pytest
import torch

from xotorch_tpu_torch import main as port_main
from xotorch_tpu_torch.api.chatgpt_api import ChatGPTAPI, HTTPError
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
from xotorch_tpu_torch.models import registry
from xotorch_tpu_torch.models.registry import TORCH

torch.set_num_threads(2)

MODEL = "synthetic-tiny"
KNOBS = ("XOT_PAGED_KV", "XOT_KV_PAGE", "XOT_FLASH_BLOCK_Q", "XOT_FLASH_BLOCK_K",
         "XOT_FD_BLOCK_Q", "XOT_FD_BLOCK_K")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
  for name in KNOBS:
    monkeypatch.delenv(name, raising=False)


# ------------------------------------------------------------------ F1: engine build

@pytest.mark.parametrize("env,refusal", [
  ({"XOT_PAGED_KV": "1", "XOT_KV_PAGE": "0"}, "XOT_KV_PAGE=0"),
  ({"XOT_PAGED_KV": "1", "XOT_KV_PAGE": "-8"}, "XOT_KV_PAGE=-8"),
  ({"XOT_FLASH_BLOCK_Q": "32"}, "XOT_FLASH_BLOCK_Q=32"),
  ({"XOT_FLASH_BLOCK_K": "256"}, "XOT_FLASH_BLOCK_K=256"),
  ({"XOT_FD_BLOCK_Q": "256"}, "XOT_FD_BLOCK_Q=256"),
  ({"XOT_FD_BLOCK_Q": "8"}, "XOT_FD_BLOCK_Q=8"),
  ({"XOT_FD_BLOCK_K": "100"}, "XOT_FD_BLOCK_K=100"),
  ({"XOT_FD_BLOCK_K": "32"}, "XOT_FD_BLOCK_K=32"),
])
def test_engine_refuses_kernel_knobs_when_built(monkeypatch, env, refusal):
  for name, value in env.items():
    monkeypatch.setenv(name, value)
  with pytest.raises(ValueError, match=refusal):
    TorchShardInferenceEngine(device="cpu")


@pytest.mark.parametrize("env", [
  {"XOT_PAGED_KV": "1", "XOT_KV_PAGE": "16"},
  {"XOT_PAGED_KV": "0", "XOT_KV_PAGE": "8"},  # no pool, no paged kernel
  {"XOT_PAGED_KV": "1", "XOT_KV_PAGE": "8"},  # K3/K4 take any page, as JAX's pool
  {"XOT_PAGED_KV": "1", "XOT_KV_PAGE": "24"},
  {"XOT_PAGED_KV": "1", "XOT_KV_PAGE": "64"},
  {"XOT_FLASH_BLOCK_Q": "64", "XOT_FLASH_BLOCK_K": "64"},
  {"XOT_FD_BLOCK_Q": "64", "XOT_FD_BLOCK_K": "64"},
  {"XOT_FD_BLOCK_K": "4096"},
])
def test_engine_builds_with_what_the_kernels_take(monkeypatch, env):
  for name, value in env.items():
    monkeypatch.setenv(name, value)
  engine = TorchShardInferenceEngine(device="cpu")
  engine.executor.shutdown(wait=True)


def _card(heads: int, kv_heads: int, head_dim: int) -> dict:
  return {"layers": 2, "repo": {TORCH: "synthetic"}, "synthetic_config": {
    "model_type": "llama", "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": heads, "num_key_value_heads": kv_heads, "head_dim": head_dim,
    "num_hidden_layers": 2, "vocab_size": 256, "max_position_embeddings": 2048,
    "rope_theta": 10000.0, "tie_word_embeddings": False, "eos_token_id": 2}}


@pytest.mark.parametrize("paged,heads,kv_heads,head_dim,refusal", [
  ("0", 4, 2, 48, "head_dim 48"),  # K1/K2 are built for 16, 32, 64, 128, 256
  ("0", 130, 2, 16, "65 q heads per kv head"),  # K2 takes at most 64
  ("1", 4, 2, 48, "head_dim 48"),  # K3/K4 are built for the same head_dims as K1/K2
  ("1", 130, 2, 16, "65 q heads per kv head under XOT_PAGED_KV=1"),  # K3/K4 take K2's 64
])
async def test_shard_load_refuses_shapes_the_kernels_lack(monkeypatch, paged, heads, kv_heads,
                                                          head_dim, refusal):
  monkeypatch.setitem(registry.model_cards, "synthetic-refused", _card(heads, kv_heads, head_dim))
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  monkeypatch.setenv("XOT_KV_PAGE", "16")
  engine = TorchShardInferenceEngine(device="cpu", dtype="float32", seed=0)
  try:
    with pytest.raises(ValueError, match=refusal) as err:
      await engine.ensure_shard(Shard("synthetic-refused", 0, 1, 2))
    assert "synthetic-refused" in str(err.value)
    assert engine.shard is None
  finally:
    engine.executor.shutdown(wait=True)


@pytest.mark.parametrize("paged", ["0", "1"])
async def test_shard_load_takes_the_kernels_shapes(monkeypatch, paged):
  """32 heads over 2 kv heads (16 groups, llama-3.1-405b's) load contiguous; 24 over 2
  (12 groups, mistral-large's, which 64-row K4 blocks cut mid-position) load paged."""
  monkeypatch.setitem(registry.model_cards, "synthetic-taken",
                      _card(24 if paged == "1" else 32, 2, 32 if paged == "0" else 16))
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  monkeypatch.setenv("XOT_KV_PAGE", "16")
  engine = TorchShardInferenceEngine(device="cpu", dtype="float32", seed=0)
  try:
    await engine.ensure_shard(Shard("synthetic-taken", 0, 1, 2))
    assert engine.shard.model_id == "synthetic-taken"
  finally:
    engine.executor.shutdown(wait=True)


# ------------------------------------------------------------------ F2: the API

# An invalid value of each field the JAX package validates (tools it hands to the chat
# template unchecked): (field, the request's fields).
INVALID = [("n", {"n": 0}), ("n", {"n": 9}), ("n", {"n": 1.0}), ("stop", {"stop": ["a"] * 5}),
           ("stop", {"stop": ""}), ("stop", {"stop": ["a", 3]}), ("seed", {"seed": 2 ** 63}),
           ("seed", {"seed": 7.0}), ("min_p", {"min_p": 1.5}),
           ("presence_penalty", {"presence_penalty": 2.5}),
           ("frequency_penalty", {"frequency_penalty": -3}),
           ("logit_bias", {"logit_bias": {"-1": 10}}), ("logit_bias", {"logit_bias": {"5": 101}}),
           ("logprobs", {"logprobs": "yes"}), ("top_logprobs", {"logprobs": True, "top_logprobs": 21}),
           ("top_logprobs", {"top_logprobs": 2})]
# A served value of each field: (the request's fields), parsed unlike the request without it.
SERVED = {"n": {"n": 2}, "stop": {"stop": "\n"}, "seed": {"seed": 0}, "min_p": {"min_p": 0.1},
          "presence_penalty": {"presence_penalty": 0.5}, "frequency_penalty": {"frequency_penalty": -1.0},
          "logit_bias": {"logit_bias": {"5": 10}}, "logprobs": {"logprobs": True},
          "top_logprobs": {"logprobs": True, "top_logprobs": 2},
          "tools": {"tools": [{"type": "function", "function": {"name": "f", "parameters": {}}}]}}
NEUTRAL = {"n": 1, "stop": None, "seed": None, "min_p": 0, "presence_penalty": 0,
           "frequency_penalty": 0.0, "logit_bias": {}, "logprobs": False, "top_logprobs": None,
           "tools": []}


def jax_message(body: dict) -> str:
  """The 400 message of the JAX package's chat handler for `body`."""
  from xotorch_tpu.api.chatgpt_api import ChatGPTAPI as JChatGPTAPI
  from xotorch_tpu.inference.dummy import DummyInferenceEngine
  from xotorch_tpu.orchestration.node import Node as JNode
  from xotorch_tpu.topology.partitioning import RingMemoryWeightedPartitioningStrategy

  class Request:
    async def json(self):
      return body

  async def run():
    node = JNode("jax-api", None, DummyInferenceEngine(), None, None,
                 RingMemoryWeightedPartitioningStrategy())
    resp = await JChatGPTAPI(node, "JAXShardInferenceEngine").handle_post_chat_completions(Request())
    assert resp.status == 400, (body, resp.status)
    return json.loads(resp.body)["error"]["message"]
  return asyncio.run(run())


def test_every_unserved_field_is_listed():
  """Every field the JAX package serves is parsed: a served value changes the parse, and
  every field but tools has an invalid value refused below."""
  assert set(SERVED) == set(NEUTRAL) == {f for f, _ in INVALID} | {"tools"}
  base = {"max_tokens": 4, "temperature": 0}
  for field, fields in SERVED.items():
    without = {k: v for k, v in fields.items() if k != field}
    assert ChatGPTAPI._parse_sampling({**base, **fields}) != \
      ChatGPTAPI._parse_sampling({**base, **without}), field


@pytest.mark.parametrize("field,fields", INVALID, ids=[f"{f}={v!r}"[:40] for f, v in INVALID])
def test_unserved_field_is_answered_400_naming_it(field, fields):
  body = {"model": MODEL, "max_tokens": 4, "messages": [{"role": "user", "content": "hi"}], **fields}
  with pytest.raises(HTTPError) as err:
    ChatGPTAPI._parse_sampling(body)
  assert err.value.status == 400
  error = err.value.body["error"]
  assert error["type"] == "invalid_request_error"
  assert error["message"].startswith(field)
  assert error["message"] == jax_message(body)


@pytest.mark.parametrize("field", sorted(NEUTRAL))
def test_neutral_values_parse_as_absent(field):
  base = {"max_tokens": 4, "temperature": 0}
  assert ChatGPTAPI._parse_sampling({**base, field: NEUTRAL[field]}) == \
    ChatGPTAPI._parse_sampling(base)
  alternatives = {"logprobs": [None], "logit_bias": [None], "min_p": [None, 0.0], "tools": [None],
                  "n": [None], "seed": [None], "presence_penalty": [0.0]}
  for value in alternatives.get(field, []):
    assert ChatGPTAPI._parse_sampling({**base, field: value}) == ChatGPTAPI._parse_sampling(base)
  if field == "top_logprobs":  # with logprobs on, 0 alternatives is the default
    on = {**base, "logprobs": True}
    assert ChatGPTAPI._parse_sampling({**on, "top_logprobs": 0}) == ChatGPTAPI._parse_sampling(on)


def _post(url, body):
  req = urllib.request.Request(url, data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=120) as resp:
    return json.loads(resp.read())


async def test_api_refuses_over_http_and_serves_neutral_values_as_absent():
  args = port_main.build_parser().parse_args(
    ["--device", "cpu", "--default-model", MODEL, "--chatgpt-api-port", "0"])
  node, engine, classname, api = port_main.build_node(args)
  streams = {}
  node.on_token.register("refusals-test").on_next(
    lambda rid, toks, finished: streams.__setitem__(rid, list(toks)))
  server = await api.start("127.0.0.1", 0)
  url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/v1/chat/completions"
  loop = asyncio.get_running_loop()
  post = lambda body: loop.run_in_executor(None, _post, url, body)
  body = {"model": MODEL, "temperature": 0, "max_tokens": 10,
          "messages": [{"role": "user", "content": "one two three four five six"}]}
  try:
    with pytest.raises(urllib.error.HTTPError) as err:
      await post({**body, "n": 9})
    assert err.value.code == 400
    assert json.loads(err.value.read())["error"]["message"] == "n must be an integer in [1, 8], got 9"
    assert not streams  # refused before the node saw it

    plain = await post(body)
    want = streams.pop(plain["id"][len("chatcmpl-"):])
    neutral = await post({**body, **NEUTRAL})
    got = streams.pop(neutral["id"][len("chatcmpl-"):])
    assert len(want) == 10 and got == want
    assert neutral["choices"][0]["message"] == plain["choices"][0]["message"]
    assert neutral["usage"] == plain["usage"]
    # A stop sequence is served: one that never shows leaves the answer whole.
    stopped = await post({**body, "stop": ["four"]})
    assert streams.pop(stopped["id"][len("chatcmpl-"):]) == want
    assert stopped["choices"][0]["message"] == plain["choices"][0]["message"]
    assert stopped["choices"][0]["finish_reason"] == "length"
  finally:
    server.close()
    await server.wait_closed()
    await node.stop()
    engine.executor.shutdown(wait=True)


# ------------------------------------------------------------------ F3 and F4

# What the JAX package's handler makes of each top_p (xotorch_tpu/api/chatgpt_api.py:
# max(0.05, round(top_p * 20) / 20), and a value that snaps to 1 is off).
TOP_P_SNAPS = [(0.97, 0.95), (0.99, None), (0.01, 0.05), (0.5, 0.5), (1, None), (0.26, 0.25)]


@pytest.mark.parametrize("sent,served", TOP_P_SNAPS)
def test_top_p_snaps_to_the_jax_grid(sent, served):
  assert ChatGPTAPI._parse_sampling({"top_p": sent})[2] == served


def _png_data_uri() -> str:
  import base64
  import io
  from PIL import Image
  buf = io.BytesIO()
  Image.new("RGB", (4, 4), (200, 10, 10)).save(buf, format="PNG")
  return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


IMAGE_PARTS = {
  "image": lambda: _png_data_uri(),
  "bad data URI": lambda: "data:image/png;base64,not base64!",
  "not a data URI": lambda: "https://example.invalid/cat.png",
}


@pytest.mark.parametrize("what", sorted(IMAGE_PARTS))
async def test_image_parts_are_answered_400_naming_the_model(what):
  args = port_main.build_parser().parse_args(
    ["--device", "cpu", "--default-model", MODEL, "--chatgpt-api-port", "0"])
  node, engine, classname, api = port_main.build_node(args)
  seen = []
  node.on_token.register("refusals-test").on_next(lambda rid, toks, finished: seen.append(rid))
  server = await api.start("127.0.0.1", 0)
  url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/v1/chat/completions"
  body = {"model": MODEL, "temperature": 0, "max_tokens": 4, "messages": [
    {"role": "user", "content": [{"type": "text", "text": "what is this?"},
                                 {"type": "image_url", "image_url": {"url": IMAGE_PARTS[what]()}}]}]}
  try:
    with pytest.raises(urllib.error.HTTPError) as err:
      await asyncio.get_running_loop().run_in_executor(None, _post, url, body)
    assert err.value.code == 400
    message = json.loads(err.value.read())["error"]["message"]
    assert message.startswith(f"model {MODEL} does not support image input")
    assert (message == f"model {MODEL} does not support image input") == (what == "image")
    assert not seen  # refused before the node saw it
  finally:
    server.close()
    await server.wait_closed()
    await node.stop()
    engine.executor.shutdown(wait=True)
