"""The port's llava vision path against the JAX package's, on the CPU.

The tiny llava of tests/test_vision_llava.py (`tiny_llava_cfg`, `save_tiny_llava`: a
CLIP tower of 3 layers at width 32 over 28x28 images in 14x14 patches, a GELU
projector, a 3-layer llama text stack), written by `transformers`, loads in both
packages. In fp32 with JAX's matmul precision pinned to 'highest': the config, the
tower's features and the projector within 1e-5, the merged prefill's logits within
1e-4 (what remains is the order of fp32 sums), preprocessing and data-URI decoding
bit for bit. The engines' image requests stream JAX's greedy tokens, contiguous and
paged; the Node samples the first token on the host with the request's extras (a
logprob entry for every token); /v1/chat/completions answers an image request 200
on a vision card, and a text card's 400 stays (tests/test_torch_refusals.py).
"""
import asyncio
import base64
import dataclasses
import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_vision_llava import IMAGE_TOKEN, N_PATCHES, save_tiny_llava, tiny_llava_cfg
from xotorch_tpu.inference.shard import Shard as JShard
from xotorch_tpu.models import transformer as j_transformer
from xotorch_tpu.models import vision as j_vision
from xotorch_tpu.models import weights as j_weights
from xotorch_tpu.models.config import load_model_config as j_load_model_config
from xotorch_tpu_torch.inference.shard import Shard
from xotorch_tpu_torch.models import transformer, vision, weights
from xotorch_tpu_torch.models.config import config_from_hf_dict, load_model_config

torch.set_num_threads(2)

MODEL = "llava"
PRE, POST = [5, 9, 17], [30, 99, 101, 7]


@pytest.fixture(autouse=True)
def _highest_precision():
  with jax.default_matmul_precision("highest"):
    yield


@pytest.fixture(scope="module")
def llava_dir(tmp_path_factory):
  d = tmp_path_factory.mktemp("llava") / "llava"
  d.mkdir()
  save_tiny_llava(d, tiny_llava_cfg(), seed=7)
  return d


def _image(seed=1, shape=(28, 28, 3)):
  return np.random.RandomState(seed).randint(0, 255, shape, dtype=np.uint8)


def _np(t):
  return np.asarray(t)


def test_config_parses_vision_as_jax_does(llava_dir):
  cfg, jcfg = load_model_config(llava_dir), j_load_model_config(llava_dir)
  assert cfg.is_multimodal and cfg.vision.num_patches == N_PATCHES
  assert dataclasses.asdict(cfg.vision) == dataclasses.asdict(jcfg.vision)
  for f in ("image_token_index", "vision_feature_layer", "vision_feature_select",
            "projector_hidden_act", "num_layers", "hidden_size", "vocab_size"):
    assert getattr(cfg, f) == getattr(jcfg, f), f
  quick = config_from_hf_dict({**tiny_llava_cfg(), "projector_hidden_act": "quick_gelu"})
  assert quick.projector_hidden_act == "quick_gelu"


def test_tower_weights_load_as_jax_loads_them(llava_dir):
  cfg, jcfg = load_model_config(llava_dir), j_load_model_config(llava_dir)
  vp, pp = weights.load_vision_tower(llava_dir, cfg, dtype=torch.float32)
  jvp, jpp = j_weights.load_vision_tower(llava_dir, jcfg, dtype=jnp.float32)
  for name, w in vp["layers"].items():
    np.testing.assert_array_equal(w.numpy(), _np(jvp["layers"][name]), err_msg=name)
  for name in ("class_embed", "patch_embed", "pos_embed", "pre_ln_w", "pre_ln_b"):
    np.testing.assert_array_equal(vp[name].numpy(), _np(jvp[name]), err_msg=name)
  for name, w in pp.items():
    np.testing.assert_array_equal(w.numpy(), _np(jpp[name]), err_msg=name)
  # The text stack skips the tower's tensors; a first shard's file list takes them.
  n = cfg.num_layers
  names = list(weights._index_for(llava_dir))
  first = weights.tensor_names_for_shard(names, Shard(MODEL, 0, 1, n), False)
  last = weights.tensor_names_for_shard(names, Shard(MODEL, 2, n - 1, n), False)
  assert any(vision.is_vision_tensor(x) for x in first)
  assert not any(vision.is_vision_tensor(x) for x in last)
  assert first + last == j_weights.tensor_names_for_shard(
    names, JShard(MODEL, 0, 1, n), False) + j_weights.tensor_names_for_shard(
    names, JShard(MODEL, 2, n - 1, n), False)


@pytest.mark.parametrize("feature_layer,select", [(-2, "default"), (-1, "full"), (0, "default")])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_tower_and_projector_match_jax(llava_dir, feature_layer, select, act):
  cfg, jcfg = load_model_config(llava_dir), j_load_model_config(llava_dir)
  vp, pp = weights.load_vision_tower(llava_dir, cfg, dtype=torch.float32)
  jvp, jpp = j_weights.load_vision_tower(llava_dir, jcfg, dtype=jnp.float32)
  pixels = np.random.RandomState(0).randn(2, 3, 28, 28).astype(np.float32)
  feats = vision.encode_images(vp, torch.from_numpy(pixels), cfg.vision, feature_layer, select)
  jfeats = j_vision.encode_images(jvp, jnp.asarray(pixels), jcfg.vision, feature_layer, select)
  np.testing.assert_allclose(feats.numpy(), _np(jfeats), atol=1e-5, rtol=0)
  proj = vision.project_features(pp, feats, act)
  jproj = j_vision.project_features(jpp, jfeats, act)
  np.testing.assert_allclose(proj.numpy(), _np(jproj), atol=1e-5, rtol=0)


def test_merged_prefill_logits_match_jax(llava_dir):
  """Tower, projector, the merge at the <image> placeholder, and the text stack fed
  the merged embeddings from position 0: the logits JAX computes, and the merged
  length is the prompt's plus N - 1."""
  cfg, jcfg = load_model_config(llava_dir), j_load_model_config(llava_dir)
  n = cfg.num_layers
  params = weights.load_shard_params(llava_dir, cfg, Shard(MODEL, 0, n - 1, n), dtype=torch.float32)
  jparams = j_weights.load_shard_params(llava_dir, jcfg, JShard(MODEL, 0, n - 1, n),
                                        dtype=jnp.float32)
  vp, pp = weights.load_vision_tower(llava_dir, cfg, dtype=torch.float32)
  jvp, jpp = j_weights.load_vision_tower(llava_dir, jcfg, dtype=jnp.float32)
  pixels = vision.preprocess_images([_image(1), _image(2, (40, 30, 3))], cfg.vision.image_size)
  ids = np.array(PRE + [IMAGE_TOKEN] + [44] + [IMAGE_TOKEN] + POST, dtype=np.int64)

  feats = vision.project_features(pp, vision.encode_images(vp, torch.from_numpy(pixels),
                                                           cfg.vision), cfg.projector_hidden_act)
  merged = vision.merge_image_features(transformer.embed(params, torch.from_numpy(ids)[None])[0],
                                       ids, feats, IMAGE_TOKEN)
  jfeats = j_vision.project_features(jpp, j_vision.encode_images(jvp, jnp.asarray(pixels),
                                                                 jcfg.vision))
  jmerged = j_vision.merge_image_features(jparams["embed"]["embedding"][ids], ids, jfeats,
                                          IMAGE_TOKEN)
  assert merged.shape[0] == len(ids) + 2 * (N_PATCHES - 1)
  np.testing.assert_allclose(merged.numpy(), _np(jmerged), atol=1e-5, rtol=0)

  cache = transformer.init_kv_cache(cfg, n, 1, 32, torch.float32)
  logits, _ = transformer.forward_shard(params, merged[None], cache, 0, cfg, False, True,
                                        use_flash=True)
  jcache = j_transformer.init_kv_cache(jcfg, n, 1, 32, jnp.float32)
  jlogits, _ = j_transformer.forward_shard(jparams, jmerged[None], jcache, jnp.int32(0), jcfg,
                                           False, True)
  np.testing.assert_allclose(logits.numpy(), _np(jlogits), atol=1e-4, rtol=0)
  with pytest.raises(ValueError, match="2 image placeholders but 1 images"):
    vision.merge_image_features(merged, ids, feats[:1], IMAGE_TOKEN)


def _png_uri(img: np.ndarray) -> str:
  from PIL import Image
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, format="PNG")
  return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("shape", [(28, 28, 3), (64, 192, 3), (192, 64, 3), (56, 56, 4), (30, 50)])
def test_preprocess_and_data_uri_match_jax(shape):
  img = np.random.RandomState(3).randint(0, 255, shape, dtype=np.uint8)
  np.testing.assert_array_equal(vision.preprocess_images([img], 28),
                                j_vision.preprocess_images([img], 28))
  if len(shape) == 3 and shape[-1] == 3:
    uri = _png_uri(img)
    np.testing.assert_array_equal(vision.decode_image_data_uri(uri),
                                  j_vision.decode_image_data_uri(uri))
  for bad in ("https://example.invalid/x.png", "data:image/png;base64", "data:,not base64!",
              "data:image/png;base64," + base64.b64encode(b"not an image").decode()):
    with pytest.raises(ValueError) as ours:
      vision.decode_image_data_uri(bad)
    with pytest.raises(ValueError) as theirs:
      j_vision.decode_image_data_uri(bad)
    assert str(ours.value).split(":")[0] == str(theirs.value).split(":")[0]


# ------------------------------------------------------------------ the engine

class _StubTokenizer:
  """A fixed prompt with one <image> placeholder (test_vision_llava's)."""
  eos_token_id = 2

  def encode(self, prompt):
    return PRE + [IMAGE_TOKEN] + POST

  def decode(self, tokens):
    return " ".join(str(t) for t in tokens)


def _port_engine(llava_dir):
  from xotorch_tpu_torch.download.shard_download import LocalShardDownloader
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  return TorchShardInferenceEngine(LocalShardDownloader({MODEL: llava_dir}), device="cpu", seed=0)


def _jax_engine(llava_dir):
  from xotorch_tpu.download.shard_download import LocalShardDownloader
  from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
  return JAXShardInferenceEngine(LocalShardDownloader({MODEL: llava_dir}), dtype="float32")


async def _image_stream(eng, shard, rid, n=10):
  await eng.ensure_shard(shard)
  if isinstance(shard, Shard):
    eng._ctx.tokenizer = _StubTokenizer()  # the port's contexts hold their tokenizer
  else:
    eng.tokenizer = _StubTokenizer()
  logits, _ = await eng.infer_prompt(rid, shard, "ignored", images=[_image(1)])
  out = [int(np.asarray(await eng.sample(logits, temp=0.0, top_k=0)).reshape(-1)[0])]
  size = 2
  while len(out) < n:
    chunk = await eng.generate_chunk(rid, shard, out[-1], min(size, n - len(out)), temp=0.0, top_k=0)
    out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
    size *= 2
  return np.asarray(logits), out[:n]


@pytest.fixture()
def engine_env(monkeypatch):
  for name, value in (("XOT_DTYPE", "float32"), ("XOT_CACHE_LEN", "16"), ("XOT_KV_PAGE", "16"),
                      ("XOT_KV_POOL_TOKENS", "256")):
    monkeypatch.setenv(name, value)


@pytest.mark.parametrize("paged", ["0", "1"], ids=["contiguous", "paged"])
async def test_engine_image_request_streams_jax(llava_dir, engine_env, monkeypatch, paged):
  """infer_prompt with an image: the merged prefill's logits within 1e-4 of the JAX
  engine's (positioned for decode after the merged length), then greedy decode chunks
  stream JAX's tokens; under XOT_PAGED_KV the contiguous prefill state moves to pool
  pages at its first chunk, as in JAX."""
  cfg = load_model_config(llava_dir)
  n = cfg.num_layers
  jeng = _jax_engine(llava_dir)
  jlogits, want = await _image_stream(jeng, JShard(MODEL, 0, n - 1, n), "mm")
  monkeypatch.setenv("XOT_PAGED_KV", paged)
  eng = _port_engine(llava_dir)
  shard = Shard(MODEL, 0, n - 1, n)
  logits, got = await _image_stream(eng, shard, "mm")
  assert logits.shape == jlogits.shape == (1, len(PRE) + N_PATCHES + len(POST), cfg.vocab_size)
  np.testing.assert_allclose(logits, jlogits, atol=1e-4, rtol=0)
  assert got == want
  state = eng._ctx.states["mm"]
  assert state.pos == logits.shape[1] + len(got) - 1
  assert (state.pages is not None) == (paged == "1")
  with pytest.raises(ValueError, match="1 image placeholders but 2 images"):
    await eng.infer_prompt("mm2", shard, "ignored", images=[_image(1), _image(2)])
  for e in (jeng, eng):
    e.executor.shutdown(wait=True)


async def test_text_card_engine_refuses_images(engine_env):
  """A text model's engine raises for images (JAX's defense in depth), and the base
  class of an engine with no vision path keeps raising."""
  from xotorch_tpu_torch.inference.dummy import DummyInferenceEngine
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  eng = TorchShardInferenceEngine(device="cpu", seed=0)
  with pytest.raises(ValueError, match="does not support image input"):
    await eng.infer_prompt("t", Shard("synthetic-tiny", 0, 3, 4), "hi", images=[_image(1)])
  with pytest.raises(ValueError, match="has no vision path"):
    await DummyInferenceEngine().infer_prompt("t", Shard("dummy", 0, 7, 8), "hi", images=[_image(1)])
  eng.executor.shutdown(wait=True)


# ------------------------------------------------------------- the Node and the API

def _word_tokenizer(model_dir, vocab_size):
  """A word-level tokenizer over the whole vocabulary with `<image>` as one special
  token at IMAGE_TOKEN (what a llava checkpoint's tokenizer makes of it)."""
  special = {"<unk>": 0, "<s>": 1, "</s>": 2, "<image>": IMAGE_TOKEN}
  vocab = dict(special)
  words = [w for w in ("user", "assistant", ":", "what", "is", "this", "?")]
  free = (i for i in range(3, vocab_size) if i not in special.values())
  vocab.update((w, next(free)) for w in words)
  for i in free:
    vocab[f"t{i}"] = i
  (model_dir / "tokenizer.json").write_text(json.dumps({
    "version": "1.0", "truncation": None, "padding": None, "normalizer": None,
    "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": False, "special": True}
                     for t, i in special.items()],
    "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None, "decoder": None,
    "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}))
  (model_dir / "tokenizer_config.json").write_text(json.dumps({
    "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>", "eos_token": "</s>",
    "unk_token": "<unk>", "model_max_length": 128}))


@pytest.fixture()
def served_llava(llava_dir, tmp_path, monkeypatch, engine_env):
  """The tiny llava as a registry card with "vision": True, seeded in XOT_HOME with a
  word-level tokenizer."""
  import shutil
  from xotorch_tpu_torch.models import registry
  home = tmp_path / "home"
  model_dir = home / "models" / "test--tiny-llava"
  shutil.copytree(llava_dir, model_dir)
  _word_tokenizer(model_dir, load_model_config(llava_dir).vocab_size)
  monkeypatch.setenv("XOT_HOME", str(home))
  n = load_model_config(llava_dir).num_layers
  monkeypatch.setitem(registry.model_cards, "tiny-llava",
                      {"layers": n, "repo": {registry.TORCH: "test/tiny-llava"}, "vision": True})
  return model_dir


def _post(url, body):
  req = urllib.request.Request(url, data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=120) as resp:
    return json.loads(resp.read())


async def test_chat_completion_with_an_image_on_a_vision_card(served_llava):
  """An image_url part on the vision card: 200, its <image> placeholder one token of
  the prompt, the image through the Node to the engine's multimodal prefill, a host
  sample of the first token, then the decode chunks; the streamed tokens are the JAX
  engine's greedy stream for the same prompt and image, with a logprob entry for every
  token whose top pick is that token (the host sample recorded the first)."""
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.api.chatgpt_api import build_prompt
  args = port_main.build_parser().parse_args(
    ["--device", "cpu", "--default-model", "tiny-llava", "--chatgpt-api-port", "0"])
  node, engine, classname, api = port_main.build_node(args)
  tokens = {}
  node.on_token.register("vision-test").on_next(
    lambda rid, toks, finished: tokens.__setitem__(rid, list(toks)))
  img = _image(5, (40, 60, 3))
  messages = [{"role": "user", "content": [
    {"type": "text", "text": "what is this ?"},
    {"type": "image_url", "image_url": {"url": _png_uri(img)}}]}]
  body = {"model": "tiny-llava", "temperature": 0, "max_tokens": 6, "logprobs": True,
          "top_logprobs": 2, "messages": messages}
  server = await api.start("127.0.0.1", 0)
  url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/v1/chat/completions"
  try:
    resp = await asyncio.get_running_loop().run_in_executor(None, _post, url, body)
    prompt = build_prompt(engine._ctx.tokenizer, messages)
    ids = engine._ctx.tokenizer.encode(prompt)
  finally:
    server.close()
    await server.wait_closed()
    await node.stop()
    engine.executor.shutdown(wait=True)
  assert resp["choices"][0]["finish_reason"] == "length"
  assert resp["usage"]["completion_tokens"] == 6
  assert list(ids).count(IMAGE_TOKEN) == 1
  (streamed,) = tokens.values()
  entries = resp["choices"][0]["logprobs"]["content"]
  assert len(entries) == 6
  for entry in entries:
    assert entry["top_logprobs"][0]["logprob"] == entry["logprob"]

  from xotorch_tpu.download.shard_download import LocalShardDownloader
  from xotorch_tpu.inference.jax_engine.engine import JAXShardInferenceEngine
  n = load_model_config(served_llava).num_layers
  jeng = JAXShardInferenceEngine(LocalShardDownloader({MODEL: served_llava}), dtype="float32")
  jshard = JShard(MODEL, 0, n - 1, n)
  await jeng.ensure_shard(jshard)
  logits, _ = await jeng.infer_prompt("j", jshard, prompt, images=[img])
  want = [int(np.asarray(logits)[0, -1].argmax())]
  chunk = await jeng.generate_chunk("j", jshard, want[-1], 5, temp=0.0, top_k=0)
  want.extend(int(t) for t in np.asarray(chunk).reshape(-1))
  jeng.executor.shutdown(wait=True)
  assert streamed[:6] == want


async def test_undecodable_image_on_a_vision_card_is_400_with_the_reason(served_llava):
  """On a vision card an undecodable data URI is answered 400 with the decoder's reason
  (JAX's message), before the node sees the request."""
  from xotorch_tpu_torch import main as port_main
  args = port_main.build_parser().parse_args(
    ["--device", "cpu", "--default-model", "tiny-llava", "--chatgpt-api-port", "0"])
  node, engine, classname, api = port_main.build_node(args)
  server = await api.start("127.0.0.1", 0)
  url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/v1/chat/completions"
  body = {"model": "tiny-llava", "max_tokens": 2, "messages": [{"role": "user", "content": [
    {"type": "image_url", "image_url": {"url": "data:image/png;base64,not base64!"}}]}]}
  try:
    with pytest.raises(urllib.error.HTTPError) as err:
      await asyncio.get_running_loop().run_in_executor(None, _post, url, body)
  finally:
    server.close()
    await server.wait_closed()
    await node.stop()
    engine.executor.shutdown(wait=True)
  assert err.value.code == 400
  assert json.loads(err.value.read())["error"]["message"].startswith("invalid base64 image payload")


async def test_images_ride_the_tcp_ring_to_layer_zeros_owner(served_llava, tmp_path):
  """Two port peers over TCP hold the tiny llava's text layers 0-1 (with the tower) and
  2; a prompt with an image sent to the peer of layer 2 is forwarded with its image
  (send_prompt's image_i tensors) to layer 0's owner, whose multimodal prefill's hidden
  states cross the hop; the greedy stream is the single peer's."""
  from tests.test_torch_ring import Ring
  from xotorch_tpu_torch import main as port_main
  n = load_model_config(served_llava).num_layers
  img = _image(5, (40, 60, 3))
  base = Shard("tiny-llava", 0, 0, n)

  async def generate(node, rid):
    done, out = asyncio.Event(), {}

    def on_token(r, toks, finished):
      if r == rid:
        out["tokens"] = list(toks)
        if finished:
          done.set()
    node.on_token.register(f"test-{rid}").on_next(on_token)
    await node.process_prompt(base, "what is this <image>", rid, images=[img], max_tokens=6,
                              temperature=0.0)
    await asyncio.wait_for(done.wait(), 120)
    return out["tokens"], node.request_errors.pop(rid, None)

  args = port_main.build_parser().parse_args(["--device", "cpu", "--default-temp", "0"])
  solo, engine, _, _ = port_main.build_node(args)
  try:
    want, error = await generate(solo, "solo")
  finally:
    await solo.stop()
    engine.executor.shutdown(wait=True)
  assert error is None and len(want) == 6
  ring = await Ring(tmp_path, ["node-b", "node-a"]).start()
  try:
    first, second = ring.nodes["node-b"], ring.nodes["node-a"]
    assert first.get_current_shard(base).is_first_layer
    assert not second.get_current_shard(base).is_first_layer
    assert await generate(second, "forwarded") == (want, None)
  finally:
    await ring.stop()


def test_downloader_sends_the_tower_with_the_first_shard(llava_dir):
  """The offline downloader's file filter: the tower's and projector's files go with the
  first shard whatever its layer range, and with no other shard."""
  from xotorch_tpu_torch.download.hf_shard_download import get_allow_patterns
  n = load_model_config(llava_dir).num_layers
  weight_map = {name: ("vision.safetensors" if vision.is_vision_tensor(name) else f"text-{name}")
                for name in weights._index_for(llava_dir)}
  assert "vision.safetensors" in get_allow_patterns(weight_map, Shard(MODEL, 0, 0, n))
  assert "vision.safetensors" not in get_allow_patterns(weight_map, Shard(MODEL, 1, n - 1, n))
