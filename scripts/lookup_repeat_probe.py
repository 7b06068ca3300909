"""Which prompts make the seeded random-weight synthetic-llama-1b and -8b repeat their
greedy streams, and how prompt lookup (XOT_SPECULATE 8) would fare on each: 256 greedy
tokens a prompt on the card, the Node's lookup rounds simulated on the host from the
plain stream (a draft accepted as far as it matches). Prompts: a 375-word paragraph 4
times, 1500 words that do not repeat, 1500 ones, 64 words, a 5-word phrase 300 times;
then a paragraph followed by its own greedy continuation and again by its head.
`python3 scripts/lookup_repeat_probe.py` (the build, then about 30 s)."""
import asyncio
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XOT_PREFILL_CHUNK", "1024")
os.environ.setdefault("XOT_PREFIX_CACHE", "0")
import numpy as np  # noqa: E402
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine  # noqa: E402
from xotorch_tpu_torch.models.registry import build_full_shard  # noqa: E402
from xotorch_tpu_torch.orchestration.node import _lookup_draft  # noqa: E402


def simulate(prompt, stream, k=8):
  """The Node's lookup rounds over a known greedy stream: (rounds, accepted, drafted)."""
  ctx = list(prompt) + [stream[0]]
  i, rounds, acc, drafted = 1, 0, 0, 0
  strikes = 0
  while i < len(stream):
    d = _lookup_draft(ctx, min(k, len(stream) - i))
    if len(d) >= 2 and strikes < 2:
      n = 0
      while n < len(d) and i + n < len(stream) and d[n] == stream[i + n]:
        n += 1
      got = stream[i:i + n + 1]
      rounds, acc, drafted = rounds + 1, acc + n, drafted + len(d)
      strikes = strikes + 1 if n == 0 else 0
      ctx += got
      i += len(got)
    else:
      ctx.append(stream[i])
      i += 1
  return rounds, acc, drafted


async def main():
  from xotorch_tpu_torch.ops import _build
  _build.load_all(verbose=False)
  for model in ("synthetic-llama-1b", "synthetic-llama-8b"):
    eng = TorchShardInferenceEngine(seed=0)
    shard = build_full_shard(model, "TorchShardInferenceEngine")
    await eng.ensure_shard(shard)
    V = eng._ctx.cfg.vocab_size
    para = cs.kv_ids(90, 375, V)
    prompts = {"paragraph x4": para * 4, "plain": cs.kv_ids(91, 1500, V), "ones": [1] * 1500,
               "short 64": cs.kv_ids(92, 64, V), "phrase x300": cs.kv_ids(95, 5, V) * 300}
    n = 256
    for name, ids in prompts.items():
      tok, _ = await eng.infer_sample_tensor(name, shard, np.asarray([ids]), temp=0.0, top_k=0)
      out = [int(tok)]
      size = 8
      while len(out) < n:
        c = await eng.generate_chunk(name, shard, out[-1], min(size, n - len(out)), temp=0.0, top_k=0)
        out.extend(int(t) for t in np.asarray(c).reshape(-1))
        size = min(size * 2, 64)
      await eng.clear_request(name)
      out = out[:n]
      distinct = len(set(out))
      r, a, d = simulate(ids, out)
      print(f"{model} {name}: distinct {distinct}/{n}; lookup sim rounds {r}, accepted {a}/{d}; "
            f"head {out[:24]}; tail {out[-16:]}", flush=True)
    # The paragraph prompt P, its greedy continuation G, P's last 64 words and G's first m:
    # does the model continue G again, so that the lookup would find it?
    ids = prompts["paragraph x4"]
    tok, _ = await eng.infer_sample_tensor("g", shard, np.asarray([ids]), temp=0.0, top_k=0)
    G = [int(tok)]
    while len(G) < 128:
      c = await eng.generate_chunk("g", shard, G[-1], 8, temp=0.0, top_k=0)
      G.extend(int(t) for t in np.asarray(c).reshape(-1))
    await eng.clear_request("g")
    for m in (4, 32):
      R = ids + G + ids[-64:] + G[:m]
      tok, _ = await eng.infer_sample_tensor("r", shard, np.asarray([R]), temp=0.0, top_k=0)
      out = [int(tok)]
      while len(out) < 64:
        c = await eng.generate_chunk("r", shard, out[-1], 8, temp=0.0, top_k=0)
        out.extend(int(t) for t in np.asarray(c).reshape(-1))
      await eng.clear_request("r")
      same = sum(a == b for a, b in zip(out, G[m:m + 64]))
      r, a, d = simulate(R, out[:64])
      print(f"{model} construction m={m}: continuation equals G[m:] at {same}/64; lookup sim rounds {r}, accepted {a}/{d}", flush=True)
    eng.executor.shutdown(wait=True)
    del eng
    torch.cuda.empty_cache()


if __name__ == "__main__":
  asyncio.run(main())
