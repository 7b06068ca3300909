"""JSONL dataset and batcher of the train and eval commands.

The port of xotorch_tpu/train/dataset.py: `{dir}/train.jsonl`, `valid.jsonl` and
`test.jsonl` with a "text" field a line; a batch is the padded token array, its
next-token targets and the true lengths. Batches come in JAX's order: one epoch,
shuffled by `random.Random(seed)`, the last partial batch dropped. The port keeps its
own copy of the data under `xotorch_tpu_torch/train/data/lora` (DEFAULT_DATA, the CLI's
default `--data`).
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

DEFAULT_DATA = str(Path(__file__).resolve().parent / "data" / "lora")


class Dataset:
  def __init__(self, path: Path):
    self.entries: List[str] = []
    if path.exists():
      with open(path) as f:
        for line in f:
          line = line.strip()
          if line:
            self.entries.append(json.loads(line).get("text", ""))

  def __len__(self) -> int:
    return len(self.entries)

  def __getitem__(self, idx: int) -> str:
    return self.entries[idx]


def load_dataset(data_dir: str) -> Tuple[Dataset, Dataset, Dataset]:
  base = Path(data_dir)
  train, valid, test = (Dataset(base / f"{n}.jsonl") for n in ("train", "valid", "test"))
  if len(train) == 0:
    raise ValueError(f"No training data found in {base} (need train.jsonl with 'text' entries)")
  return train, valid, test


def batch_with_lengths(tokens_batch: List[List[int]],
                       max_seq_len: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Pad to the batch's longest (at most max_seq_len) example: (inputs, targets,
  lengths), int64, targets one position ahead, a length at least 1."""
  lengths = [min(len(t), max_seq_len) for t in tokens_batch]
  batch = np.zeros((len(tokens_batch), max(lengths)), dtype=np.int64)
  for i, tokens in enumerate(tokens_batch):
    batch[i, :lengths[i]] = tokens[:lengths[i]]
  return batch[:, :-1], batch[:, 1:], np.asarray([max(n - 1, 1) for n in lengths], dtype=np.int64)


def iterate_batches(dataset: Dataset, tokenizer, batch_size: int, max_seq_len: int,
                    train: bool = True, seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
  """One epoch of batches, shuffled when `train`; warns of examples past max_seq_len."""
  indices = list(range(len(dataset)))
  if train:
    random.Random(seed).shuffle(indices)
  for i in range(0, len(indices) - batch_size + 1, batch_size):
    tokens = [tokenizer.encode(dataset[j]) for j in indices[i:i + batch_size]]
    for t in tokens:
      if len(t) > max_seq_len:
        print(f"Warning: example of length {len(t)} truncated to {max_seq_len}")
    yield batch_with_lengths(tokens, max_seq_len)
