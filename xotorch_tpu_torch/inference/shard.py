"""Shard: the unit of model partitioning — a contiguous layer range.

The port's copy of xotorch_tpu/inference/shard.py: a frozen value type
(model_id, start_layer, end_layer inclusive, n_layers).
"""
from __future__ import annotations

from dataclasses import dataclass, asdict
from typing import Dict


@dataclass(frozen=True)
class Shard:
  model_id: str
  start_layer: int
  end_layer: int
  n_layers: int

  @property
  def is_first_layer(self) -> bool:
    return self.start_layer == 0

  @property
  def is_last_layer(self) -> bool:
    return self.end_layer == self.n_layers - 1

  def get_layer_count(self) -> int:
    return self.end_layer - self.start_layer + 1

  def to_dict(self) -> Dict:
    return asdict(self)

  @classmethod
  def from_dict(cls, data: Dict) -> "Shard":
    return cls(
      model_id=data["model_id"],
      start_layer=int(data["start_layer"]),
      end_layer=int(data["end_layer"]),
      n_layers=int(data["n_layers"]),
    )

  def overlaps(self, other: "Shard") -> bool:
    return self.model_id == other.model_id and max(self.start_layer, other.start_layer) <= min(self.end_layer, other.end_layer)
