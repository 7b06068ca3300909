"""Download progress events: the port's copy of xotorch_tpu/download/download_progress.py."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class RepoFileProgressEvent:
  repo_id: str
  file_path: str
  downloaded: int
  total: int
  speed: float  # bytes/sec
  status: str  # not_started | in_progress | complete

  def to_dict(self) -> Dict:
    return {
      "repo_id": self.repo_id, "file_path": self.file_path, "downloaded": self.downloaded,
      "total": self.total, "speed": self.speed, "status": self.status,
    }


@dataclass
class RepoProgressEvent:
  repo_id: str
  completed_files: int
  total_files: int
  downloaded_bytes: int
  total_bytes: int
  speed: float
  status: str
  file_progress: Dict[str, RepoFileProgressEvent] = field(default_factory=dict)

  @property
  def percentage(self) -> float:
    return 100.0 * self.downloaded_bytes / self.total_bytes if self.total_bytes else 0.0

  @property
  def eta_seconds(self) -> float:
    remaining = self.total_bytes - self.downloaded_bytes
    return remaining / self.speed if self.speed > 0 else float("inf")

  @property
  def is_complete(self) -> bool:
    return self.status == "complete"

  def to_dict(self) -> Dict:
    return {
      "repo_id": self.repo_id, "completed_files": self.completed_files, "total_files": self.total_files,
      "downloaded_bytes": self.downloaded_bytes, "total_bytes": self.total_bytes, "speed": self.speed,
      "status": self.status, "percentage": self.percentage,
      "file_progress": {k: v.to_dict() for k, v in self.file_progress.items()},
    }
