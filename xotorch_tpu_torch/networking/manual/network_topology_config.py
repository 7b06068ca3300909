"""The manual topology config: which peers exist, where, and what they hold.

The port's copy of xotorch_tpu/networking/manual/network_topology_config.py, with the
same JSON schema, validated by hand where the JAX package uses pydantic (whose lax
mode it follows: an int field takes an integral float or a numeric string, a float
field a numeric string, a str field only a string; unknown keys are ignored):

  {"peers": {"<node id>": {"address": str, "port": int,
                           "device_capabilities": {"model": str, "chip": str, "memory": int,
                                                   "flops": {"fp32": float, "fp16": float,
                                                             "int8": float}}}}}

A file that does not parse or does not match raises ValueError naming the path.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict

from xotorch_tpu_torch.topology.device_capabilities import DeviceCapabilities, DeviceFlops


def _str(value: Any, where: str) -> str:
  if not isinstance(value, str):
    raise ValueError(f"{where}: expected a string, got {value!r}")
  return value


def _int(value: Any, where: str) -> int:
  if isinstance(value, int):
    return int(value)
  if isinstance(value, float) and value.is_integer():
    return int(value)
  if isinstance(value, str):
    try:
      return int(value.strip())
    except ValueError:
      pass
  raise ValueError(f"{where}: expected an integer, got {value!r}")


def _float(value: Any, where: str) -> float:
  if isinstance(value, (int, float)):
    return float(value)
  if isinstance(value, str):
    try:
      return float(value.strip())
    except ValueError:
      pass
  raise ValueError(f"{where}: expected a number, got {value!r}")


def _obj(value: Any, where: str, keys) -> Dict[str, Any]:
  if not isinstance(value, dict):
    raise ValueError(f"{where}: expected an object, got {value!r}")
  missing = [k for k in keys if k not in value]
  if missing:
    raise ValueError(f"{where}: missing {', '.join(missing)}")
  return value


@dataclass(frozen=True)
class PeerConfig:
  address: str
  port: int
  device_capabilities: DeviceCapabilities

  @classmethod
  def from_dict(cls, data: Any, where: str) -> "PeerConfig":
    data = _obj(data, where, ("address", "port", "device_capabilities"))
    caps = _obj(data["device_capabilities"], f"{where}.device_capabilities",
                ("model", "chip", "memory", "flops"))
    flops = _obj(caps["flops"], f"{where}.device_capabilities.flops", ("fp32", "fp16", "int8"))
    at = f"{where}.device_capabilities"
    return cls(
      address=_str(data["address"], f"{where}.address"),
      port=_int(data["port"], f"{where}.port"),
      device_capabilities=DeviceCapabilities(
        model=_str(caps["model"], f"{at}.model"), chip=_str(caps["chip"], f"{at}.chip"),
        memory=_int(caps["memory"], f"{at}.memory"),
        flops=DeviceFlops(**{k: _float(flops[k], f"{at}.flops.{k}") for k in ("fp32", "fp16", "int8")}),
      ),
    )


@dataclass(frozen=True)
class NetworkTopology:
  peers: Dict[str, PeerConfig]

  @classmethod
  def from_path(cls, path: str) -> "NetworkTopology":
    try:
      with open(path, "r") as f:
        config_data = f.read()
    except FileNotFoundError as e:
      raise FileNotFoundError(f"Config file not found at {path}") from e
    try:
      data = _obj(json.loads(config_data), "config", ("peers",))
      peers = _obj(data["peers"], "peers", ())
      return cls({str(k): PeerConfig.from_dict(v, f"peers.{k}") for k, v in peers.items()})
    except (json.JSONDecodeError, ValueError) as e:
      raise ValueError(f"Error validating network topology config from {path}: {e}") from e
