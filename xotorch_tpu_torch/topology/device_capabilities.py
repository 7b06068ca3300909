"""Device capability probing for a peer of the ring.

The port's copy of xotorch_tpu/topology/device_capabilities.py: `DeviceFlops`,
`DeviceCapabilities` (with its dict form for the wire), `UNKNOWN_DEVICE_CAPABILITIES`,
the chip table's NVIDIA rows, `lookup_chip_flops` and the async, cached
`device_capabilities()`. The torch-CUDA probe is the primary path here (the JAX
package probes JAX first and falls back to it), then the host. Memory is reported in
MB of accelerator memory, which the ring partitioning strategy weights by.
"""
from __future__ import annotations

import asyncio
import os
import platform
import threading
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional

from xotorch_tpu_torch.utils import knobs
from xotorch_tpu_torch.utils.helpers import DEBUG

TFLOPS = 1.00


@dataclass(frozen=True)
class DeviceFlops:
  # units of TFLOPS
  fp32: float
  fp16: float
  int8: float

  def to_dict(self) -> Dict[str, float]:
    return asdict(self)


@dataclass
class DeviceCapabilities:
  model: str
  chip: str
  memory: int  # MB of accelerator or host memory
  flops: DeviceFlops
  num_devices: int = 1
  ici_topology: Optional[List[int]] = None  # the JAX package's TPU mesh shape; None on GPUs

  def __str__(self) -> str:
    return (
      f"Model: {self.model}. Chip: {self.chip}. Memory: {self.memory}MB. "
      f"Flops: fp32 {self.flops.fp32:.2f} TFLOPS, fp16/bf16 {self.flops.fp16:.2f} TFLOPS, int8 {self.flops.int8:.2f} TFLOPS"
    )

  def to_dict(self) -> Dict[str, Any]:
    d = asdict(self)
    d["flops"] = self.flops.to_dict()
    return d

  @classmethod
  def from_dict(cls, data: Dict[str, Any]) -> "DeviceCapabilities":
    flops = data.get("flops", {})
    return cls(
      model=data.get("model", "Unknown Model"),
      chip=data.get("chip", "Unknown Chip"),
      memory=int(data.get("memory", 0)),
      flops=DeviceFlops(
        fp32=float(flops.get("fp32", 0)), fp16=float(flops.get("fp16", 0)), int8=float(flops.get("int8", 0))
      ),
      num_devices=int(data.get("num_devices", 1)),
      ici_topology=data.get("ici_topology"),
    )


UNKNOWN_DEVICE_CAPABILITIES = DeviceCapabilities(
  model="Unknown Model", chip="Unknown Chip", memory=0, flops=DeviceFlops(fp32=0, fp16=0, int8=0)
)

# Public dense peaks (no sparsity) of NVIDIA chips, from the vendor's data sheets;
# fp16 is the chip's preferred half precision (bf16 where native). Matching is a
# case-insensitive substring both ways (lookup_chip_flops), so
# "NVIDIA H100 80GB HBM3" hits "NVIDIA H100".
GPU_CHIP_FLOPS: Dict[str, DeviceFlops] = {
  # datacenter
  "NVIDIA B200": DeviceFlops(fp32=80.0 * TFLOPS, fp16=2250.0 * TFLOPS, int8=4500.0 * TFLOPS),
  "NVIDIA H200": DeviceFlops(fp32=67.0 * TFLOPS, fp16=989.0 * TFLOPS, int8=1979.0 * TFLOPS),
  "NVIDIA H100": DeviceFlops(fp32=67.0 * TFLOPS, fp16=989.0 * TFLOPS, int8=1979.0 * TFLOPS),
  "NVIDIA A100": DeviceFlops(fp32=19.5 * TFLOPS, fp16=312.0 * TFLOPS, int8=624.0 * TFLOPS),
  "NVIDIA A10": DeviceFlops(fp32=31.2 * TFLOPS, fp16=125.0 * TFLOPS, int8=250.0 * TFLOPS),
  "NVIDIA L40S": DeviceFlops(fp32=91.6 * TFLOPS, fp16=366.0 * TFLOPS, int8=733.0 * TFLOPS),
  "NVIDIA L4": DeviceFlops(fp32=30.3 * TFLOPS, fp16=121.0 * TFLOPS, int8=242.0 * TFLOPS),
  "NVIDIA V100": DeviceFlops(fp32=15.7 * TFLOPS, fp16=125.0 * TFLOPS, int8=62.8 * TFLOPS),
  "NVIDIA T4": DeviceFlops(fp32=8.1 * TFLOPS, fp16=65.0 * TFLOPS, int8=130.0 * TFLOPS),
  "NVIDIA P100": DeviceFlops(fp32=9.3 * TFLOPS, fp16=18.7 * TFLOPS, int8=9.3 * TFLOPS),
  "RTX A6000": DeviceFlops(fp32=38.7 * TFLOPS, fp16=155.0 * TFLOPS, int8=310.0 * TFLOPS),
  # consumer
  "RTX 5090": DeviceFlops(fp32=104.8 * TFLOPS, fp16=209.6 * TFLOPS, int8=838.0 * TFLOPS),
  "RTX 4090": DeviceFlops(fp32=82.6 * TFLOPS, fp16=165.2 * TFLOPS, int8=660.6 * TFLOPS),
  "RTX 4080": DeviceFlops(fp32=48.7 * TFLOPS, fp16=97.5 * TFLOPS, int8=390.0 * TFLOPS),
  "RTX 4070": DeviceFlops(fp32=29.2 * TFLOPS, fp16=58.3 * TFLOPS, int8=233.0 * TFLOPS),
  "RTX 3090": DeviceFlops(fp32=35.6 * TFLOPS, fp16=71.2 * TFLOPS, int8=284.0 * TFLOPS),
  "RTX 3080": DeviceFlops(fp32=29.8 * TFLOPS, fp16=59.5 * TFLOPS, int8=238.0 * TFLOPS),
  "RTX 3070": DeviceFlops(fp32=20.3 * TFLOPS, fp16=40.6 * TFLOPS, int8=162.6 * TFLOPS),
  "RTX 3060": DeviceFlops(fp32=12.7 * TFLOPS, fp16=25.5 * TFLOPS, int8=102.0 * TFLOPS),
  "GTX 1080": DeviceFlops(fp32=8.9 * TFLOPS, fp16=0.14 * TFLOPS, int8=35.6 * TFLOPS),
  "T1000": DeviceFlops(fp32=2.5 * TFLOPS, fp16=5.0 * TFLOPS, int8=10.0 * TFLOPS),
  "Quadro M2000": DeviceFlops(fp32=1.8 * TFLOPS, fp16=0.03 * TFLOPS, int8=1.8 * TFLOPS),
  "Quadro P400": DeviceFlops(fp32=0.6 * TFLOPS, fp16=0.01 * TFLOPS, int8=0.6 * TFLOPS),
  # Jetson (edge)
  "Jetson AGX Orin": DeviceFlops(fp32=5.3 * TFLOPS, fp16=10.6 * TFLOPS, int8=105.0 * TFLOPS),
  "Jetson Orin Nano": DeviceFlops(fp32=1.3 * TFLOPS, fp16=2.6 * TFLOPS, int8=20.0 * TFLOPS),
  "Jetson Xavier": DeviceFlops(fp32=1.4 * TFLOPS, fp16=2.8 * TFLOPS, int8=22.0 * TFLOPS),
}


def lookup_chip_flops(name: str) -> Optional[DeviceFlops]:
  """Case-insensitive match against the GPU table: the longest table KEY that is a
  substring of the reported name ('NVIDIA A100-SXM4-80GB' hits 'NVIDIA A100', a plain
  'NVIDIA A10' its own row); only when nothing hits, a truncated reported name inside
  a longer key."""
  if not name:
    return None
  low = name.lower()
  for contains_key in (True, False):
    best = None
    for key, flops in GPU_CHIP_FLOPS.items():
      kl = key.lower()
      hit = (kl in low) if contains_key else (low in kl)
      if hit and (best is None or len(kl) > best[0]):
        best = (len(kl), flops)
    if best is not None:
      return best[1]
  return None


def _probe_torch_cuda_sync() -> Optional[DeviceCapabilities]:
  """The CUDA devices torch sees, or None without one."""
  try:
    import torch
    if not torch.cuda.is_available():
      return None
    n = torch.cuda.device_count()
    name = torch.cuda.get_device_name(0)
    mem_mb = torch.cuda.get_device_properties(0).total_memory // (1024 * 1024)
  except (ImportError, RuntimeError, AssertionError) as e:
    if DEBUG >= 2:
      print(f"CUDA probe failed: {e!r}")
    return None
  flops = lookup_chip_flops(name) or DeviceFlops(fp32=10.0, fp16=20.0, int8=40.0)
  return DeviceCapabilities(
    model=f"{name} x{n}", chip=name, memory=int(mem_mb) * n,
    flops=DeviceFlops(fp32=flops.fp32 * n, fp16=flops.fp16 * n, int8=flops.int8 * n),
    num_devices=n,
  )


def _host_memory_mb() -> int:
  try:
    import psutil
    return int(psutil.virtual_memory().total // (1024 * 1024))
  except ImportError:
    pass
  try:
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // (1024 * 1024))
  except (ValueError, OSError, AttributeError):
    return 8 * 1024


def _probe_host_sync() -> DeviceCapabilities:
  cores = os.cpu_count() or 1
  # ~50 GFLOPS fp32 a core is a serviceable planning number for modern x86/arm.
  per_core = 0.05
  return DeviceCapabilities(
    model=f"{platform.system()} CPU ({platform.machine()})",
    chip=platform.processor() or platform.machine() or "CPU",
    memory=_host_memory_mb(),
    flops=DeviceFlops(fp32=per_core * cores, fp16=per_core * cores * 2, int8=per_core * cores * 4),
    num_devices=1,
  )


def device_capabilities_sync() -> DeviceCapabilities:
  caps = _probe_torch_cuda_sync() or _probe_host_sync()
  if DEBUG >= 1:
    print(f"Device capabilities: {caps}")
  return caps


_cached_capabilities: Optional[DeviceCapabilities] = None
_probe_future: Optional["asyncio.Future"] = None


async def device_capabilities() -> DeviceCapabilities:
  """Probe once, on a daemon thread, and cache the result. When the probe takes longer
  than XOT_PROBE_TIMEOUT the host's capabilities are reported so the node still joins
  the ring, and the probe keeps running to fill the cache when it lands."""
  global _cached_capabilities, _probe_future
  if _cached_capabilities is not None:
    return _cached_capabilities
  timeout = knobs.get_float("XOT_PROBE_TIMEOUT")
  loop = asyncio.get_running_loop()
  if _probe_future is None or _probe_future.get_loop() is not loop:
    # (A probe started under an event loop that has since closed is abandoned.)
    _probe_future = loop.create_future()

    def _worker(fut, target_loop) -> None:
      global _cached_capabilities, _probe_future
      try:
        caps = device_capabilities_sync()
      except Exception as e:  # the probe thread's boundary: hand the error to the awaiter
        _probe_future = None  # let a later caller probe again
        try:
          target_loop.call_soon_threadsafe(lambda: fut.set_exception(e) if not fut.done() else None)
        except RuntimeError:
          pass  # the loop already closed
        return
      _cached_capabilities = caps
      try:
        target_loop.call_soon_threadsafe(lambda: fut.set_result(caps) if not fut.done() else None)
      except RuntimeError:
        _probe_future = None

    threading.Thread(target=_worker, args=(_probe_future, loop), daemon=True, name="xot-probe").start()
  try:
    return await asyncio.wait_for(asyncio.shield(_probe_future), timeout)
  except asyncio.TimeoutError:
    if DEBUG >= 1:
      print(f"Device probe exceeded {timeout}s; reporting host capabilities for now")
    return _probe_host_sync()
