"""The port's topology layer against the JAX package's, on the CPU.

Device capabilities, the topology graph's JSON form, the memory-weighted ring
partitioning and the layer ranges it maps to, and the knobs these modules read: the
port (xotorch_tpu_torch/topology) must give what the JAX package
(xotorch_tpu/topology) gives on the same inputs, since peers of either derive the
ring's partition table on their own and must agree on it.
"""
import asyncio
import importlib

import pytest

from xotorch_tpu.topology import partitioning as j_part
from xotorch_tpu.topology import topology as j_topo
from xotorch_tpu.utils import knobs as j_knobs
from xotorch_tpu_torch.topology import partitioning as p_part
from xotorch_tpu_torch.topology import topology as p_topo
from xotorch_tpu_torch.utils import knobs as p_knobs

# (The packages re-export the probe function under the module's name.)
j_caps = importlib.import_module("xotorch_tpu.topology.device_capabilities")
p_caps = importlib.import_module("xotorch_tpu_torch.topology.device_capabilities")


def _caps(mod, memory, name="chip"):
  return mod.DeviceCapabilities(f"model-{name}", name, memory, mod.DeviceFlops(1.5, 3.0, 6.0))


def test_device_capabilities_dicts_equal():
  for memory in (0, 1024, 81559):
    j, p = _caps(j_caps, memory), _caps(p_caps, memory)
    assert p.to_dict() == j.to_dict()
    assert p_caps.DeviceCapabilities.from_dict(j.to_dict()).to_dict() == j.to_dict()
    assert j_caps.DeviceCapabilities.from_dict(p.to_dict()).to_dict() == p.to_dict()
    assert str(p) == str(j)
  assert p_caps.UNKNOWN_DEVICE_CAPABILITIES.to_dict() == j_caps.UNKNOWN_DEVICE_CAPABILITIES.to_dict()
  partial = {"model": "m", "memory": "2048", "flops": {"fp16": 2}}
  assert (p_caps.DeviceCapabilities.from_dict(partial).to_dict()
          == j_caps.DeviceCapabilities.from_dict(partial).to_dict())


@pytest.mark.parametrize("name", [
  "NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "NVIDIA A10",
  "NVIDIA GeForce RTX 4090", "NVIDIA L4", "NVIDIA L40S", "Tesla T4", "Orin", "no such chip", "",
])
def test_lookup_chip_flops_equal(name):
  j, p = j_caps.lookup_chip_flops(name), p_caps.lookup_chip_flops(name)
  assert (p.to_dict() if p else None) == (j.to_dict() if j else None)


def test_h100_flops_are_the_data_sheet_peaks():
  flops = p_caps.lookup_chip_flops("NVIDIA H100 80GB HBM3")
  assert flops == p_caps.DeviceFlops(fp32=67.0, fp16=989.0, int8=1979.0)


async def test_device_capabilities_fall_back_to_the_host_without_a_card(monkeypatch):
  monkeypatch.setattr(p_caps, "_cached_capabilities", None)
  monkeypatch.setattr(p_caps, "_probe_future", None)
  assert p_caps._probe_torch_cuda_sync() is None  # no CUDA in this process
  caps = await asyncio.wait_for(p_caps.device_capabilities(), timeout=60)
  assert caps.memory > 0 and caps.flops.fp32 > 0 and caps.num_devices == 1
  assert await p_caps.device_capabilities() is caps  # cached


def _pair(memories):
  """The same topology in both packages: node ids n0.. with the given memories, and a
  ring of edges."""
  jt, pt = j_topo.Topology(), p_topo.Topology()
  ids = [f"n{i}" for i in range(len(memories))]
  for node_id, memory in zip(ids, memories):
    jt.update_node(node_id, _caps(j_caps, memory, node_id))
    pt.update_node(node_id, _caps(p_caps, memory, node_id))
  for a, b in zip(ids, ids[1:] + ids[:1]):
    jt.add_edge(a, b, "ring")
    pt.add_edge(a, b, "ring")
  jt.active_node_id = pt.active_node_id = ids[0]
  return jt, pt


def test_topology_json_both_ways():
  jt, pt = _pair([1024, 2048, 0])
  assert pt.to_json() == jt.to_json()
  assert p_topo.Topology.from_json(jt.to_json()).to_json() == jt.to_json()
  assert j_topo.Topology.from_json(pt.to_json()).to_json() == pt.to_json()
  assert pt.get_neighbors("n0") == jt.get_neighbors("n0") == {"n1"}


def test_topology_merge_takes_only_the_peers_own_view():
  jt, pt = _pair([1024, 2048, 4096])
  jo, po = _pair([1, 2, 3])
  jo.add_edge("n2", "n9", "gossip")
  po.add_edge("n2", "n9", "gossip")
  jt.merge("n2", jo)
  pt.merge("n2", po)
  assert pt.to_json() == jt.to_json()
  assert pt.get_node("n2").memory == 3 and pt.get_node("n1").memory == 2048


TOPOLOGIES = [
  [1024],
  [0],
  [1024, 1024],  # a tie: the order falls to the ids, descending
  [81559, 81559],
  [2048, 1024],
  [0, 0, 0],  # every memory unknown: an equal split
  [16384, 8192, 8192],
  [1000, 3000, 2000, 3000],
  [5, 1, 1, 1, 1],
  [81559, 0, 40960, 24576, 1],
]


@pytest.mark.parametrize("num_layers", [4, 16, 126])
@pytest.mark.parametrize("memories", TOPOLOGIES, ids=lambda m: "-".join(map(str, m)))
def test_partition_table_and_shards_equal_jax(memories, num_layers):
  jt, pt = _pair(memories)
  jp = j_part.RingMemoryWeightedPartitioningStrategy().partition(jt)
  pp = p_part.RingMemoryWeightedPartitioningStrategy().partition(pt)
  assert [(p.node_id, p.start, p.end) for p in pp] == [(p.node_id, p.start, p.end) for p in jp]
  if len(memories) > num_layers:
    with pytest.raises(ValueError):
      j_part.map_partitions_to_shards(jp, num_layers, "m")
    with pytest.raises(ValueError):
      p_part.map_partitions_to_shards(pp, num_layers, "m")
    return
  js = j_part.map_partitions_to_shards(jp, num_layers, "m")
  ps = p_part.map_partitions_to_shards(pp, num_layers, "m")
  assert [s.to_dict() for s in ps] == [s.to_dict() for s in js]
  assert ps[0].start_layer == 0 and ps[-1].end_layer == num_layers - 1
  assert all(a.end_layer + 1 == b.start_layer for a, b in zip(ps, ps[1:]))


def test_more_peers_than_layers_raises_in_both():
  jt, pt = _pair([1] * 5)
  jp = j_part.RingMemoryWeightedPartitioningStrategy().partition(jt)
  pp = p_part.RingMemoryWeightedPartitioningStrategy().partition(pt)
  for mod, parts in ((j_part, jp), (p_part, pp)):
    with pytest.raises(ValueError, match="Cannot partition 4 layers across 5 peers"):
      mod.map_partitions_to_shards(parts, 4, "m")
  assert p_part.map_partitions_to_shards([], 4, "m") == j_part.map_partitions_to_shards([], 4, "m") == []


@pytest.mark.parametrize("name", ["XOT_HOP_RETRIES", "XOT_HOP_BACKOFF_S", "XOT_PROBE_TIMEOUT"])
def test_ring_knobs_match_jax(name, monkeypatch):
  j, p = j_knobs.REGISTRY[name], p_knobs.REGISTRY[name]
  assert (p.kind, p.default) == (j.kind, j.default)
  monkeypatch.setenv(name, "3")
  getter = {"int": "get_int", "float": "get_float"}[p.kind]
  assert getattr(p_knobs, getter)(name) == getattr(j_knobs, getter)(name) == 3
