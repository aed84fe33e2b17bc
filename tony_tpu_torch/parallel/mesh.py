"""The device mesh (port of the JAX package's parallel/mesh.py).

Every parallelism strategy is an axis of one mesh, named outer to inner:

    pipe   pipeline stages
    data   pure data parallel       (gradient all-reduce; DCN-safe)
    fsdp   data parallel + sharded params (all-gather params, reduce-scatter
           grads)
    seq    sequence/context parallel (ring P2P or Ulysses all-to-all)
    expert MoE expert parallel
    tensor tensor/model parallel    (activation all-reduce; innermost)

The port runs one process a card, so the mesh is a
``torch.distributed.DeviceMesh`` over the ranks of the default process group
(train/bootstrap.py ``init``). Ranks are laid out row-major with ``tensor``
fastest, so a tensor group is consecutive ranks: the cards of one node,
joined by NVLink, when the node's ranks are consecutive. Where the JAX
package reads a device's ``slice_index``, the port reads the node: a
"slice" is a node (``TONY_NUM_SLICES`` of them, ranks grouped evenly in
order), and ``build_hybrid_mesh`` lays the DCN-safe axes across nodes and
the bandwidth-hungry ones within a node.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

AXIS_ORDER = ("pipe", "data", "fsdp", "seq", "expert", "tensor")


@dataclass(frozen=True)
class MeshSpec:
    """Requested parallelism degrees. -1 on at most one axis means 'absorb
    all remaining devices'. Unspecified axes default to 1."""

    pipe: int = 1
    data: int = 1
    fsdp: int = -1
    seq: int = 1
    expert: int = 1
    tensor: int = 1

    def sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = self.sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"axis product {fixed} != device count "
                             f"{n_devices}")
        return sizes


def parse_mesh(desc: str) -> MeshSpec:
    """'data=2,tensor=4' / 'fsdp=-1,tensor=2' -> MeshSpec, with the JAX
    package's defaults: fsdp is 1 unless named, and with no -1 axis the
    remainder goes to data."""
    kwargs: dict[str, int] = {}
    for part in desc.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        if k not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {k!r}; valid: {AXIS_ORDER}")
        kwargs[k] = int(v)
    if "fsdp" not in kwargs:
        kwargs["fsdp"] = 1
    if not any(v == -1 for v in kwargs.values()) and "data" not in kwargs:
        kwargs["data"] = -1
    return MeshSpec(**kwargs)


def rank_array(spec: MeshSpec, world_size: int) -> np.ndarray:
    """The global ranks laid out over AXIS_ORDER, row-major (tensor
    fastest)."""
    sizes = spec.resolve(world_size)
    return np.arange(world_size).reshape(tuple(sizes[a] for a in AXIS_ORDER))


def _world_size() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the job's process group: call "
                           "tony_tpu_torch.train.init() under the TONY_* "
                           "env contract first")
    return dist.get_world_size()


def _device_mesh(ranks: np.ndarray, device_type: str | None):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if ranks.size != dist.get_world_size():
        raise ValueError(f"mesh of {ranks.size} ranks over a world of "
                         f"{dist.get_world_size()}")
    if device_type is None:
        device_type = "cpu" if dist.get_backend() == "gloo" else "cuda"
    if (ranks.ravel() == np.arange(ranks.size)).all():
        return init_device_mesh(device_type, ranks.shape,
                                mesh_dim_names=AXIS_ORDER)
    return DeviceMesh(device_type, torch.as_tensor(ranks),
                      mesh_dim_names=AXIS_ORDER)


def build_mesh(spec: MeshSpec | None = None, device_type: str | None = None):
    """A DeviceMesh over every rank of the job's process group, axes in
    AXIS_ORDER, ``tensor`` fastest (module docstring). ``device_type``
    defaults to the process group's: "cuda" under NCCL, "cpu" under gloo."""
    return _device_mesh(rank_array(spec or MeshSpec(), _world_size()),
                        device_type)


def mesh_from_string(desc: str, device_type: str | None = None):
    """Parse 'data=2,tensor=4' / 'fsdp=-1,tensor=2' into a mesh."""
    return build_mesh(parse_mesh(desc), device_type)


def single_device_mesh(device_type: str | None = None):
    """The mesh of a one-process job: every axis 1."""
    return build_mesh(MeshSpec(fsdp=1), device_type)


def mesh_shape(mesh) -> dict[str, int]:
    """{axis: size} of a DeviceMesh (the JAX ``mesh.shape``); {} for None."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def detect_num_slices() -> int:
    """Number of nodes from the multislice env contract (1 without it)."""
    from ..train.bootstrap import num_slices

    return num_slices()


def hybrid_rank_array(ici: MeshSpec, dcn: MeshSpec, world_size: int,
                      num_slices: int) -> np.ndarray:
    """Ranks over AXIS_ORDER for a multi-node mesh: ranks are grouped into
    ``num_slices`` nodes of consecutive ranks; ``dcn`` axes span nodes,
    ``ici`` axes stay within one (the JAX package's layout, with a node in
    place of a slice)."""
    if world_size % num_slices:
        raise ValueError(f"cannot group {world_size} devices into "
                         f"{num_slices} equal slices")
    per_slice = world_size // num_slices
    dcn_sizes = dcn.resolve(num_slices)
    ici_sizes = ici.resolve(per_slice)
    overlap = [a for a in AXIS_ORDER if dcn_sizes[a] > 1 and ici_sizes[a] > 1]
    if overlap:
        raise ValueError(f"axes {overlap} span both DCN and ICI; give each "
                         "axis to one network")
    dcn_shape = tuple(dcn_sizes[a] for a in AXIS_ORDER)
    ici_shape = tuple(ici_sizes[a] for a in AXIS_ORDER)
    shape = tuple(d * s for d, s in zip(dcn_shape, ici_shape))
    arr = np.empty(shape, dtype=np.int64)
    for idx in np.ndindex(shape):
        d = tuple(i // s for i, s in zip(idx, ici_shape))
        s = tuple(i % s for i, s in zip(idx, ici_shape))
        node = int(np.ravel_multi_index(d, dcn_shape))
        arr[idx] = node * per_slice + int(np.ravel_multi_index(s, ici_shape))
    return arr


def build_hybrid_mesh(ici: MeshSpec | None = None, dcn: MeshSpec | None = None,
                      num_slices: int | None = None,
                      device_type: str | None = None):
    """Multi-node mesh: ``dcn`` axes span nodes (traffic crosses the data
    center network), ``ici`` axes stay within one node (NVLink). Put
    ``data`` (one gradient all-reduce a step) and optionally ``pipe`` across
    nodes; keep fsdp/seq/expert/tensor within one. One node and no ``dcn``
    is ``build_mesh(ici)``. Same axis names and order as build_mesh, so the
    rule tables apply unchanged."""
    ici = ici or MeshSpec()
    if num_slices is None:
        num_slices = detect_num_slices()
    if num_slices <= 1 and dcn is None:
        return build_mesh(ici, device_type)
    dcn = dcn or MeshSpec(data=num_slices, fsdp=1)
    return _device_mesh(hybrid_rank_array(ici, dcn, _world_size(),
                                          num_slices), device_type)


def slice_topology() -> dict:
    """What the job sees of its cards (the JAX package's TPU topology
    discovery, read from torch.distributed and torch.cuda)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    cuda = torch.cuda.is_available()
    return {
        "num_devices": world,
        "num_local_devices": torch.cuda.device_count() if cuda else 1,
        "num_hosts": detect_num_slices(),
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
    }


__all__ = ["AXIS_ORDER", "MeshSpec", "parse_mesh", "rank_array", "build_mesh",
           "mesh_from_string", "single_device_mesh", "mesh_shape",
           "detect_num_slices", "hybrid_rank_array", "build_hybrid_mesh",
           "slice_topology"]
