"""Logical-axis sharding rules (port of the JAX package's
parallel/sharding.py): name model dimensions once, map them to mesh axes per
parallelism strategy.

Model code names each array dimension by a logical axis ("batch", "embed",
"mlp", "heads", "kv", "vocab", "layers", "expert", "seq"); a rule table maps
logical -> mesh axes. The tables are the JAX package's, verbatim. A logical
axis tuple becomes a spec (the JAX ``PartitionSpec``'s entries: None, a mesh
axis or a tuple of them, trailing Nones dropped) and a spec becomes DTensor
placements, one a mesh axis: ``Shard(dim)`` on each mesh axis a dimension
names, ``Replicate()`` elsewhere. A dimension sharded over several mesh
axes is split over them major to minor in the order the rule names them,
which must be AXIS_ORDER's (DTensor's own order for a dimension sharded
twice).

``shard_params`` builds each rank's DTensor from the slice of a full tensor
that every rank holds alike (one seeded init, or converted JAX
parameters), so placing parameters moves no byte between ranks.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from .mesh import AXIS_ORDER, mesh_shape

# logical dim -> mesh axis (or tuple of axes, or None = replicated)
Rules = dict[str, Any]

# "batch" over (data, fsdp): pure-DP and FSDP groups both consume the
# batch; params sharded over fsdp (ZeRO-3-style) and/or tensor
# (Megatron-style)
DP_RULES: Rules = {
    "batch": ("data", "fsdp"),
    "seq": None, "embed": None, "mlp": None, "heads": None,
    "kv": None, "vocab": None, "layers": None, "expert": None,
    "expert_group": None,
}

FSDP_RULES: Rules = {
    **DP_RULES,
    "embed": "fsdp",      # params sharded along embed over the fsdp axis
}

TP_RULES: Rules = {
    **DP_RULES,
    "mlp": "tensor",      # MLP hidden dim
    "heads": "tensor",    # attention heads
    "vocab": "tensor",    # embedding/unembedding vocab dim
}

FSDP_TP_RULES: Rules = {
    **TP_RULES,
    "embed": "fsdp",
}

TP_DECODE_RULES: Rules = {
    # inference tensor parallelism: training keeps "kv" replicated (GQA
    # kv-head counts often don't divide the tensor axis); decode shards the
    # KV cache over kv heads
    **TP_RULES,
    "kv": "tensor",
}

SP_RULES: Rules = {
    # context parallelism: activations sharded along sequence (ring or
    # Ulysses attention)
    "seq": "seq",
}

EP_RULES: Rules = {
    "expert": "expert",
}


def merge_rules(*tables: Rules) -> Rules:
    out: Rules = {}
    for t in tables:
        out.update(t)
    return out


def _axes(entry) -> tuple:
    """A spec entry (None, an axis, a tuple of axes) -> tuple of axes."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_to_spec(logical_axes: Sequence[str | None], rules: Rules) -> tuple:
    """('batch', 'seq', 'embed') + rules -> the spec's entries (the JAX
    ``PartitionSpec``'s, trailing Nones dropped)."""
    parts = [None if name is None else rules.get(name)
             for name in logical_axes]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_to_placements(spec: tuple, axis_names: Sequence[str] = AXIS_ORDER):
    """Spec entries -> DTensor placements, one a mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in axis_names]
    seen: set = set()
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if list(axes) != sorted(axes, key=list(axis_names).index):
            raise ValueError(f"dimension {dim} is sharded over {axes}: name "
                             f"the axes in mesh order {tuple(axis_names)}")
        for a in axes:
            if a in seen:
                raise ValueError(f"mesh axis {a!r} shards two dimensions")
            seen.add(a)
            out[list(axis_names).index(a)] = Shard(dim)
    return tuple(out)


def sharding_for(mesh, logical_axes: Sequence[str | None], rules: Rules):
    """DTensor placements on ``mesh`` for an array with these logical axes."""
    return spec_to_placements(logical_to_spec(logical_axes, rules),
                              mesh.mesh_dim_names)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_shardings(mesh, logical_tree: Any, rules: Rules) -> Any:
    """A tree of logical-axis tuples -> the same tree of placements."""
    return _tree_map(lambda axes: sharding_for(mesh, axes, rules),
                     logical_tree)


def local_slice(full: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view). Every sharded
    dimension must divide evenly by its axes' product."""
    shape, coord = mesh_shape(mesh), dict(zip(mesh.mesh_dim_names,
                                              mesh.get_coordinate()))
    out = full
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:                       # major to minor
            idx = idx * shape[a] + coord[a]
            n *= shape[a]
        if full.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {full.shape[dim]} "
                             f"does not divide over {axes} ({n} ranks)")
        size = full.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out


def block_placer(mesh, rules: Rules):
    """``place(full, logical_axes)`` -> a DTensor placed by ``rules`` that
    holds a copy of this rank's block of ``full`` (the same on every rank);
    no communication."""
    from torch.distributed.tensor import DTensor

    def place(t, axes):
        spec = logical_to_spec(axes, rules)
        with torch.no_grad():
            local = local_slice(t.detach(), mesh, spec).clone()
            return DTensor.from_local(
                local, mesh, spec_to_placements(spec, mesh.mesh_dim_names),
                run_check=False, shape=t.shape, stride=t.stride())

    return place


def shard_params(mesh, params: Any, logical_tree: Any, rules: Rules) -> Any:
    """A full parameter tree (the same on every rank) -> a tree of DTensors
    placed by ``rules``; each holds a copy of this rank's block."""
    return _tree_map(block_placer(mesh, rules), params, logical_tree)


def replicated(mesh):
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def batch_sharding(mesh, rules: Rules):
    """Placements for (batch, ...) input arrays."""
    return sharding_for(mesh, ("batch",), rules)


def mesh_shards_rule(mesh, rules: Rules | None, name: str, default=()) -> tuple:
    """Mesh axes that actually shard (>1 devices) the rule-table row ``name``.

    Normalizes the row (None / str / tuple) and falls back to ``default``
    when no rules are given or the row is absent. The one place that
    answers 'does the mesh shard logical axis X', for the loader ('batch',
    'act_seq'), the train step and the CE dispatch ('vocab')."""
    axes = _axes(default if rules is None else rules.get(name, default))
    if mesh is None:
        return ()
    shape = mesh_shape(mesh)
    return tuple(a for a in axes if shape.get(a, 1) > 1)


__all__ = [
    "Rules", "DP_RULES", "FSDP_RULES", "TP_RULES", "FSDP_TP_RULES",
    "TP_DECODE_RULES", "SP_RULES", "EP_RULES", "merge_rules",
    "logical_to_spec", "spec_to_placements", "sharding_for",
    "tree_shardings", "local_slice", "block_placer", "shard_params",
    "batch_sharding", "mesh_shards_rule",
]
