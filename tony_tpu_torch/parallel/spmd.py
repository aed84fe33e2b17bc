"""How a rule table runs on a mesh: the port's stand-in for GSPMD.

The JAX package jits one global program and lets XLA place the collectives
from the shardings. The port runs one process a card, each on its own
blocks, and ``Plan`` says where the collectives go. From the mesh and the
rules it reads:

- the data axes: the ``batch`` rule's axes and, under sequence
  parallelism, the ``act_seq`` axis (size > 1). Ranks along them hold
  different tokens, so a gradient is summed over them.
- the tensor-parallel axes: the mesh axis the ``heads``, ``kv``, ``mlp``
  or ``vocab`` rule names. A weight dimension with one of those names
  stays this rank's shard, and the model computes on it Megatron's way
  (collectives.copy_to / reduce_from, the vocab-parallel embedding and
  cross-entropy). Training's tables keep ``kv`` replicated; decode's
  (``TP_DECODE_RULES``) put it on ``tensor``, so ``wk``/``wv`` and the KV
  cache hold this rank's kv heads.
- the expert axis: the mesh axis the ``expert`` rule names (EP_RULES).
  A rank keeps its ``E / ep`` experts of ``w_in``/``w_out`` and computes
  with them alone; the MoE output is summed over the axis
  (parallel/expert.py), and an expert weight's gradient is its own (not
  reduced over the axis). The expert axis may not split the batch.
- every other sharded dimension (``embed`` over fsdp: FSDP, ZeRO-3) is
  stored sharded and gathered where it is used (``use``); its gradient is
  reduce-scattered when the gathering axis is a data axis, and sliced when
  the ranks along it computed the same thing.

After the backward, ``reduce_grads`` sums each gradient over the data axes
that do not shard its parameter, and ``global_norm`` is the norm of the
whole (unsharded) gradient. A step on any mesh then equals the one-device
step up to the order of its sums.
"""

from __future__ import annotations

import math

import torch

from .collectives import all_reduce_, gather_dim, gather_nograd
from .mesh import mesh_shape
from .sharding import _axes, logical_to_spec, mesh_shards_rule

TP_LOGICAL = ("heads", "kv", "mlp", "vocab")


class Plan:
    """The SPMD plan of (mesh, rules) on this rank (module docstring)."""

    def __init__(self, mesh, rules: dict):
        self.mesh, self.rules = mesh, rules
        self.shape = mesh_shape(mesh)
        self.coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        seq = rules.get("act_seq")
        self.seq_axis = seq if isinstance(seq, str) else None
        self.batch_axes = mesh_shards_rule(mesh, rules, "batch",
                                           default=("data", "fsdp"))
        self.data_axes = self.batch_axes + tuple(
            a for a in (self.seq_axis,) if a and self.shape.get(a, 1) > 1)
        self.tp = {}
        for name in TP_LOGICAL:
            axes = mesh_shards_rule(mesh, rules, name)
            if len(axes) > 1 or (axes and axes[0] in self.data_axes):
                raise NotImplementedError(
                    f"rule {name!r} -> {rules.get(name)!r}: a "
                    "tensor-parallel dimension takes one mesh axis that "
                    "does not split the batch or the sequence")
            self.tp[name] = axes[0] if axes else None
        ep = mesh_shards_rule(mesh, rules, "expert")
        if len(ep) > 1 or (ep and ep[0] in self.data_axes):
            raise NotImplementedError(
                f"rule 'expert' -> {rules.get('expert')!r}: the expert "
                "dimension takes one mesh axis that does not split the "
                "batch or the sequence")
        self.ep_axis = ep[0] if ep else None

    def group(self, axis):
        return None if axis is None else self.mesh.get_group(axis)

    def tp_group(self, name: str):
        """The process group ``name`` ('heads', 'kv', 'mlp', 'vocab') is
        tensor-parallel over, or None."""
        return self.group(self.tp[name])

    def tp_rank(self, name: str) -> int:
        return self.coord[self.tp[name]] if self.tp[name] else 0

    @property
    def ep_group(self):
        """The process group the experts are split over, or None."""
        return self.group(self.ep_axis)

    @property
    def ep_rank(self) -> int:
        return self.coord[self.ep_axis] if self.ep_axis else 0

    @property
    def seq_rank(self) -> int:
        return self.coord[self.seq_axis] if self.seq_axis else 0

    def _gathers(self, logical_axes):
        """(dim, axis) of each storage-sharded dimension, minor axis
        first."""
        spec = logical_to_spec(logical_axes, self.rules)
        out = []
        for dim, entry in enumerate(spec):
            name = logical_axes[dim]
            for a in reversed(_axes(entry)):
                if (self.shape.get(a, 1) > 1 and self.tp.get(name) != a
                        and not (name == "expert" and a == self.ep_axis)):
                    out.append((dim, a))
        return out

    def use(self, w: torch.Tensor, logical_axes) -> torch.Tensor:
        """This rank's weight as the model computes with it: every
        storage-sharded dimension gathered, tensor-parallel and expert
        ones left as this rank's shard."""
        for dim, a in self._gathers(logical_axes):
            w = gather_dim(w, dim, self.group(a), a in self.data_axes)
        return w

    def sharding_axes(self, logical_axes) -> set:
        """Mesh axes (size > 1) that shard a parameter's storage."""
        spec = logical_to_spec(logical_axes, self.rules)
        return {a for e in spec for a in _axes(e) if self.shape.get(a, 1) > 1}

    @torch.no_grad()
    def reduce_grads(self, grads: list, axes_list: list) -> list:
        """Sum each gradient over the data axes that do not shard its
        parameter (in place)."""
        for g, axes in zip(grads, axes_list):
            for a in self.data_axes:
                if a not in self.sharding_axes(axes):
                    all_reduce_(g, self.group(a))
        return grads

    @torch.no_grad()
    def global_norm(self, grads: list, axes_list: list) -> torch.Tensor:
        """The norm of the whole gradient: each shard's sum of squares, summed
        over the axes that shard it."""
        buckets: dict = {}
        for g, axes in zip(grads, axes_list):
            key = tuple(sorted(self.sharding_axes(axes)))
            sq = torch.linalg.vector_norm(g.float()) ** 2
            buckets[key] = buckets.get(key, 0) + sq
        total = 0
        for key, sq in buckets.items():
            sq = sq.reshape(1).clone()
            for a in key:
                all_reduce_(sq, self.group(a))
            total = total + sq[0]
        return torch.sqrt(total)

    def global_sum(self, local: torch.Tensor) -> torch.Tensor:
        """The sum of a tensor over the data axes; its gradient is the
        local one (each rank differentiates its own share)."""
        return local + (self.global_count(local) - local.detach())

    def global_count(self, local: torch.Tensor) -> torch.Tensor:
        """The sum over the data axes, without autograd."""
        total = local.detach().clone().reshape(-1)
        for a in self.data_axes:
            all_reduce_(total, self.group(a))
        return total.reshape(local.shape)

    @property
    def batch_size(self) -> int:
        """How many blocks the batch splits into (the batch axes' product)."""
        return math.prod(self.shape[a] for a in self.batch_axes)

    @property
    def batch_rank(self) -> int:
        """This rank's block of the batch: its coordinates on the batch
        axes, major to minor."""
        r = 0
        for a in self.batch_axes:
            r = r * self.shape[a] + self.coord[a]
        return r

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Every batch rank's ``x`` (same shape and dtype on each), stacked
        on a new leading dimension in batch-rank order; no autograd. The
        bytes move as they are (any dtype)."""
        y = x.contiguous()
        raw = y.view(torch.uint8) if y.dtype != torch.bool else \
            y.to(torch.uint8)
        parts = raw.reshape((1,) + tuple(raw.shape))
        for a in reversed(self.batch_axes):      # minor axis first
            parts = gather_nograd(parts, 0, self.group(a))
        if y.dtype == torch.bool:
            return parts.bool()
        return parts.view(y.dtype).reshape((-1,) + tuple(y.shape))

    def from_owners(self, x: torch.Tensor, owner: torch.Tensor,
                    ) -> torch.Tensor:
        """Each element of ``x`` from the batch rank that holds it: every
        rank passes its candidates (valid where it owns the element,
        anything elsewhere) and ``owner``, broadcastable to ``x``'s shape,
        names the owning batch rank of each. A gather of the batch ranks'
        candidates, so every rank gets the same tensor."""
        parts = self.gather_batch(x)
        idx = owner.to(torch.int64).expand(x.shape).unsqueeze(0)
        return parts.gather(0, idx)[0]

    @property
    def trivial(self) -> bool:
        """Every axis of size one: nothing to gather, split or reduce."""
        return all(s == 1 for s in self.shape.values())


def plan_for(mesh, rules):
    """The Plan of (mesh, rules), or None without a mesh."""
    return None if mesh is None else Plan(mesh, dict(rules or {}))


def rule_size(mesh, rules, name: str) -> int:
    """The product of the mesh-axis sizes that shard rule-table row
    ``name`` (the JAX package's generate.py ``_rule_size``)."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in mesh_shards_rule(mesh, rules, name))


__all__ = ["TP_LOGICAL", "Plan", "plan_for", "rule_size"]
