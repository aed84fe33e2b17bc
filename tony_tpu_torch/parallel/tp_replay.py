"""Tensor-parallel decode replayed in one process.

A card runs one rank, so the arithmetic of a tensor axis of ``t`` ranks is
checked on one card by replaying it: every rank runs the multi-process
path's own code (models/generate.py ``_forward_with_cache`` under its
``Plan``) on its blocks of the weights and its share of the KV cache, and
the collectives meet in memory (collectives.ReplayGroup: the partial sums
added in float32 where the all-reduce stands, the vocabulary's logits
concatenated where the gather stands). On the card each rank's prefill
launches K1 on its ``H / t`` heads and each decode step K6 on its
``kvH / t`` kv heads, so a replay launches each kernel ``t`` times as often
as the whole model.

``decode_logits`` runs the whole model's steps by the same loop (no plan),
so the two compare step by step on the same fed tokens.

``ReplayMesh`` is any mesh's rank replayed so (a tensor and an expert
axis for MoE decode; the pipeline schedules' ``pipe`` axis and the
training step's data and expert axes in chip_smoke.py's pipeline
phase).
"""

from __future__ import annotations

import math

import torch

from ..models import transformer
from ..models.generate import _forward_with_cache, init_cache
from .collectives import ReplayWorld
from .mesh import AXIS_ORDER
from .sharding import TP_DECODE_RULES, local_slice, logical_to_spec
from .spmd import Plan, rule_size


class ReplayMesh:
    """What a ``Plan`` (and a pipeline schedule) reads of a mesh, for rank
    ``rank`` of a mesh of ``shape`` ({axis: size}, every other axis 1)
    whose ranks a ``ReplayWorld`` replays in one process: ranks laid out
    row-major over AXIS_ORDER as parallel/mesh.py lays them, and each
    axis's group the world's group of the ranks that differ only there."""

    def __init__(self, world, rank: int, shape: dict):
        self.world, self.rank = world, rank
        sizes = [int(shape.get(a, 1)) for a in AXIS_ORDER]
        if math.prod(sizes) != world.n:
            raise ValueError(f"a mesh of {math.prod(sizes)} ranks replayed "
                             f"by a world of {world.n}")
        self.mesh_dim_names = AXIS_ORDER
        self.mesh = torch.arange(world.n).reshape(sizes)
        self.device_type = "replay"

    def get_coordinate(self) -> list:
        return [int(c) for c in
                (self.mesh == self.rank).nonzero()[0].tolist()]

    def get_group(self, axis: str):
        dim = AXIS_ORDER.index(axis)
        coord = self.get_coordinate()
        index = [slice(None) if d == dim else c for d, c in enumerate(coord)]
        return self.world.group(self.mesh[tuple(index)].tolist())


def rank_params(params: dict, cfg, mesh, rules) -> dict:
    """This rank's blocks of a whole parameter tree (plain tensors), as
    ``prepare_decode`` places them on a mesh."""
    logical = transformer.param_logical_axes(cfg)

    def walk(tree, axes):
        if isinstance(tree, dict):
            return {k: walk(tree[k], axes[k]) for k in tree}
        return local_slice(tree, mesh, logical_to_spec(axes, rules))

    return walk(params, logical)


def _steps(params, cfg, prompt, fed, max_len: int, plan=None,
           n_kv_heads=None) -> list:
    """Prefill ``prompt`` [B, Lp], then one step per column of ``fed``
    [B, n] -> the float32 logits [B, V] of the prefill and of each step."""
    cache = init_cache(cfg, prompt.shape[0], max_len, "native",
                       prompt.device, n_kv_heads)
    logits, cache = _forward_with_cache(params, cfg, prompt, cache,
                                        prefill=True, plan=plan)
    out = [logits]
    for j in range(fed.shape[1]):
        logits, cache = _forward_with_cache(params, cfg, fed[:, j:j + 1],
                                            cache, plan=plan)
        out.append(logits)
    return out


@torch.no_grad()
def decode_logits(params: dict, cfg, prompt, fed, max_len: int) -> list:
    """The whole model's prefill and decode steps (``_steps`` on one
    device)."""
    return _steps(params, cfg, prompt, fed, max_len)


@torch.no_grad()
def replay_tp_decode(params: dict, cfg, prompt, fed, t: int,
                     max_len: int, rules=None, shape=None) -> list:
    """Every rank of a ``t``-rank tensor axis in one process (module
    docstring), from the whole parameters ``params`` (already at the
    decode dtype), the prompt and the fed tokens -> each rank's logits of
    the prefill and of each step (``_steps``); every rank's are the whole
    vocabulary's. ``shape`` ({axis: size}) replays another mesh instead,
    e.g. ``{"tensor": 2, "expert": 2}`` with ``EP_RULES`` merged into the
    rules (a MoE model's experts split over ``expert``)."""
    rules = dict(TP_DECODE_RULES if rules is None else rules)
    shape = dict(shape or {"tensor": t})
    world = ReplayWorld(math.prod(shape.values()))

    def rank(r):
        mesh = ReplayMesh(world, r, shape)
        plan = Plan(mesh, rules)
        n_kv = cfg.n_kv_heads // rule_size(mesh, rules, "kv")
        return _steps(rank_params(params, cfg, mesh, rules), cfg, prompt,
                      fed, max_len, plan, n_kv)

    return world.run(rank)


__all__ = ["ReplayMesh", "rank_params", "decode_logits", "replay_tp_decode"]
