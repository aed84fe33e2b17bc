"""Training step for the flagship transformer (port of the JAX package's
train/step.py).

The optimizer is the JAX package's optax chain written out:
``clip_by_global_norm(1.0)`` then ``adamw(lr, b1=0.9, b2=0.95, eps=1e-8,
weight_decay=0.01)`` on every leaf. Parameters and optimizer moments are
updated in place (the JAX step donates its buffers, so nothing keeps the
old values there either). Gradients come from autograd of ``loss_fn``,
whose attention backward runs the flash backward kernels on the card.

Without a mesh the step runs on one device. With one (parallel/mesh.py,
after ``train.init()``), it is SPMD: parameters and AdamW moments are
DTensors placed by the rule table (default ``FSDP_TP_RULES``), each rank
computes on its own blocks (parallel/spmd.py: FSDP gathers at use,
Megatron tensor parallelism, ring or Ulysses sequence parallelism), the
gradients are summed over the data axes, and the loss and ``grad_norm``
are the whole batch's, so a step on any mesh equals the one-device step up
to the order of its sums. Each rank passes the step its own block of the
tokens: batch over the rules' batch axes, sequence over ``act_seq`` when
sequence-parallel (data/loader.py ``loader_shard_info`` and
``seq_shard_info``). A MoE model's experts split over the ``expert`` axis
under ``EP_RULES`` (merged into the rules). No rule names ``pipe``: a
``pipe`` axis wider than one replicates the step over its ranks, exactly
as the JAX package's ``create_train_step`` does; the pipeline schedules
are train/pipeline_step.py's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..device import resolve_device
from ..models import transformer
from ..parallel import sharding as shlib
from ..parallel.mesh import mesh_shape
from ..parallel.spmd import Plan


def _leaves(tree: dict, prefix: str = ""):
    """(path, tensor) of every leaf, in a fixed order."""
    for name in sorted(tree):
        node = tree[name]
        if isinstance(node, dict):
            yield from _leaves(node, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", node


# the JAX package's adamw moments and epsilon
B1, B2, EPS = 0.9, 0.95, 1e-8


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(lr, b1=0.9,
    b2=0.95, eps=1e-8, weight_decay)) as in-place updates. ``grad_norm`` is
    reported from the unclipped gradients. The clip is optax's: g unchanged
    when its global norm is below grad_clip, else g / norm * grad_clip (no
    epsilon in the divisor)."""

    def __init__(self, lr: float, weight_decay: float, grad_clip: float):
        self.lr, self.weight_decay, self.grad_clip = lr, weight_decay, grad_clip

    def init(self, params: dict) -> dict:
        def zeros(tree):
            return {k: zeros(v) if isinstance(v, dict) else torch.zeros_like(v)
                    for k, v in tree.items()}

        return {"count": 0, "mu": zeros(params), "nu": zeros(params)}

    @torch.no_grad()
    def step(self, params: dict, grads: list, state: dict,
             gnorm: torch.Tensor | None = None) -> torch.Tensor:
        """Apply one update to ``params`` and ``state`` in place; ``grads``
        in ``_leaves(params)`` order -> the global norm of the unclipped
        gradients (a 0-d tensor). A sharded step passes ``gnorm``, the norm
        of the whole gradient, since its ``grads`` are shards."""
        if gnorm is None:
            gnorm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
        # optax: select(norm < clip, g, g / norm * clip)
        clip = torch.where(gnorm < self.grad_clip, 1.0,
                           self.grad_clip / gnorm)
        state["count"] += 1
        t = state["count"]
        c1, c2 = 1 - B1 ** t, 1 - B2 ** t
        mus = [m for _, m in _leaves(state["mu"])]
        nus = [n for _, n in _leaves(state["nu"])]
        for (_, p), g, mu, nu in zip(_leaves(params), grads, mus, nus):
            g = g * clip
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1 - B2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            update.add_(p, alpha=self.weight_decay)
            p.add_(update, alpha=-self.lr)
        return gnorm


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01,
                   grad_clip: float = 1.0) -> AdamW:
    return AdamW(lr, weight_decay=weight_decay, grad_clip=grad_clip)


@dataclass
class TrainStepBundle:
    # (params, opt_state, tokens, targets) -> (params, opt_state, metrics)
    step_fn: Callable
    params: Any
    opt_state: Any
    mesh: Any
    config: transformer.TransformerConfig
    optimizer: AdamW
    # (params, tokens, targets) -> scalar loss with no optimizer update
    eval_fn: Callable = None
    rules: dict | None = None
    # the rule table's DTensor placements of the params (and moments), and
    # of the [B, L] token blocks
    param_shardings: Any = None
    tok_sharding: Any = None


def _local_tree(tree, grad: bool = False):
    """A tree of DTensors (or of a replayed mesh's plain blocks) -> the
    same tree of their local tensors (sharing storage: an in-place update
    of one is an update of the other); with ``grad``, each a new leaf that
    requires grad."""
    def local(v):
        v = v.to_local() if hasattr(v, "to_local") else v
        return v.detach().requires_grad_(True) if grad else v

    return {k: _local_tree(v, grad) if isinstance(v, dict) else local(v)
            for k, v in tree.items()}


def create_train_step(cfg: transformer.TransformerConfig, mesh=None,
                      rules: dict | None = None,
                      generator: torch.Generator | None = None,
                      optimizer: AdamW | None = None, device=None,
                      params: dict | None = None,
                      sp_impl: str | None = None) -> TrainStepBundle:
    """Parameters (``params``, the same full tree on every rank, or
    ``transformer.init`` from ``generator``, default seed 0), optimizer
    state and the step; on one device without ``mesh``, else sharded by
    ``rules`` over the mesh (module docstring).

    ``sp_impl`` picks the sequence-parallel attention when the mesh has a
    ``seq`` axis wider than one: "ring" (K/V P2P ring) or "ulysses"
    (all-to-all head sharding); default "ring". Either adds the rule
    ``act_seq -> seq``.

    ``step_fn`` and ``eval_fn`` compute with the trees they are given (the
    bundle's, or one restored from a checkpoint with the bundle's as its
    template) and update those in place.

    On a replayed mesh (parallel/tp_replay.py ``ReplayMesh``: a mesh's
    ranks as threads of one process) the parameters and moments are plain
    tensors holding the rank's blocks: a DTensor needs a DeviceMesh."""
    if mesh is None:
        return _create_local(cfg, generator, optimizer, device, params)
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a DeviceMesh (parallel.build_mesh), "
                        f"got {type(mesh).__name__}")
    rules = dict(rules if rules is not None else shlib.FSDP_TP_RULES)
    if sp_impl is None and mesh_shape(mesh).get("seq", 1) > 1:
        sp_impl = "ring"
    if sp_impl is not None and sp_impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_impl {sp_impl!r}")
    if sp_impl:
        cfg = transformer.TransformerConfig(
            **{**cfg.__dict__, "attn_impl": sp_impl})
        rules.setdefault("act_seq", "seq")
    replay = mesh.device_type == "replay"
    if device is None and not replay:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device("cpu"))
    device = resolve_device(device)
    if params is None:
        generator = generator or torch.Generator(device=device).manual_seed(0)
        params = transformer.init(cfg, generator, device)
    axes_tree = transformer.param_logical_axes(cfg)
    optimizer = optimizer or make_optimizer()
    if replay:
        params = shlib._tree_map(
            lambda t, axes: shlib.local_slice(
                t.detach(), mesh,
                shlib.logical_to_spec(axes, rules)).clone(),
            params, axes_tree)
        shardings = None
        opt_state = optimizer.init(params)
    else:
        params = shlib.shard_params(mesh, params, axes_tree, rules)
        shardings = shlib.tree_shardings(mesh, axes_tree, rules)
        opt_state = _sharded_moments(params, mesh, shardings)
    flat_axes = dict(_leaves(axes_tree))
    leaf_axes = [flat_axes[n] for n, _ in _leaves(params)]
    plan = Plan(mesh, rules)
    seq_axis = rules.get("act_seq") if sp_impl else None
    tok_sharding = shlib.spec_to_placements(
        (rules.get("batch"), seq_axis), mesh.mesh_dim_names)

    def step(params, opt_state, tokens, targets):
        # this rank's blocks, as leaves that take gradients (sharing the
        # DTensors' storage, so the update below lands in ``params``)
        local = _local_tree(params, grad=True)
        leaves = [p for _, p in _leaves(local)]
        loss = transformer.loss_fn(local, tokens, targets, cfg, mesh, rules)
        grads = list(torch.autograd.grad(loss, leaves))
        plan.reduce_grads(grads, leaf_axes)
        gnorm = plan.global_norm(grads, leaf_axes)
        state = {"count": opt_state["count"],
                 "mu": _local_tree(opt_state["mu"]),
                 "nu": _local_tree(opt_state["nu"])}
        optimizer.step(local, grads, state, gnorm=gnorm)
        opt_state["count"] = state["count"]
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    @torch.no_grad()
    def eval_loss(params, tokens, targets):
        return transformer.loss_fn(_local_tree(params), tokens, targets, cfg,
                                   mesh, rules)

    return TrainStepBundle(step_fn=step, params=params, opt_state=opt_state,
                           mesh=mesh, config=cfg, optimizer=optimizer,
                           eval_fn=eval_loss, rules=rules,
                           param_shardings=shardings,
                           tok_sharding=tok_sharding)


def _sharded_moments(params: dict, mesh, shardings: dict) -> dict:
    """AdamW's state with its moments placed as the parameters are (FSDP
    shards the moments for free, ZeRO-style)."""
    from torch.distributed.tensor import DTensor

    def zeros(tree, placements):
        return {k: zeros(v, placements[k]) if isinstance(v, dict)
                else DTensor.from_local(torch.zeros_like(v.to_local()), mesh,
                                        placements[k], run_check=False,
                                        shape=v.shape, stride=v.stride())
                for k, v in tree.items()}

    return {"count": 0, "mu": zeros(params, shardings),
            "nu": zeros(params, shardings)}


def _create_local(cfg, generator, optimizer, device, params) -> TrainStepBundle:
    """The one-device step: parameters and moments plain tensors."""
    device = resolve_device(device)
    if params is None:
        generator = generator or torch.Generator(device=device).manual_seed(0)
        params = transformer.init(cfg, generator, device)
    for _, p in _leaves(params):
        p.requires_grad_(True)
    optimizer = optimizer or make_optimizer()
    opt_state = optimizer.init(params)

    def step(params, opt_state, tokens, targets):
        leaves = [p.requires_grad_(True) for _, p in _leaves(params)]
        loss = transformer.loss_fn(params, tokens, targets, cfg)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = optimizer.step(params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    @torch.no_grad()
    def eval_loss(params, tokens, targets):
        return transformer.loss_fn(params, tokens, targets, cfg)

    return TrainStepBundle(step_fn=step, params=params, opt_state=opt_state,
                           mesh=None, config=cfg, optimizer=optimizer,
                           eval_fn=eval_loss)


def make_forward(cfg: transformer.TransformerConfig, mesh=None,
                 rules: dict | None = None) -> Callable:
    """Inference forward (logits only); with a mesh, SPMD over this rank's
    blocks (logits over the whole vocabulary)."""

    @torch.no_grad()
    def fwd(params, tokens):
        return transformer.apply(params, tokens, cfg, mesh, rules)[0]

    return fwd


def synthetic_lm_batch(generator: torch.Generator, batch: int, seq: int,
                       vocab: int):
    """Next-token-predictable synthetic stream (affine sequences mod vocab),
    on the generator's device -> (tokens, targets) [batch, seq] int64. The
    same law as the JAX package's; the draws differ (another generator)."""
    dev = generator.device
    start = torch.randint(0, vocab, (batch, 1), generator=generator, device=dev)
    step_ = torch.randint(1, 7, (batch, 1), generator=generator, device=dev)
    pos = torch.arange(seq + 1, device=dev)[None, :]
    toks = (start + step_ * pos) % vocab
    return toks[:, :-1], toks[:, 1:]


__all__ = ["AdamW", "TrainStepBundle", "create_train_step", "make_forward",
           "make_optimizer", "synthetic_lm_batch"]
