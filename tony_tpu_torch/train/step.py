"""Training step for the flagship transformer on one device (port of the
JAX package's train/step.py).

The optimizer is the JAX package's optax chain written out:
``clip_by_global_norm(1.0)`` then ``adamw(lr, b1=0.9, b2=0.95, eps=1e-8,
weight_decay=0.01)`` on every leaf. Parameters and optimizer moments are
updated in place (the JAX step donates its buffers, so nothing keeps the
old values there either). Gradients come from autograd of ``loss_fn``,
whose attention backward runs the flash backward kernels on the card.

A mesh that spans more than one device raises until the mesh slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..device import resolve_device
from ..models import transformer

# the JAX package's mesh axes, outer to inner
AXIS_ORDER = ("pipe", "data", "fsdp", "seq", "expert", "tensor")


def mesh_from_string(desc: str) -> dict:
    """'fsdp=-1' / 'data=2,tensor=4' -> {axis: size} over every axis, on
    one device: -1 and unnamed axes are 1, and an axis wider than 1 raises
    (the mesh is not ported yet)."""
    sizes = dict.fromkeys(AXIS_ORDER, 1)
    for part in desc.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        if k not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {k!r}; valid: {AXIS_ORDER}")
        sizes[k] = 1 if int(v) == -1 else int(v)
    _check_one_device(sizes)
    return sizes


def _check_one_device(mesh: dict) -> None:
    if math.prod(mesh.values()) > 1:
        raise NotImplementedError(
            f"mesh {mesh} spans more than one device; the mesh is not ported "
            "yet (ROADMAP queue 1, mesh/TP item)")


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
    def step(self, params: dict, grads: list, state: dict) -> torch.Tensor:
        """Apply one update to ``params`` and ``state`` in place; ``grads``
        in ``_leaves(params)`` order -> the global norm of the unclipped
        gradients (a 0-d tensor)."""
        gnorm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
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
    mesh: dict
    config: transformer.TransformerConfig
    optimizer: AdamW
    # (params, tokens, targets) -> scalar loss with no optimizer update
    eval_fn: Callable = None


def create_train_step(cfg: transformer.TransformerConfig, mesh: dict | None = None,
                      generator: torch.Generator | None = None,
                      optimizer: AdamW | None = None, device=None,
                      params: dict | None = None) -> TrainStepBundle:
    """Parameters (``params``, or ``transformer.init`` from ``generator``,
    default seed 0), optimizer state and the step on one device."""
    mesh = dict(mesh) if mesh is not None else mesh_from_string("")
    _check_one_device(mesh)
    device = resolve_device(device)
    if params is None:
        generator = generator or torch.Generator(device=device).manual_seed(0)
        params = transformer.init(cfg, generator, device)
    leaves = [p for _, p in _leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    optimizer = optimizer or make_optimizer()
    opt_state = optimizer.init(params)

    def step(params, opt_state, tokens, targets):
        loss = transformer.loss_fn(params, tokens, targets, cfg)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = optimizer.step(params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    @torch.no_grad()
    def eval_loss(params, tokens, targets):
        return transformer.loss_fn(params, tokens, targets, cfg)

    return TrainStepBundle(step_fn=step, params=params, opt_state=opt_state,
                           mesh=mesh, config=cfg, optimizer=optimizer,
                           eval_fn=eval_loss)


def make_forward(cfg: transformer.TransformerConfig) -> Callable:
    """Inference forward (logits only)."""

    @torch.no_grad()
    def fwd(params, tokens):
        return transformer.apply(params, tokens, cfg)[0]

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
           "make_optimizer", "mesh_from_string", "synthetic_lm_batch"]
