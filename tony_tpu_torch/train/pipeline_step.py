"""Pipeline-parallel training step for the flagship transformer (port of
the JAX package's train/pipeline_step.py).

The ``pipe`` mesh axis carries contiguous runs of decoder layers: stage s
holds layers [s·n/S, (s+1)·n/S) of the [n_layers, ...] stack, while the
embedding, the final norm and the unembedding are replicated on every
stage; microbatches flow stage to stage over the ring (parallel/
pipeline.py). Each stage runs ``transformer._layer`` with no plan, so on
the card its attention is the flash custom op: K1 forward, K3-K5 in the
backward.

Three schedules:
- "gpipe": the forward pipeline; its backward walks the ticks in reverse
  and keeps every microbatch's residuals (O(M)).
- "1f1b": PipeDream-flush, forward and backward in one schedule with a
  residual ring of 2S-1 stage inputs and the stage recomputed in the
  backward (K1 twice a layer a microbatch), so activation memory does not
  grow with the microbatch count.
- "circular": the interleaved schedule; each stage holds ``num_chunks``
  non-adjacent layer chunks, kept in the schedule's [V, S, per_chunk]
  layout (the stage's block [V, 1, per_chunk]).

The loss is the JAX package's: gpipe and circular take the CE mean over
the whole batch plus ``aux_loss_weight · aux_sum / M``; 1F1B's head
returns token sums, divided by the global count of valid tokens, so
padding that falls unevenly across microbatches weighs every token alike.
MoE layers route per microbatch under pipelining (each microbatch routes
on its own), the JAX package's documented difference from the
unpipelined step.

Every rank passes the step the whole batch (replicated over ``pipe``)
and the trees it was given: ``params`` holds this stage's block of the
layer stack and its own copy of the replicated leaves. The schedules
return the replicated leaves' gradients on every stage (the head's and
the input's gradients are summed over ``pipe`` inside them, as the JAX
psums), so AdamW moves every copy alike; the clip's global norm sums the
layer stack's squares over ``pipe`` and counts each replicated leaf once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..device import resolve_device
from ..models import transformer
from ..parallel.collectives import all_reduce_, group_rank, group_size
from ..parallel.pipeline import (
    make_pipeline_1f1b, make_pipeline_circular, make_pipeline_stacked,
)
from .step import AdamW, _leaves, make_optimizer

SCHEDULES = ("gpipe", "1f1b", "circular")


@dataclass
class PipelineBundle:
    # (params, opt_state, tokens, targets) -> (params, opt_state, metrics)
    step_fn: Callable
    # (params, tokens, targets) -> scalar loss (the forward pipeline)
    loss_fn: Callable
    params: Any
    opt_state: Any
    mesh: Any
    config: transformer.TransformerConfig
    schedule: str = "gpipe"
    optimizer: AdamW | None = None


def stage_layers(layers: dict, n_stages: int, stage: int, schedule: str,
                 num_chunks: int = 2) -> dict:
    """This stage's block of a whole [n_layers, ...] layer stack: its run
    [n/S, ...], or (circular) its chunks [V, 1, per_chunk, ...] of the
    [V, S, per_chunk, ...] layout. Copies."""
    def block(w):
        if schedule == "circular":
            per = w.shape[0] // (n_stages * num_chunks)
            return w.reshape((num_chunks, n_stages, per)
                             + tuple(w.shape[1:]))[:, stage:stage + 1]
        per = w.shape[0] // n_stages
        return w[stage * per:(stage + 1) * per]

    return {k: block(w).detach().clone() for k, w in layers.items()}


def create_pipeline_train_step(cfg: transformer.TransformerConfig, mesh,
                               num_microbatches: int,
                               generator: torch.Generator | None = None,
                               optimizer: AdamW | None = None,
                               schedule: str = "gpipe", num_chunks: int = 2,
                               device=None,
                               params: dict | None = None) -> PipelineBundle:
    """The pipelined step on ``mesh``'s ``pipe`` axis (module docstring),
    from ``params`` (the same whole tree on every rank) or
    ``transformer.init`` from ``generator`` (default seed 0)."""
    pipe = mesh.get_group("pipe")
    n_stages, stage = group_size(pipe), group_rank(pipe)
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers {cfg.n_layers} not divisible by pipe={n_stages}")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if schedule == "circular":
        if cfg.n_layers % (n_stages * num_chunks):
            raise ValueError(
                f"n_layers {cfg.n_layers} not divisible by stages*chunks "
                f"{n_stages * num_chunks}")
        if num_microbatches % n_stages:
            raise ValueError(
                f"circular schedule needs num_microbatches "
                f"({num_microbatches}) divisible by pipe stages "
                f"({n_stages})")
    if device is None:
        device = ("cpu" if getattr(mesh, "device_type", "cuda") == "cpu"
                  else None)
    device = resolve_device(device)
    if params is None:
        generator = generator or torch.Generator(device=device).manual_seed(0)
        params = transformer.init(cfg, generator, device)
    params = {
        "embed": params["embed"].detach().clone(),
        "layers": stage_layers(params["layers"], n_stages, stage, schedule,
                               num_chunks),
        "final_norm": params["final_norm"].detach().clone(),
        "unembed": params["unembed"].detach().clone(),
    }
    optimizer = optimizer or make_optimizer()
    opt_state = optimizer.init(params)
    m = num_microbatches

    def stage_fn(local_stack, x):
        """This stage's run of layers (or one chunk); x: [mb, L, d_model]
        -> (y, aux sum over the layers)."""
        b, l, _ = x.shape
        positions = torch.arange(l, device=x.device).expand(b, l)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        n = next(iter(local_stack.values())).shape[0]
        for i in range(n):
            x, a = transformer._layer(
                cfg, x, positions, {k: w[i] for k, w in local_stack.items()})
            aux = aux + a
        return x, aux

    def embed_fwd(params, tokens):
        return params["embed"].to(cfg.dtype)[tokens]

    if schedule == "circular":
        fwd_pipeline = make_pipeline_circular(
            mesh, stage_fn, m, num_chunks, has_aux=True, expect_chunked=True)
    else:
        fwd_pipeline = make_pipeline_stacked(mesh, stage_fn, m, has_aux=True)

    def fwd_loss(params, tokens, targets):
        x = embed_fwd(params, tokens)
        x, aux_sum = fwd_pipeline(params["layers"], x)
        x = transformer.rms_norm(x, params["final_norm"], cfg.norm_eps)
        ce = transformer.token_nll(x, params["unembed"], targets, cfg)
        return ce + cfg.aux_loss_weight * aux_sum / m

    if schedule == "1f1b":
        def head_fn(head_params, y, tgt):
            x = transformer.rms_norm(y, head_params["final_norm"],
                                     cfg.norm_eps)
            # the SUM of token NLLs; the pipeline divides by the GLOBAL
            # valid count
            return transformer.token_nll(x, head_params["unembed"], tgt, cfg,
                                         reduction="sum")

        pipeline = make_pipeline_1f1b(
            mesh, stage_fn, head_fn, m, aux_weight=cfg.aux_loss_weight,
            loss_denom_fn=lambda t: (t >= 0).sum().clamp_min(1))

        def loss_and_grads(params, tokens, targets):
            head = {"final_norm": params["final_norm"],
                    "unembed": params["unembed"]}
            with torch.no_grad():
                x = embed_fwd(params, tokens)
            loss, dlayers, dhead, dx = pipeline(params["layers"], head, x,
                                                targets)
            # the embedding's gradient: each token's dx row added to its row
            dembed = torch.zeros_like(params["embed"]).index_add_(
                0, tokens.reshape(-1),
                dx.reshape(-1, dx.shape[-1]).to(params["embed"].dtype))
            grads = {"embed": dembed, "layers": dlayers,
                     "final_norm": dhead["final_norm"],
                     "unembed": dhead["unembed"]}
            return loss, [g for _, g in _leaves(grads)]
    else:
        def loss_and_grads(params, tokens, targets):
            leaves = [p.requires_grad_(True) for _, p in _leaves(params)]
            loss = fwd_loss(params, tokens, targets)
            grads = list(torch.autograd.grad(loss, leaves))
            for p in leaves:
                p.requires_grad_(False)
            return loss, grads

    def global_norm(params, grads):
        """The norm of the whole gradient: the layer stack's squares summed
        over ``pipe``, each replicated leaf counted once."""
        sq = {"layers": 0.0, "rest": 0.0}
        for (name, _), g in zip(_leaves(params), grads):
            key = "layers" if name.startswith("layers.") else "rest"
            sq[key] = sq[key] + torch.linalg.vector_norm(g.float()) ** 2
        layers = sq["layers"].reshape(1).clone()
        all_reduce_(layers, pipe)
        return torch.sqrt(layers[0] + sq["rest"])

    def step(params, opt_state, tokens, targets):
        loss, grads = loss_and_grads(params, tokens, targets)
        gnorm = global_norm(params, grads)
        optimizer.step(params, grads, opt_state, gnorm=gnorm)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    @torch.no_grad()
    def loss_fn(params, tokens, targets):
        # loss-only evaluation goes through the forward pipeline: the 1F1B
        # apply computes every gradient, ~3x a forward
        return fwd_loss(params, tokens, targets)

    return PipelineBundle(step_fn=step, loss_fn=loss_fn, params=params,
                          opt_state=opt_state, mesh=mesh, config=cfg,
                          schedule=schedule, optimizer=optimizer)


__all__ = ["PipelineBundle", "create_pipeline_train_step", "stage_layers",
           "SCHEDULES"]
