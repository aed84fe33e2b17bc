"""Mixture-of-Experts FFN with expert parallelism over the ``expert`` mesh
axis (port of the JAX package's parallel/expert.py).

Einsum-dispatch MoE (Switch/GShard style): a top-k router builds dispatch
and combine tensors [tokens, experts, capacity], the tokens are gathered
into each expert's capacity slots by one product, every expert runs its FFN
on its slots, and a second product scatters the results back weighted by
the gates. Capacity-factor dropping keeps every shape static; a dropped
token passes through on the residual stream.

The products are plain ``torch.einsum`` (matrix products): the JAX package
computes them outside any Pallas kernel too.

On a mesh (``plan``, parallel/spmd.py) the JAX package's GSPMD program
routes the global token set; so does the port, with each rank holding its
block of the tokens:

- capacity counts every token of the global batch;
- a token's queue position is its place in the global flat order b·L + l
  (the batch ranks' blocks in batch-rank order, each row's sequence
  blocks in seq-rank order), slot round by slot round: the ranks
  all-gather their top-k expert indices (int32, [T_local, k]) over the
  batch and ``seq`` axes, every rank computes every position (no
  gradient) and keeps its own tokens' rows;
- the combine weights come from the rank's own logits, so the router's
  gradient is the rank's share of the global one;
- a rank computes with its ``E / ep`` experts (the ``expert`` axis) and
  its share of their hidden units (the ``mlp`` axis), and the output is
  summed over both axes (``reduce_from``), Megatron's way: the tokens and
  the router enter through ``copy_to``, so their gradients sum the ranks'
  shares;
- ``load_balancing_loss`` takes its means over the global batch; its
  gradient is the rank's share (``Plan.global_sum``).

A capacity factor of at least E/k (decode and serving, ``moe_dropfree``)
keeps every token whatever its position, and a kept token's output does not
depend on its slot: there each rank routes its own tokens alone, with no
gather, and the output is the same.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from .collectives import copy_to, gather_nograd, reduce_from


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _gates(router_logits: torch.Tensor, k: int):
    """(probs [T, E] float32, the k gates normalized per token [T, k],
    their experts [T, k])."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


def queue_positions(gate_idx: torch.Tensor, e: int, capacity: int):
    """Each claim's place in its expert's queue, [T, k] int64 (``capacity``
    for a dropped claim): tokens claim slots slot round by slot round
    (every token's first choice, then every second, ...) and within a
    round in token order; a round sees the claims kept in earlier rounds."""
    pos = torch.empty_like(gate_idx, dtype=torch.int64)
    prior = gate_idx.new_zeros((e,), dtype=torch.int64)
    for slot in range(gate_idx.shape[1]):
        idx = gate_idx[:, slot].long()
        onehot = F.one_hot(idx, e)                                 # [T, E]
        within = torch.cumsum(onehot, dim=0) - onehot
        mine = (within + prior).gather(1, idx[:, None])[:, 0]
        keep = mine < capacity
        prior = prior + (onehot * keep[:, None]).sum(0)
        pos[:, slot] = torch.where(keep, mine, capacity)
    return pos


def _dispatch_combine(gate_vals, gate_idx, pos, e: int, capacity: int):
    """(dispatch [T, E, C], combine [T, E, C]) float32 of the claims at
    ``pos``; a dropped claim (pos == capacity) gets a zero row."""
    t = gate_idx.shape[0]
    dispatch = gate_vals.new_zeros((t, e, capacity))
    combine = gate_vals.new_zeros((t, e, capacity))
    for slot in range(gate_idx.shape[1]):
        onehot = F.one_hot(gate_idx[:, slot], e).to(gate_vals.dtype)
        # dropped -> index `capacity`, sliced away: a zero row
        pos_oh = F.one_hot(pos[:, slot], capacity + 1)[:, :capacity].to(
            gate_vals.dtype)                                      # [T, C]
        claim = onehot[:, :, None] * pos_oh[:, None, :]           # [T, E, C]
        dispatch = dispatch + claim
        combine = combine + claim * gate_vals[:, slot][:, None, None]
    return dispatch, combine


def top_k_routing(router_logits: torch.Tensor, k: int, capacity: int):
    """router_logits [T, E] -> (dispatch [T, E, C], combine [T, E, C]),
    float32.

    Greedy position assignment (``queue_positions``): a token over
    capacity gets a zero row (combine weight 0)."""
    e = router_logits.shape[1]
    _, gate_vals, gate_idx = _gates(router_logits, k)
    pos = queue_positions(gate_idx, e, capacity)
    return _dispatch_combine(gate_vals, gate_idx, pos, e, capacity)


def global_queue_positions(gate_idx: torch.Tensor, e: int, capacity: int,
                           plan, shape: tuple) -> torch.Tensor:
    """``queue_positions`` of this rank's tokens ([b * l, k], of its
    [b, l] block) in the global flat order (module docstring): the expert
    indices gathered over the ``seq`` axis and the batch axes."""
    b, l = shape
    idx = gate_idx.to(torch.int32).reshape(b, l, -1)
    if plan.seq_axis and plan.shape.get(plan.seq_axis, 1) > 1:
        idx = gather_nograd(idx, 1, plan.group(plan.seq_axis))
    for a in reversed(plan.batch_axes):              # minor axis first
        idx = gather_nograd(idx, 0, plan.group(a))
    big_b, big_l, k = idx.shape
    pos = queue_positions(idx.reshape(big_b * big_l, k), e, capacity)
    r0, c0 = plan.batch_rank * b, plan.seq_rank * l
    return pos.reshape(big_b, big_l, k)[r0:r0 + b, c0:c0 + l].reshape(-1, k)


def capacity_for(tokens: int, k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Slots an expert: ``max(1, int(cf * T * k / E + 1e-6))``. The 1e-6
    keeps an exactly integral product from truncating down, so a capacity
    factor of E/k guarantees capacity >= T (the drop-free decode contract
    in models/generate.py: (4/3) * 21 / 4 is 6.999... in floating point)."""
    return max(1, int(capacity_factor * tokens * k / n_experts + 1e-6))


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
            w_out: torch.Tensor, k: int = 2, capacity_factor: float = 1.25,
            activation: Callable = _gelu,
            w_in_scale: torch.Tensor | None = None,
            w_out_scale: torch.Tensor | None = None, plan=None,
            shape: tuple | None = None) -> torch.Tensor:
    """x [T, d], router_w [d, E], w_in [E, d, f], w_out [E, f, d] -> [T, d]
    in x's dtype.

    The router logits are float32 (x and router_w upcast); dispatch and
    combine are cast to x's dtype before the four products.
    ``w_in_scale`` [E, 1, f] / ``w_out_scale`` [E, 1, d] are per-expert,
    per-output-channel dequantization scales of int8 expert weights (w8a16
    decode), applied AFTER each expert product, broadcast over the
    capacity slots.

    With a ``plan``: SPMD over this rank's tokens (``shape`` = (b, l), the
    [b, l] block they flatten), its experts ``w_in`` [E/ep, d, f/tp] and
    ``w_out`` [E/ep, f/tp, d]; the output is this rank's tokens' whole
    output (module docstring)."""
    t, _ = x.shape
    e = router_w.shape[1]
    eg = tg = None
    routed_globally = False
    capacity = capacity_for(t, k, e, capacity_factor)
    if plan is not None:
        eg, tg = plan.ep_group, plan.tp_group("mlp")
        x = copy_to(copy_to(x, tg), eg)
        router_w = copy_to(copy_to(router_w, tg), eg)
        n = math.prod(plan.shape[a] for a in plan.data_axes)
        if n > 1 and capacity_for(t * n, k, e, capacity_factor) < t * n:
            capacity = capacity_for(t * n, k, e, capacity_factor)
            routed_globally = True
    logits = x.float() @ router_w.float()
    _, gate_vals, gate_idx = _gates(logits, k)
    if routed_globally:
        pos = global_queue_positions(gate_idx, e, capacity, plan,
                                     shape or (1, t))
    else:
        pos = queue_positions(gate_idx, e, capacity)
    dispatch, combine = _dispatch_combine(gate_vals, gate_idx, pos, e,
                                          capacity)
    e_local = w_in.shape[0]
    if e_local != e:
        lo = plan.ep_rank * e_local
        dispatch, combine = (dispatch[:, lo:lo + e_local],
                             combine[:, lo:lo + e_local])
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)

    xs = torch.einsum("td,tec->ecd", x, dispatch)                 # [E, C, d]
    h = torch.einsum("ecd,edf->ecf", xs, w_in.to(x.dtype))
    if w_in_scale is not None:
        h = h * w_in_scale
    h = activation(h)
    ys = torch.einsum("ecf,efd->ecd", h, w_out.to(x.dtype))       # [E, C, d]
    if w_out_scale is not None:
        ys = ys * w_out_scale
    out = torch.einsum("ecd,tec->td", ys, combine)
    return reduce_from(reduce_from(out, tg), eg)


def load_balancing_loss(router_logits: torch.Tensor, k: int = 2,
                        plan=None) -> torch.Tensor:
    """Switch-transformer aux loss: E * dot(fraction of routed tokens,
    mean router probability), float32. With a ``plan``, of this rank's
    tokens' logits: the global batch's loss, its gradient this rank's
    share."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    t, e = probs.shape
    idx = torch.topk(probs, k, dim=-1).indices
    onehot = F.one_hot(idx, e).float().sum(dim=-2)                # [T, E]
    if plan is None or not plan.data_axes:
        tokens_frac = onehot.mean(dim=0) / k
        probs_frac = probs.mean(dim=0)
    else:
        n = plan.global_count(torch.tensor(float(t), device=probs.device))
        tokens_frac = plan.global_count(onehot.sum(dim=0)) / n / k
        probs_frac = plan.global_sum(probs.sum(dim=0)) / n
    return e * torch.sum(tokens_frac * probs_frac)


__all__ = ["top_k_routing", "queue_positions", "global_queue_positions",
           "capacity_for", "moe_ffn", "load_balancing_loss"]
