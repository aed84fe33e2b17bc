"""Mixture-of-Experts FFN (port of the JAX package's parallel/expert.py,
single device).

Einsum-dispatch MoE (Switch/GShard style): a top-k router builds dispatch
and combine tensors [tokens, experts, capacity], the tokens are gathered
into each expert's capacity slots by one product, every expert runs its FFN
on its slots, and a second product scatters the results back weighted by
the gates. Capacity-factor dropping keeps every shape static; a dropped
token passes through on the residual stream.

The products are plain ``torch.einsum`` (matrix products): the JAX package
computes them outside any Pallas kernel too. Expert sharding (its
``expert`` mesh axis) comes with the mesh slice.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def top_k_routing(router_logits: torch.Tensor, k: int, capacity: int):
    """router_logits [T, E] -> (dispatch [T, E, C], combine [T, E, C]),
    float32.

    Greedy position assignment: tokens claim their experts' capacity slots
    in slot-round order (every token's first choice, then every token's
    second, ...), and within a round in token order; a token over capacity
    gets a zero row (combine weight 0)."""
    t, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)         # [T, k]
    # normalize the k gates per token
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    dispatch = probs.new_zeros((t, e, capacity))
    combine = probs.new_zeros((t, e, capacity))
    # a token's position in its expert's queue = claims on that expert from
    # earlier slot-rounds + earlier tokens within this round
    for slot in range(k):
        onehot = F.one_hot(gate_idx[:, slot], e).to(probs.dtype)  # [T, E]
        prior_per_expert = dispatch.sum(dim=(0, 2))               # [E]
        pos_within = torch.cumsum(onehot, dim=0) - onehot         # [T, E]
        my_pos = torch.einsum("te,te->t", pos_within + prior_per_expert[None],
                              onehot).to(torch.int64)             # [T]
        keep = my_pos < capacity
        # dropped -> index `capacity`, sliced away: a zero row
        pos_oh = F.one_hot(torch.where(keep, my_pos, capacity),
                           capacity + 1)[:, :capacity].to(probs.dtype)
        claim = onehot[:, :, None] * pos_oh[:, None, :]           # [T, E, C]
        dispatch = dispatch + claim
        combine = combine + claim * gate_vals[:, slot][:, None, None]
    return dispatch, combine


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
            w_out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """x [T, d], router_w [d, E], w_in [E, d, f], w_out [E, f, d] -> [T, d]
    in x's dtype.

    The router logits are float32 (x and router_w upcast); dispatch and
    combine are cast to x's dtype before the four products.
    ``w_in_scale`` [E, 1, f] / ``w_out_scale`` [E, 1, d] are per-expert,
    per-output-channel dequantization scales of int8 expert weights (w8a16
    decode), applied AFTER each expert product, broadcast over the
    capacity slots."""
    t, _ = x.shape
    e = router_w.shape[1]
    capacity = capacity_for(t, k, e, capacity_factor)
    logits = x.float() @ router_w.float()
    dispatch, combine = top_k_routing(logits, k, capacity)
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
    return torch.einsum("ecd,tec->td", ys, combine)


def load_balancing_loss(router_logits: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Switch-transformer aux loss: E * dot(fraction of routed tokens,
    mean router probability), float32."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    e = probs.shape[-1]
    idx = torch.topk(probs, k, dim=-1).indices
    onehot = F.one_hot(idx, e).float().sum(dim=-2)                # [T, E]
    tokens_frac = onehot.mean(dim=0) / k
    probs_frac = probs.mean(dim=0)
    return e * torch.sum(tokens_frac * probs_frac)


__all__ = ["top_k_routing", "capacity_for", "moe_ffn", "load_balancing_loss"]
