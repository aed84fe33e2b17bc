"""Ulysses-style sequence parallelism: all-to-all head-sharded attention (port
of the JAX package's parallel/ulysses.py).

Activations arrive sequence-sharded over a process group (the ``seq`` mesh
axis's); two all-to-alls bracket the attention:

    [B, L/n, H, D] --all_to_all--> [B, L, H/n, D]   (gather seq, scatter heads)
        full-sequence attention on H/n local heads
    [B, L, H/n, D] --all_to_all--> [B, L/n, H, D]   (scatter seq, gather heads)

Inside the bracket each rank sees the whole sequence for its heads, so any
one-device attention works unchanged: the flash kernels (K1, K3-K5) on a
CUDA tensor, the plain attention on a CPU tensor. The all-to-alls are
differentiable (collectives.all_to_all), so autograd carries the gradient
back through them.
"""

from __future__ import annotations

import functools
from typing import Callable

from .collectives import all_to_all, group_size
from .ring_attention import reference_attention


def ulysses_attention(q, k, v, group=None, causal: bool = True,
                      scale: float | None = None,
                      attn_fn: Callable | None = None):
    """Call on every rank of ``group`` with its [B, L/n, H, D] blocks.
    ``attn_fn(q, k, v)`` runs on the full-sequence, head-sliced blocks; the
    default is the flash kernels on a CUDA tensor and the plain attention
    on a CPU tensor. Requires heads % group size == 0 (GQA K/V are repeated
    to H heads before the call: models/transformer.py)."""
    n = group_size(group)
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(f"ulysses needs heads ({h}) divisible by axis size "
                         f"({n})")
    if attn_fn is None:
        if q.is_cuda:
            from ..ops.attention import attention_blhd

            attn_fn = functools.partial(attention_blhd, causal=causal,
                                        scale=scale)
        else:
            attn_fn = functools.partial(reference_attention, causal=causal,
                                        scale=scale)
    qh, kh, vh = (all_to_all(x, 2, 1, group) for x in (q, k, v))
    return all_to_all(attn_fn(qh, kh, vh), 1, 2, group)


def make_ulysses_attention(mesh, axis_name: str = "seq", causal: bool = True,
                           attn_fn: Callable | None = None) -> Callable:
    """Ulysses attention over ``mesh``'s ``axis_name`` group: a function of
    this rank's [B, L/n, H, D] blocks -> its output block."""
    group = mesh.get_group(axis_name) if mesh is not None else None
    return functools.partial(ulysses_attention, group=group, causal=causal,
                             attn_fn=attn_fn)


__all__ = ["ulysses_attention", "make_ulysses_attention"]
