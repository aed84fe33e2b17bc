"""Plain attention (port of the JAX package's parallel/ring_attention.py
``reference_attention``). Ring attention itself comes with the mesh slice."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def reference_attention(q, k, v, causal: bool = True, scale: float | None = None,
                        window: int | None = None):
    """Plain full attention, [B, L, H, D] in and out; optional sliding
    window (last ``window`` positions inclusive, causal only).

    Masked scores are NEG_INF (not -inf), so a row is never NaN. Scores and
    softmax run in float32; the output is cast back to q's dtype."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        rows = torch.arange(lq, device=q.device)[:, None]
        cols = torch.arange(lk, device=q.device)[None, :]
        mask = rows >= cols
        if window is not None:
            mask &= cols > rows - window
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype)).to(q.dtype)


__all__ = ["NEG_INF", "reference_attention"]
