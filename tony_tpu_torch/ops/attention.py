"""Flash attention forward (port of the JAX package's ops/attention.py).

[B, H, L, D] layout, out and per-row logsumexp. On a CUDA tensor the work
runs in the hand-written kernel ``csrc/flash_fwd.cu`` (one kernel for the
TPU package's streaming and VMEM-resident tiers); on a CPU tensor it runs
in ``_flash_fwd_reference``, the plain PyTorch version of the same function.
A CUDA tensor outside the kernel's envelope raises: there is no fallback.

Forward only. The backward kernels (the TPU package's dQ/dK/dV kernels)
come with the training slice; until then the kernel's autograd Function
raises in ``backward``. The plain CPU version stays differentiable.
"""

from __future__ import annotations

import torch

from ..parallel.ring_attention import NEG_INF
from . import _build

# dtypes and head dims the CUDA kernel is compiled for
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)

launches = 0   # kernel launches since the last reset (see reset_launches)


def reset_launches() -> None:
    global launches
    launches = 0


def _validate_window(causal, window):
    """The kernel's band pruning matches the mask only when causal."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def _visible(lq, lk, causal, window, device):
    """[Lq, Lk] bool: which key each query sees, by absolute indices from 0
    for both (so Lq != Lk cross-attention keeps the TPU kernel's rule)."""
    rows = torch.arange(lq, device=device)[:, None]
    cols = torch.arange(lk, device=device)[None, :]
    mask = torch.ones(lq, lk, dtype=torch.bool, device=device)
    if causal:
        mask = rows >= cols
        if window is not None:
            mask &= cols > rows - window
    return mask


def _flash_fwd_reference(q, k, v, causal, scale, window):
    """Plain version of the kernel: q [B,H,Lq,D], k/v [B,H,Lk,D] ->
    (out [B,H,Lq,D] in q's dtype, lse [B,H,Lq] f32). Scores, softmax and
    the PV product in float32. A row with no visible key gives out 0 and
    lse NEG_INF, as the kernel does."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _visible(q.shape[2], k.shape[2], causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, 1.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l_safe, v.float())
    lse = torch.where(l > 0, m + torch.log(l_safe), NEG_INF)[..., 0]
    return out.to(q.dtype), lse


def flash_supported(q: torch.Tensor) -> bool:
    """The CUDA kernel's envelope, [B, H, L, D] layout: head dim 64 or 128,
    float32 or bfloat16. (The TPU package's `% 128` rule is a Mosaic tiling
    rule and does not apply here.)"""
    return q.shape[-1] in KERNEL_HEAD_DIMS and q.dtype in KERNEL_DTYPES


def _check_kernel_inputs(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash attention: q, k and v must all be on the "
                         "same device")
    if not flash_supported(q):
        raise ValueError(
            f"flash attention kernel takes head_dim in {KERNEL_HEAD_DIMS} "
            f"and dtype float32 or bfloat16, got head_dim={q.shape[-1]} "
            f"dtype={q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or v.shape != k.shape or k.shape[-1] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride over head_dim")
    if b * h > 65535:
        raise ValueError(f"batch*heads={b * h} exceeds the kernel's grid")


def _flash_fwd_cuda(q, k, v, causal, scale, window, out=None):
    """Launch csrc/flash_fwd.cu. ``out`` may be a preallocated [B,H,Lq,D]
    view with unit stride over D (attention_blhd passes a [B,L,H,D]
    buffer transposed, so no copy is made on either side)."""
    global launches
    _check_kernel_inputs(q, k, v)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = (d ** -0.5) if scale is None else float(scale)
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    fn = _build.kernel("tony_flash_fwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), b, h, lq, lk, d, KERNEL_DTYPES[q.dtype],
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], scale, int(causal), int(window or 0),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_fwd", err)
    launches += 1
    return out, lse


class _FlashFwd(torch.autograd.Function):
    """The CUDA kernel as an autograd node: forward only for now."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        return _flash_fwd_cuda(q, k, v, causal, scale, window)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        raise NotImplementedError(
            "flash attention backward on CUDA is not ported yet: the "
            "backward kernels (K3-K5) land with the training slice")


def flash_attention_with_lse(q, k, v, causal=True, scale=None, window=None):
    """[B, H, L, D] -> (out [B,H,L,D], lse [B,H,L] f32). The CUDA kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    _validate_window(causal, window)
    if q.is_cuda:
        return _FlashFwd.apply(q, k, v, causal, scale, window)
    return _flash_fwd_reference(q, k, v, causal, scale, window)


def flash_attention(q, k, v, causal=True, scale=None, window=None):
    """Fused attention, [B, H, L, D] layout -> out. ``window``: each position
    sees its last ``window`` positions inclusive (requires causal=True)."""
    return flash_attention_with_lse(q, k, v, causal, scale, window)[0]


def attention_blhd(q, k, v, causal=True, scale=None, window=None):
    """flash_attention for the model's [B, L, H, D] layout. On CUDA the
    kernel reads the transposed views through their strides and writes a
    [B, L, H, D] buffer, so neither side is copied."""
    _validate_window(causal, window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not q.is_cuda:
        return _flash_fwd_reference(qt, kt, vt, causal, scale, window)[0] \
            .transpose(1, 2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashFwd.apply(qt, kt, vt, causal, scale, window)[0] \
            .transpose(1, 2)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _flash_fwd_cuda(qt, kt, vt, causal, scale, window, out=out.transpose(1, 2))
    return out


__all__ = ["flash_attention", "flash_attention_with_lse", "flash_supported",
           "attention_blhd", "launches", "reset_launches"]
