"""Flash attention forward and backward (port of the JAX package's
ops/attention.py).

[B, H, L, D] layout, out and per-row logsumexp. On a CUDA tensor the work
runs in hand-written kernels: the forward in ``csrc/flash_fwd.cu`` (one
kernel for the TPU package's streaming and VMEM-resident tiers), the
backward in ``csrc/flash_bwd.cu`` (a dK/dV kernel and a dQ kernel, for the
TPU package's three backward tiers). On a CPU tensor the same autograd
Function runs ``_flash_fwd_reference`` and ``_flash_bwd_reference``, the
plain PyTorch versions of the same functions, so the CPU tests exercise the
backward that the card's kernels are held against. A CUDA tensor outside the
kernels' envelope raises: there is no fallback.

The lse output is differentiable: the backward folds its cotangent into
``delta`` (the JAX package's ``_flash_bwd``), as ring attention needs.
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel.ring_attention import NEG_INF
from . import _build

# dtypes and head dims the CUDA kernel is compiled for
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)

# kernel launches since the last reset (see reset_launches)
launches = 0              # flash_fwd
bwd_dkdv_launches = 0     # flash_bwd_dkdv
bwd_dq_launches = 0       # flash_bwd_dq


def reset_launches() -> None:
    global launches, bwd_dkdv_launches, bwd_dq_launches
    launches = bwd_dkdv_launches = bwd_dq_launches = 0


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


def _flash_bwd_reference(q, k, v, o, lse, g, g_lse, causal, scale, window):
    """Plain version of the backward kernels: the gradients of
    ``_flash_fwd_reference``'s (out, lse) with cotangents (g, g_lse) ->
    (dq, dk, dv) in the inputs' dtypes, all products in float32. ``g_lse``
    may be None (only out was used). p is selected to 0 where masked: a row
    with no visible key has lse NEG_INF, so exp(s - lse) is inf there."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = _visible(q.shape[2], k.shape[2], causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = _delta(o, g, g_lse)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(o, g, g_lse):
    """rowsum(dO * O) - g_lse, [B, H, Lq] float32: d lse_i / d s_ij = p_ij, so
    the lse cotangent enters ds = p (dp - delta) as a shift of delta."""
    delta = (g.float() * o.float()).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


def _grad_like(t):
    """An output buffer for t's gradient, in t's layout where that has unit
    stride over D (no copy on either side of a transposed view)."""
    out = torch.empty_like(t)
    if out.stride(-1) != 1:
        out = torch.empty_like(t, memory_format=torch.contiguous_format)
    return out


def _bwd_args(q, k, v, g, dq, dk, dv, causal, scale, window):
    """The arguments both backward kernels share after their pointers."""
    b, h, lq, d = q.shape
    strides = (ctypes.c_longlong * 21)(*(
        x for t in (q, k, v, g, dq, dk, dv) for x in t.stride()[:3]))
    scale = (d ** -0.5) if scale is None else float(scale)
    return (b, h, lq, k.shape[2], d, KERNEL_DTYPES[q.dtype], strides, scale,
            int(causal), int(window or 0),
            torch.cuda.current_stream(q.device).cuda_stream)


def _flash_bwd_dkdv_cuda(q, k, v, g, lse, delta, causal, scale, window):
    """Launch the dK/dV kernel -> (dk, dv). ``g`` has unit stride over D;
    ``lse`` and ``delta`` are contiguous float32 [B, H, Lq]."""
    global bwd_dkdv_launches
    dk, dv = _grad_like(k), _grad_like(v)
    err = _build.kernel("tony_flash_bwd_dkdv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_bwd_args(q, k, v, g, q, dk, dv, causal, scale, window))
    _build.check("flash_bwd_dkdv", err)
    bwd_dkdv_launches += 1
    return dk, dv


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale, window):
    """Launch the dQ kernel -> dq (same inputs as the dK/dV kernel)."""
    global bwd_dq_launches
    dq = _grad_like(q)
    err = _build.kernel("tony_flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_bwd_args(q, k, v, g, dq, k, v, causal, scale, window))
    _build.check("flash_bwd_dq", err)
    bwd_dq_launches += 1
    return dq


def _flash_bwd_cuda(q, k, v, o, lse, g, g_lse, causal, scale, window):
    """csrc/flash_bwd.cu: the dK/dV kernel, then the dQ kernel. delta is
    computed here with PyTorch ops, as the TPU package computes it outside
    its kernels."""
    _check_kernel_inputs(q, k, v)
    if g.dtype != q.dtype or g.shape != q.shape:
        raise ValueError(f"dO must match q: got {g.dtype} {tuple(g.shape)}, "
                         f"q {q.dtype} {tuple(q.shape)}")
    if g.stride(-1) != 1:
        # e.g. the expanded all-zero-stride cotangent of out.sum()
        g = g.contiguous()
    delta = _delta(o, g, g_lse).contiguous()
    lse = lse.float().contiguous()
    dk, dv = _flash_bwd_dkdv_cuda(q, k, v, g, lse, delta, causal, scale,
                                  window)
    dq = _flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale, window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention as one autograd node: the CUDA kernels for a CUDA
    tensor, the plain versions for a CPU tensor, forward and backward. Saves
    q, k, v, out and lse; the backward never re-runs the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        fwd = _flash_fwd_cuda if q.is_cuda else _flash_fwd_reference
        out, lse = fwd(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        # a cotangent that never arrives stays None (only out, or only lse,
        # was used) instead of being materialised as zeros
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        bwd = _flash_bwd_cuda if q.is_cuda else _flash_bwd_reference
        dq, dk, dv = bwd(q, k, v, out, lse, g_out, g_lse, ctx.causal,
                         ctx.scale, ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q, k, v, causal=True, scale=None, window=None):
    """[B, H, L, D] -> (out [B,H,L,D], lse [B,H,L] f32), both differentiable.
    The CUDA kernels on a CUDA tensor, the plain versions on a CPU tensor."""
    _validate_window(causal, window)
    return _FlashAttention.apply(q, k, v, causal, scale, window)


def flash_attention(q, k, v, causal=True, scale=None, window=None):
    """Fused attention, [B, H, L, D] layout -> out. ``window``: each position
    sees its last ``window`` positions inclusive (requires causal=True)."""
    return flash_attention_with_lse(q, k, v, causal, scale, window)[0]


def attention_blhd(q, k, v, causal=True, scale=None, window=None):
    """flash_attention for the model's [B, L, H, D] layout. On CUDA the
    kernels read the transposed views through their strides; without a
    gradient the forward writes a [B, L, H, D] buffer, so neither side is
    copied."""
    _validate_window(causal, window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(qt, kt, vt, causal, scale, window)[0] \
            .transpose(1, 2)
    if not q.is_cuda:
        return _flash_fwd_reference(qt, kt, vt, causal, scale, window)[0] \
            .transpose(1, 2)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _flash_fwd_cuda(qt, kt, vt, causal, scale, window, out=out.transpose(1, 2))
    return out


__all__ = ["flash_attention", "flash_attention_with_lse", "flash_supported",
           "attention_blhd", "launches", "bwd_dkdv_launches",
           "bwd_dq_launches", "reset_launches"]
