"""Ring attention: exact attention over sequence-sharded activations (port of
the JAX package's parallel/ring_attention.py), and the plain attention.

Q/K/V are sharded along the sequence over a process group (the ``seq`` mesh
axis's); each rank holds one block of L/n positions. K/V blocks travel the
ring by P2P (``collectives.Ring``, the JAX ``lax.ppermute``) while each rank
folds every block into its own queries with a streaming softmax, so the
L x L score matrix never exists and a rank's memory stays O(L/n). At step t
rank ``me`` holds the block that started on rank ``(me - t) mod n``: with a
causal mask, blocks from earlier ranks are fully visible ("full"), the
rank's own block is triangular ("diag"), later blocks are hidden ("skip").

Two per-step computations, as in the JAX package:

- ``ring_attention``: einsum blocks with running (max, sum, out) partials.
  Its gradient is autograd's through the loop, the K/V shift included
  (``collectives.ring_shift`` sends a block's gradient back to its sender).
- ``ring_flash_attention``: each step runs the flash forward (K1:
  ``flash_attention``'s kernel on a CUDA tensor, its plain version on a CPU
  tensor) for (local Q, visiting K/V) -> (out_t, lse_t), merged by
  logaddexp weights. Its backward is written out (``_RingFlash``): it keeps
  q, k, v and the merged out and lse, and runs the ring again; each visible
  step calls the flash backward (K3-K5) with the merged out and lse, which
  makes a block's gradient its share of the whole row's softmax (the lse
  cotangent enters each step the same way), and the dK/dV accumulators
  travel with their blocks, one shift a step, back to their owners after n
  steps. The JAX package gets the same sums by differentiating scan +
  ppermute.

The per-step math (``flash_block_fwd``, ``merge``, ``flash_block_bwd``) and
one rank's walk over its schedule (``ring_flash_fwd_rank``,
``ring_flash_bwd_rank``) take their K/V blocks from an iterator, apart from
any transport: ``_RingFlash`` feeds them from the P2P ring, and
``replay_ring_flash`` replays every rank of an n-rank ring in one process
from the blocks of one whole sequence.

Shapes follow the model's convention, [batch, seq, heads, head_dim], at the
public functions; the flash path carries K/V in the kernels' [B, H, L, D].
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from .collectives import Ring, ring_shift

NEG_INF = -1e30
FULL, DIAG, SKIP = "full", "diag", "skip"


def block_case(rank: int, t: int, n: int, causal: bool) -> tuple[int, str]:
    """(src, case) of rank ``rank``'s step ``t``: the block's owner and
    whether it is fully visible, triangular or hidden."""
    src = (rank - t) % n
    if not causal or src < rank:
        return src, FULL
    return src, DIAG if src == rank else SKIP


# ---------------------------------------------------------------- einsum ring

def _block_attn(q32, k, v, scale, mask):
    """Masked stable partial softmax of one (q-block, kv-block) pair ->
    (m, l, o) partials in float32; q32 [b, q, h, d] float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)                                   # [b, h, q]
    p = torch.exp(s - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m, l, o


def _to_blhd(x):
    """[b, h, q] -> [b, q, h, 1]."""
    return x.transpose(1, 2)[..., None]


def ring_attention(q, k, v, group=None, causal: bool = True,
                   scale: float | None = None):
    """Einsum-block ring attention on this rank's [B, L/n, H, D] blocks,
    sequence-sharded over ``group`` in rank order (call it on every rank)."""
    ring = Ring(group)
    n, me = ring.n, ring.rank
    b, lq, h, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    q32 = q.float()
    tri = torch.tril(torch.ones(lq, k.shape[1], dtype=torch.bool,
                                device=q.device))
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for t in range(n):
        _, case = block_case(me, t, n, causal)
        # a hidden block runs all-masked, as in the JAX package: every
        # rank's graph then holds every shift, so each rank's backward
        # runs the same P2P exchanges
        mask = {FULL: None, DIAG: tri, SKIP: torch.zeros_like(tri)}[case]
        bm, bl, bo = _block_attn(q32, kb, vb, scale, mask)
        m_new = torch.maximum(m, bm)
        corr, bcorr = torch.exp(m - m_new), torch.exp(bm - m_new)
        l = l * corr + bl * bcorr
        o = o * _to_blhd(corr) + bo * _to_blhd(bcorr)
        m = m_new
        if t < n - 1:
            kb, vb = ring_shift(ring, kb, vb)
    l_safe = torch.where(l > 0, l, 1.0)
    return (o / _to_blhd(l_safe)).to(q.dtype)


# ----------------------------------------------------------------- flash ring

def flash_block_fwd(q, k, v, case: str, scale):
    """One visible step: the flash forward of (q, k, v), [B, H, L, D] ->
    (out_t float32, lse_t)."""
    from ..ops.attention import flash_fwd

    o, lse = flash_fwd(q, k, v, case == DIAG, scale, None)
    return o.float(), lse


def merge(out, lse, o_t, lse_t):
    """Fold one step's (out_t, lse_t) into the running (out, lse)."""
    lse_new = torch.logaddexp(lse, lse_t)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_t = torch.exp(lse_t - lse_new)[..., None]
    return out * w_old + o_t * w_t, lse_new


def flash_block_bwd(q, k, v, out, lse, g, g_lse, case: str, scale):
    """One visible step's gradients -> (dq_t, dk_t, dv_t), from the merged
    ``out``/``lse`` and their cotangents."""
    from ..ops.attention import flash_bwd

    return flash_bwd(q, k, v, out, lse, g, g_lse, case == DIAG, scale)


def ring_flash_fwd_rank(q, blocks: Iterable, rank: int, n: int,
                        causal: bool, scale):
    """Rank ``rank``'s forward over its n steps; ``blocks`` yields step t's
    (k, v). -> (out float32, lse), [B, H, L/n, D] and [B, H, L/n]."""
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                     device=q.device)
    for t, (k, v) in enumerate(blocks):
        _, case = block_case(rank, t, n, causal)
        if case != SKIP:
            out, lse = merge(out, lse, *flash_block_fwd(q, k, v, case, scale))
    return out, lse


def ring_flash_bwd_rank(q, blocks: Iterable, out, lse, g, g_lse, rank: int,
                        n: int, causal: bool, scale, sink: Callable):
    """Rank ``rank``'s backward over its n steps -> dq (float32). Step t's
    dK/dV go to ``sink(t, src, dk_t, dv_t)`` (None, None at a hidden
    step)."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for t, (k, v) in enumerate(blocks):
        src, case = block_case(rank, t, n, causal)
        if case == SKIP:
            sink(t, src, None, None)
            continue
        dq_t, dk_t, dv_t = flash_block_bwd(q, k, v, out, lse, g, g_lse,
                                           case, scale)
        dq += dq_t
        sink(t, src, dk_t, dv_t)
    return dq


def _circulate(ring: Ring, k, v):
    """Step t's (k, v) for t = 0..n-1, the next block's transfer in flight
    while the caller computes on the current one."""
    kv = (k, v)
    for t in range(ring.n):
        pending = ring.start_shift(kv) if t < ring.n - 1 else None
        yield kv
        if pending is not None:
            kv = pending()


class _RingFlash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale):
        out, lse = ring_flash_fwd_rank(q, _circulate(ring, k, v), ring.rank,
                                       ring.n, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out.to(q.dtype), lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.ring
        if g is None:
            g = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
        acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]

        def sink(t, src, dk_t, dv_t):
            # the accumulators travel with their block: one shift a step,
            # so after n steps each is back on its owner
            if dk_t is not None:
                acc[0] += dk_t
                acc[1] += dv_t
            acc[:] = ring.shift(acc)

        dq = ring_flash_bwd_rank(q, _circulate(ring, k, v), out, lse, g,
                                 g_lse, ring.rank, ring.n, ctx.causal,
                                 ctx.scale, sink)
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None, None)


def ring_flash_attention_with_lse(q, k, v, group=None, causal: bool = True,
                                  scale: float | None = None):
    """Flash ring attention on this rank's [B, L/n, H, D] blocks -> (out
    [B, L/n, H, D], lse [B, H, L/n] float32), both differentiable."""
    qt = q.transpose(1, 2)
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
    out, lse = _RingFlash.apply(qt, kt, vt, Ring(group), causal, scale)
    return out.transpose(1, 2), lse


def ring_flash_attention(q, k, v, group=None, causal: bool = True,
                         scale: float | None = None):
    """Ring attention with the flash kernels as each step's block
    computation (module docstring); [B, L/n, H, D] in and out."""
    return ring_flash_attention_with_lse(q, k, v, group, causal, scale)[0]


def replay_ring_flash(q, k, v, g, n: int, causal: bool = True,
                      scale: float | None = None, g_lse=None) -> dict:
    """Every rank of an n-rank flash ring in one process, from one whole
    sequence: q, k, v, g (the output's cotangent) [B, H, L, D], split into
    n blocks along L; each rank's forward and backward walk its own
    schedule over the blocks it would receive, and each step's dK/dV is
    added to its block's sum. -> the whole-sequence {"out", "lse", "dq",
    "dk", "dv"} (out and the gradients in q's dtype, lse float32)."""
    qs, ks, vs, gs = (x.chunk(n, dim=2) for x in (q, k, v, g))
    gl = g_lse.chunk(n, dim=2) if g_lse is not None else (None,) * n

    def blocks(r):
        return ((ks[(r - t) % n], vs[(r - t) % n]) for t in range(n))

    fwd = [ring_flash_fwd_rank(qs[r], blocks(r), r, n, causal, scale)
           for r in range(n)]
    dk = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
          for x in ks]
    dv = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
          for x in vs]

    def sink(t, src, dk_t, dv_t):
        if dk_t is not None:
            dk[src] += dk_t
            dv[src] += dv_t

    dq = [ring_flash_bwd_rank(qs[r], blocks(r), fwd[r][0], fwd[r][1], gs[r],
                              gl[r], r, n, causal, scale, sink)
          for r in range(n)]

    def cat(parts, dtype):
        return torch.cat(parts, dim=2).to(dtype)

    return {"out": cat([o for o, _ in fwd], q.dtype),
            "lse": cat([s for _, s in fwd], torch.float32),
            "dq": cat(dq, q.dtype), "dk": cat(dk, k.dtype),
            "dv": cat(dv, v.dtype)}


def make_ring_attention(mesh, axis_name: str = "seq", causal: bool = True,
                        impl: str | None = None) -> Callable:
    """Ring attention over ``mesh``'s ``axis_name`` group: a function of this
    rank's [B, L/n, H, D] q, k, v blocks (call it on every rank of the
    group) -> the rank's output block.

    ``impl``: "flash" (the flash kernels each step), "xla" (einsum blocks),
    or None: flash on a CUDA tensor whose head dim and dtype the kernels
    take (ops.attention.flash_supported), einsum otherwise. "flash" on a
    CPU tensor runs the kernels' plain versions, as the JAX package's tests
    run its kernel in the Pallas interpreter."""
    if impl not in (None, "flash", "xla"):
        raise ValueError(f"impl must be None, 'flash', or 'xla', got {impl!r}")
    group = mesh.get_group(axis_name) if mesh is not None else None

    def fn(q, k, v):
        from ..ops.attention import flash_supported

        ok = flash_supported(q, backward=True)
        chosen = impl
        if chosen is None:
            chosen = "flash" if (q.is_cuda and ok) else "xla"
        elif chosen == "flash" and q.is_cuda and not ok:
            raise ValueError(
                f"impl='flash' takes head_dim in (32, 64, 128) and float32 "
                f"or bfloat16 on CUDA, got head_dim={q.shape[-1]} "
                f"{q.dtype}; use impl=None or 'xla'")
        if chosen == "flash":
            return ring_flash_attention(q, k, v, group, causal)
        return ring_attention(q, k, v, group, causal)

    return fn


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


__all__ = ["NEG_INF", "FULL", "DIAG", "SKIP", "block_case", "ring_attention",
           "flash_block_fwd", "merge", "flash_block_bwd",
           "ring_flash_fwd_rank", "ring_flash_bwd_rank",
           "ring_flash_attention", "ring_flash_attention_with_lse",
           "replay_ring_flash", "make_ring_attention", "reference_attention"]
