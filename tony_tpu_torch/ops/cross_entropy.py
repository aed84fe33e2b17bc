"""Blockwise (logits-free) cross-entropy for large vocabularies (port of the
JAX package's ops/cross_entropy.py).

The unembed matmul and the softmax cross-entropy are fused by streaming the
vocabulary in ``block_v`` columns, so no [N, V] logits tensor exists in the
forward or the backward:

- forward: a running (max, sumexp) over vocab blocks (online logsumexp) and
  an in-block gather of each row's target logit;
- backward (``torch.autograd.Function``): one more sweep recomputing each
  block's logits from the saved (x, w, lse); ``ds = g (softmax - onehot)``
  feeds dx (accumulated) and dW (written block by block into one [D, V]
  buffer).

The ragged last block is handled as the JAX package does it: its start is
clamped to ``V - block_v`` and the columns the previous block already owns
are masked, so the unembed is never padded or copied.

The JAX package runs this as an XLA scan of plain matmuls with no Pallas
kernel, so the block products here are ``torch.matmul`` too. Precision
follows the JAX package: block logits in float32 from the storage-dtype
operands (``preferred_element_type=f32``), and the backward's products in
float32.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.collectives import all_reduce_, copy_to

NEG_INF = -1e30
DEFAULT_BLOCK_V = 2048


def _num_blocks(v: int, block_v: int) -> int:
    return -(-v // block_v)


def _block_cols(xf, w, j, block_v, v):
    """Logits of vocab block j in float32 -> (logits [N, BV], start, owned
    mask or None). ``xf`` is x already in float32.

    ``torch.matmul`` of two bf16 tensors rounds its result to bf16, so the
    block of w is upcast to float32 before the product: the product of two
    bf16 values is exact in float32 and the sum is kept in float32, which
    is what the JAX package's ``preferred_element_type=f32`` gives."""
    lo = j * block_v
    start = min(lo, v - block_v)
    logits = xf @ w[:, start:start + block_v].float()
    owned = None
    if v % block_v != 0:
        owned = torch.arange(start, start + block_v, device=xf.device) >= lo
        logits = torch.where(owned, logits, NEG_INF)
    return logits, start, owned


def _ce_fwd_pass(x, w, targets, block_v):
    """-> (nll [N] f32, lse [N] f32)."""
    v = w.shape[1]
    block_v = min(block_v, v)
    n = x.shape[0]
    xf = x.float()
    m = torch.full((n,), NEG_INF, dtype=torch.float32, device=x.device)
    l = torch.zeros(n, dtype=torch.float32, device=x.device)
    tl = torch.zeros(n, dtype=torch.float32, device=x.device)
    for j in range(_num_blocks(v, block_v)):
        logits, start, _ = _block_cols(xf, w, j, block_v, v)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        # in-block target gather: rows whose target this block owns
        lo = j * block_v
        in_blk = (targets >= lo) & (targets < lo + block_v)
        idx = (targets - start).clamp(0, block_v - 1)
        row_logit = logits.gather(1, idx[:, None])[:, 0]
        tl = torch.where(in_blk, row_logit, tl)
    lse = m + torch.log(l.clamp_min(1e-37))
    return lse - tl, lse


class _BlockwiseCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, block_v):
        nll, lse = _ce_fwd_pass(x, w, targets, block_v)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.block_v = block_v
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        v = w.shape[1]
        block_v = min(ctx.block_v, v)
        gf = g.float()
        xf = x.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for j in range(_num_blocks(v, block_v)):
            logits, start, owned = _block_cols(xf, w, j, block_v, v)
            p = torch.exp(logits - lse[:, None])       # masked cols: exp -> 0
            cols = torch.arange(start, start + block_v, device=x.device)
            onehot = cols[None, :] == targets[:, None]
            if owned is not None:
                onehot &= owned                         # target owned elsewhere
            ds = gf[:, None] * (p - onehot.float())     # [N, BV] f32, 0 in overlap
            wj = w[:, start:start + block_v].float()
            dx += ds @ wj.T
            # overlapped columns add exact zeros (ds is 0 there): no double
            # count in the single [D, V] buffer
            dw[:, start:start + block_v] += xf.T @ ds
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def blockwise_cross_entropy(x, w, targets, block_v: int = DEFAULT_BLOCK_V):
    """Per-row softmax cross-entropy of ``x @ w`` against ``targets``
    without materialising the [N, V] logits.

    x: [N, D] hidden states (any float dtype; accumulation in float32)
    w: [D, V] unembedding matrix
    targets: [N] int (the caller masks padding rows out of the result)
    -> nll [N] float32
    """
    return _BlockwiseCE.apply(x, w, targets.long(), block_v)


def dense_cross_entropy(x, w, targets):
    """Reference path: materialise float32 logits (operands upcast, as in
    ``_block_cols``), log_softmax, gather."""
    logits = x.float() @ w.float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, targets[:, None].long())[:, 0]


class _VocabParallelCE(torch.autograd.Function):
    """Softmax cross-entropy of logits split by columns over ``group``: the
    row max, the sum of exponentials and the target's logit are each
    all-reduced, so every rank gets the whole row's nll; the gradient of
    this rank's columns is ``g (softmax - onehot)`` there."""

    @staticmethod
    def forward(ctx, logits, targets, start, group):
        cols = logits.shape[1]
        m = all_reduce_(logits.amax(dim=-1), group, dist.ReduceOp.MAX)
        sumexp = all_reduce_(torch.exp(logits - m[:, None]).sum(dim=-1),
                             group)
        lse = m + torch.log(sumexp)
        local = targets - start
        mine = (local >= 0) & (local < cols)
        idx = local.clamp(0, cols - 1)
        tl = torch.where(mine, logits.gather(1, idx[:, None])[:, 0], 0.0)
        tl = all_reduce_(tl, group)
        ctx.save_for_backward(logits, lse, idx, mine)
        return lse - tl

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, mine = ctx.saved_tensors
        d = torch.exp(logits - lse[:, None])
        d[mine, idx[mine]] -= 1.0
        return g[:, None] * d, None, None, None


def vocab_parallel_cross_entropy(x, w, targets, start: int, group):
    """Per-row softmax cross-entropy of ``x @ w`` where ``w`` [D, V/n] holds
    this rank's vocabulary columns ``[start, start + V/n)`` of a vocabulary
    split over ``group`` (tensor parallelism; x whole on every rank) ->
    nll [N] float32, the same on every rank of the group. The logits stay
    split: no rank holds [N, V]. Float32 operands, as the dense path."""
    logits = copy_to(x, group).float() @ w.float()
    return _VocabParallelCE.apply(logits, targets.long(), start, group)


__all__ = ["blockwise_cross_entropy", "dense_cross_entropy",
           "vocab_parallel_cross_entropy"]
