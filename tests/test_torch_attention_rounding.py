"""The bf16 flash kernels' rounding fits the card's tolerances.

The bf16 forward and backward kernels in ``tony_tpu_torch/csrc`` run their
products on the tensor cores, which take bf16 operands: besides Q, K, V and
dO (bf16 already), P is rounded to bf16 before P V and dP^T-side products,
and dS before dS^T Q and dS K; every product accumulates in float32 and each
output is rounded once. The two emulations below model exactly those
rounding points in plain PyTorch (the forward with its online softmax over
64-key tiles, P rounded after the running-max shift, the row sum taken from
the unrounded P) and are held against the plain versions the card's kernels
are held against, ``_flash_fwd_reference`` and ``_flash_bwd_reference``,
within the tolerances ``chip_smoke.py`` holds the kernels to:
``BF16_TOL`` for the forward's out, ``LSE_TOL`` for its lse and
``BWD_BF16_TOL`` for dq, dk and dv. The emulations live here, not in the
package: the package's plain versions stay the reference.
"""

import numpy as np
import pytest
import torch

from tony_tpu_torch.ops import attention as A

BF16_TOL = (1e-2, 1e-2)       # (atol, rtol), chip_smoke.py
LSE_TOL = (1e-3, 1e-5)
BWD_BF16_TOL = (1e-2, 1e-2)
KEY_TILE = 64                 # keys a K/V tile of the forward kernel


def _fwd_emulated(q, k, v, causal, window):
    """The tensor-core forward's arithmetic: S in float32 from bf16 operands,
    online softmax tile by tile, P rounded to bf16 for P V, out rounded once."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    lq, lk = q.shape[2], k.shape[2]
    mask = A._visible(lq, lk, causal, window, q.device)
    m = torch.full(q.shape[:3] + (1,), A.NEG_INF)
    l = torch.zeros(q.shape[:3] + (1,))
    acc = torch.zeros(q.shape[:3] + (q.shape[-1],))
    for k0 in range(0, lk, KEY_TILE):
        vis = mask[:, k0:k0 + KEY_TILE]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + KEY_TILE]) * scale
        s = torch.where(vis, s, A.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(vis, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bhqk,bhkd->bhqd", p.bfloat16().float(), vf[:, :, k0:k0 + KEY_TILE])
        m = m_new
    l_safe = torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m + torch.log(l_safe), A.NEG_INF)[..., 0]
    return (acc / l_safe).to(q.dtype), lse


def _bwd_emulated(q, k, v, o, lse, g, g_lse, causal, window):
    """The tensor-core backward's arithmetic: P and dS in float32, rounded to
    bf16 as the A operands of dV += P^T dO, dK += dS^T Q and dQ += dS K."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    mask = A._visible(q.shape[2], k.shape[2], causal, window, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = A._delta(o, g, g_lse)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.bfloat16().float(), gf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _within(got, want, tol):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    atol, rtol = tol
    excess = (got - want).abs() - rtol * want.abs()
    assert float(excess.max()) <= atol, float((got - want).abs().max())


# (lq, lk, causal, window, with g_lse) at B1 H2 D128 bf16
CASES = {
    "L512_causal": (512, 512, True, None, False),
    "L512_window128": (512, 512, True, 128, False),
    "cross_ragged_lq300_lk700": (300, 700, False, None, False),
    "empty_rows_lq512_lk200_w64": (512, 200, True, 64, True),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_bf16_rounding_fits_the_tolerances(case):
    lq, lk, causal, window, with_glse = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))

    def bf16(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).bfloat16()

    q, k, v, g = bf16(1, 2, lq, 128), bf16(1, 2, lk, 128), \
        bf16(1, 2, lk, 128), bf16(1, 2, lq, 128)
    g_lse = torch.from_numpy(rng.standard_normal(
        (1, 2, lq), dtype=np.float32)) if with_glse else None

    out, lse = A._flash_fwd_reference(q, k, v, causal, None, window)
    e_out, e_lse = _fwd_emulated(q, k, v, causal, window)
    _within(e_out, out, BF16_TOL)
    _within(e_lse, lse, LSE_TOL)

    want = A._flash_bwd_reference(q, k, v, out, lse, g, g_lse, causal, None,
                                  window)
    got = _bwd_emulated(q, k, v, out, lse, g, g_lse, causal, window)
    for gr, w in zip(got, want):
        _within(gr, w, BWD_BF16_TOL)
    if window is not None and lk < lq:
        # rows past the last key's window see no key: out 0, lse NEG_INF,
        # and their dq is exactly 0 in the emulation as in the kernel
        empty = torch.arange(lq) >= lk + window - 1
        assert (e_out[:, :, empty] == 0).all()
        assert (e_lse[:, :, empty] == A.NEG_INF).all()
        assert (got[0][:, :, empty] == 0).all()
