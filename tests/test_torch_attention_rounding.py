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

The bf16 dQ kernel also computes delta = rowsum(dO * O) - g_lse itself:
two threads a row, each summing half of D in column order by fused
multiply-adds in float32, the halves then added, from bf16 dO and O in
bf16 (or float32: ring attention's merged out). ``_delta_emulated`` models
that arithmetic; it is held against ``_delta`` at the float32 tolerance
for both kinds of O, and a float32 backward driven by it against the JAX
package's ``_flash_bwd`` (its Pallas kernels in interpret mode, as
tests/test_ops.py runs them) at D = 32, 64 and 128. The emulation is
test-side arithmetic: the kernel's own delta is held against ``_delta`` on
the card, by ``chip_smoke.py``'s backward phase.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops.attention import _flash_bwd, _flash_fwd
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


# (lq, lk, causal, window, with g_lse, head dim) at B1 H2 bf16
CASES = {
    "L512_causal": (512, 512, True, None, False, 128),
    "L512_window128": (512, 512, True, 128, False, 128),
    "cross_ragged_lq300_lk700": (300, 700, False, None, False, 128),
    "empty_rows_lq512_lk200_w64": (512, 200, True, 64, True, 128),
    # a draft model's head dim (the 64-byte swizzle) and D = 64
    "hd32_causal_lq300": (300, 300, True, None, True, 32),
    "hd64_window64_lq400": (400, 400, True, 64, False, 64),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_bf16_rounding_fits_the_tolerances(case):
    lq, lk, causal, window, with_glse, d = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))

    def bf16(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).bfloat16()

    q, k, v, g = bf16(1, 2, lq, d), bf16(1, 2, lk, d), \
        bf16(1, 2, lk, d), bf16(1, 2, lq, d)
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


BWD_F32_TOL = (1e-3, 1e-4)    # chip_smoke.py, the dQ kernel's delta
JAX_GRAD_ATOL = 1e-4          # tests/test_torch_attention_backward.py


def _delta_emulated(o, g, g_lse):
    """The dQ kernel's delta: each row's two halves of D summed in column
    order by acc = fmaf(dO, O, acc), then added in float32, minus g_lse.
    A step's product of two float32 values is exact in float64, and the
    float64 sum rounded to float32 is fmaf's single rounding (short of a
    double rounding, far below the tolerance)."""
    d = g.shape[-1]
    g64, o64 = g.double(), o.double()
    halves = []
    for lo in (0, d // 2):
        acc = torch.zeros(o.shape[:-1])
        for c in range(lo, lo + d // 2):
            acc = (g64[..., c] * o64[..., c] + acc.double()).float()
        halves.append(acc)
    delta = halves[0] + halves[1]
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


def _bwd_with_delta(q, k, v, lse, g, delta, causal, window):
    """_flash_bwd_reference's arithmetic, in float32, with delta given."""
    scale = q.shape[-1] ** -0.5
    mask = A._visible(q.shape[2], k.shape[2], causal, window, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    ds = p * (dp - delta[..., None])
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale,
            torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale,
            torch.einsum("bhqk,bhqd->bhkd", p, g))


# (lq, lk, causal, window, with g_lse) at B1 H2
DELTA_CASES = {
    "causal_l200": (200, 200, True, None, False),
    "window40_l300": (300, 300, True, 40, False),
    "cross_ragged_lq300_lk200": (300, 200, False, None, True),
    "empty_rows_lq300_lk128_w64": (300, 128, True, 64, True),
}


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", list(DELTA_CASES))
def test_in_kernel_delta_matches_delta_and_jax(case, d):
    lq, lk, causal, window, with_glse = DELTA_CASES[case]
    rng = np.random.default_rng(1000 * d + sorted(DELTA_CASES).index(case))
    q, g = (rng.standard_normal((1, 2, lq, d), dtype=np.float32)
            for _ in range(2))
    # dO as the bf16 kernels see it: bf16 values, held here in float32
    g = torch.from_numpy(g).bfloat16().float().numpy()
    k, v = (rng.standard_normal((1, 2, lk, d), dtype=np.float32)
            for _ in range(2))
    g_lse = (rng.standard_normal((1, 2, lq), dtype=np.float32)
             if with_glse else None)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    tg_lse = None if g_lse is None else torch.from_numpy(g_lse)
    out, lse = A._flash_fwd_reference(tq, tk, tv, causal, None, window)

    # O in bf16 (the bf16 forward's out) and in float32 (a merged out)
    o16 = out.bfloat16()
    _within(_delta_emulated(o16, tg.bfloat16(), tg_lse),
            A._delta(o16, tg.bfloat16(), tg_lse), BWD_F32_TOL)
    delta = _delta_emulated(out, tg, tg_lse)
    _within(delta, A._delta(out, tg, tg_lse), BWD_F32_TOL)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout, jlse = _flash_fwd(jq, jk, jv, causal, None, block_q=128,
                            block_k=128, interpret=True, window=window)
    want = _flash_bwd(jq, jk, jv, jout, jlse, jnp.asarray(g), causal, None,
                      block_q=128, block_k=128, interpret=True,
                      g_lse=None if g_lse is None else jnp.asarray(g_lse),
                      window=window)
    got = _bwd_with_delta(tq, tk, tv, lse, tg, delta, causal, window)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w),
                                   atol=JAX_GRAD_ATOL, err_msg=name)
    if window is not None and lk < lq:
        # rows that see no key: their delta is still rowsum(dO O) - g_lse,
        # and their dq is 0 because every p of theirs is selected to 0
        empty = torch.arange(lq) >= lk + window - 1
        assert (got[0][:, :, empty] == 0).all()
