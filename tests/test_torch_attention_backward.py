"""Port parity: the flash attention backward (tony_tpu_torch.ops.attention)
against the JAX package's Pallas backward, run in interpret mode on the CPU
as tests/test_ops.py runs it.

Every case runs under the JAX package's three backward tiers, chosen as
test_ops.py chooses them (``RESIDENT_MAX_L``/``FUSED_STREAM_MAX_L``
monkeypatched, jit caches cleared): the VMEM-resident fused kernel (K3),
the fused kv sweep (K4 fused), and the split kv sweep with the dQ kernel
(K4 split + K5). On a CPU tensor the port's autograd node runs its plain
backward, ``_flash_bwd_reference``, which is what the card's two backward
kernels are held against by chip_smoke.py. Tolerance: atol 1e-4 on dq,
dk and dv in float32, test_ops.py's gradient tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops.attention import _flash_bwd, _flash_fwd
from tony_tpu_torch.ops import attention as A

ATOL = 1e-4


@pytest.fixture(params=["resident", "stream_fused", "stream_split"])
def tier(request, monkeypatch):
    if request.param != "resident":
        import tony_tpu.ops.attention as jA

        monkeypatch.setattr(jA, "RESIDENT_MAX_L", 0)
        if request.param == "stream_split":
            monkeypatch.setattr(jA, "FUSED_STREAM_MAX_L", 0)
    # the JAX dispatch reads the tier globals at trace time
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


# (b, h, lq, lk, d, causal, window, with g_lse): the backward cases of
# test_ops.py (ragged padded blocks, cross attention with ragged kv, the
# gradient check, multi-q-block sweeps, sliding windows), plus causal cross
# attention with Lq != Lk both ways, rows with no visible key, and a nonzero
# lse cotangent
CASES = {
    "L128_causal": (1, 2, 128, 128, 16, True, None, False),
    "L200_causal_ragged": (1, 2, 200, 200, 16, True, None, False),
    "L300_causal_padded": (1, 2, 300, 300, 16, True, None, False),
    "L300_noncausal_padded": (1, 2, 300, 300, 16, False, None, False),
    "cross_noncausal_ragged_kv": (1, 2, 300, 520, 16, False, None, False),
    "cross_causal_lq_lt_lk": (2, 1, 128, 300, 16, True, None, False),
    "cross_causal_lq_gt_lk": (1, 2, 300, 200, 16, True, None, False),
    "window40": (1, 1, 300, 300, 16, True, 40, False),
    "window7": (1, 2, 300, 300, 16, True, 7, False),
    "empty_rows": (1, 1, 300, 128, 16, True, 64, False),
    "g_lse_causal": (1, 2, 300, 300, 16, True, None, True),
    "g_lse_cross_window": (1, 1, 300, 200, 16, True, 50, True),
}


def _inputs(seed, b, h, lq, lk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, d), dtype=np.float32)
    k = rng.standard_normal((b, h, lk, d), dtype=np.float32)
    v = rng.standard_normal((b, h, lk, d), dtype=np.float32)
    g = rng.standard_normal((b, h, lq, d), dtype=np.float32)
    g_lse = rng.standard_normal((b, h, lq), dtype=np.float32)
    return q, k, v, g, g_lse


def _jax_grads(q, k, v, g, g_lse, causal, window):
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out, lse = _flash_fwd(jq, jk, jv, causal, None, block_q=128,
                          block_k=128, interpret=True, window=window)
    grads = _flash_bwd(jq, jk, jv, out, lse, jnp.asarray(g), causal, None,
                       block_q=128, block_k=128, interpret=True,
                       g_lse=None if g_lse is None else jnp.asarray(g_lse),
                       window=window)
    return [np.asarray(x) for x in grads]


@pytest.mark.parametrize("case", list(CASES))
def test_flash_backward_matches_each_jax_tier(tier, case):
    b, h, lq, lk, d, causal, window, with_glse = CASES[case]
    q, k, v, g, g_lse = _inputs(lq * 3 + lk, b, h, lq, lk, d)
    g_lse = g_lse if with_glse else None
    want = _jax_grads(q, k, v, g, g_lse, causal, window)

    # the port's autograd node (a CPU tensor runs the plain backward)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = A.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                          window=window)
    if g_lse is None:       # only out is used: the lse cotangent is None
        got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    else:
        got = torch.autograd.grad((out, lse), (tq, tk, tv),
                                  (torch.from_numpy(g),
                                   torch.from_numpy(g_lse)))
    # and the plain backward called directly, as chip_smoke.py calls it
    plain = A._flash_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), out.detach(),
        lse.detach(), torch.from_numpy(g),
        None if g_lse is None else torch.from_numpy(g_lse), causal, None,
        window)
    for name, a, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), w, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(p.numpy(), w, atol=ATOL, err_msg=name)


def test_rows_and_keys_with_nothing_visible_get_zero_gradients():
    """A window band past the last key leaves query rows that see no key
    (lse NEG_INF, so exp(s - lse) is inf there): their dq is exactly 0,
    selected, never inf * 0. Keys that no query sees get dk = dv = 0."""
    q, k, v, g, g_lse = _inputs(9, 1, 1, 300, 128, 16)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = A.flash_attention_with_lse(tq, tk, tv, causal=True, window=64)
    dq, dk, dv = torch.autograd.grad(
        (out, lse), (tq, tk, tv),
        (torch.from_numpy(g), torch.from_numpy(g_lse)))
    empty = np.arange(300) >= 128 + 64 - 1
    assert (dq[0, 0, empty] == 0).all() and torch.isfinite(dq).all()
    assert (dq[0, 0, ~empty].abs().sum(-1) > 0).all()
    # causal cross attention with Lk > Lq: keys past the last query row
    q, k, v, g, _ = _inputs(10, 1, 1, 100, 250, 16)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = A.flash_attention(tq, tk, tv, causal=True)
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert (dk[0, 0, 100:] == 0).all() and (dv[0, 0, 100:] == 0).all()


def test_expanded_cotangent_and_blhd_layout():
    """out.sum().backward() hands the backward an expanded cotangent with
    zero strides; the model's [B, L, H, D] views go through the same node.
    Both match autograd of the plain attention."""
    from tony_tpu_torch.parallel.ring_attention import reference_attention

    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((2, 70, 3, 64), dtype=np.float32)
               for _ in range(3))
    got = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    A.attention_blhd(*got, causal=True, window=20).sum().backward()
    ref = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    reference_attention(*ref, causal=True, window=20).sum().backward()
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), atol=ATOL)
    # only lse used: the out cotangent never arrives (None, not zeros)
    tq, tk, tv = (torch.from_numpy(x[:, :, :1].transpose(0, 2, 1, 3).copy())
                  .requires_grad_() for x in (q, k, v))
    _, lse = A.flash_attention_with_lse(tq, tk, tv, causal=False)
    got = torch.autograd.grad(lse.sum(), (tq, tk, tv), allow_unused=True)
    s = torch.einsum("bhqd,bhkd->bhqk", tq, tk) * 64 ** -0.5
    want = torch.autograd.grad(torch.logsumexp(s, -1).sum(), (tq, tk))
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=ATOL)
    assert (got[2] == 0).all()


def test_backward_on_bf16_inputs():
    """bf16 storage: gradients come back in bf16, within 3e-2 of the
    float32 plain backward (test_ops.py's bf16 tolerance)."""
    q, k, v, g, _ = _inputs(13, 1, 2, 130, 130, 64)
    tb = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
    out = A.flash_attention(*tb, causal=True)
    got = torch.autograd.grad(out, tb, torch.from_numpy(g).bfloat16())
    tf = [torch.from_numpy(x) for x in (q, k, v)]
    out32, lse32 = A._flash_fwd_reference(*tf, True, None, None)
    want = A._flash_bwd_reference(*tf, out32, lse32, torch.from_numpy(g),
                                  None, True, None, None)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), w.numpy(), atol=3e-2,
                                   rtol=3e-2)
