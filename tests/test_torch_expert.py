"""Port parity: tony_tpu_torch.parallel.expert (top-k routing, the
einsum-dispatch MoE FFN and the load-balancing loss) against the JAX
package's parallel/expert.py on the CPU.

Inputs come from numpy generators whose seeds are named in each fixture.
``torch.topk`` and ``lax.top_k`` may order tied probabilities
differently, so every fixture that is compared across the frameworks
asserts that its top-(k+1) router probabilities are at least 1e-4 apart
(and the fixtures were drawn so). Tolerances are the parity contract's:
routing equal at float32, outputs within 2e-5 (float32) and 3e-2 (bf16),
gradients within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.parallel import expert as jE
from tony_tpu_torch.parallel import expert as E

ATOL, BF16_ATOL, GRAD_ATOL = 2e-5, 3e-2, 1e-4
MIN_GAP = 1e-4


def _probs(logits):
    z = logits - logits.max(-1, keepdims=True)
    p = np.exp(z)
    return p / p.sum(-1, keepdims=True)


def _assert_no_ties(logits, k):
    """The top-(k+1) probabilities of every token are MIN_GAP apart, so
    both frameworks choose and order the same experts."""
    s = -np.sort(-_probs(np.asarray(logits, np.float64)), -1)
    kk = min(k + 1, s.shape[-1])
    gap = float(np.min(s[:, :kk - 1] - s[:, 1:kk]))
    assert gap > MIN_GAP, f"a near-tie in the fixture: top-k gap {gap}"


def _logits(seed, t, e):
    return (np.random.default_rng(seed).standard_normal((t, e)) * 2
            ).astype(np.float32)


def _ffn_inputs(seed, t=32, d=8, f=16, e=4):
    """x [T, d], router [d, E], w_in [E, d, f], w_out [E, f, d]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    w_in = (rng.standard_normal((e, d, f)) * 0.2).astype(np.float32)
    w_out = (rng.standard_normal((e, f, d)) * 0.2).astype(np.float32)
    return x, router, w_in, w_out


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(np.array(x)).to(dtype) for x in xs]


# (tokens, experts, k, capacity, seed): the JAX test's case (capacity never
# binds), one where capacity drops tokens, and top-3 of 8 experts
ROUTING = [(16, 4, 2, 8, 0), (32, 4, 2, 5, 0), (24, 8, 3, 4, 2)]


@pytest.mark.parametrize("t,e,k,cap,seed", ROUTING,
                         ids=["jax_case", "drops", "top3_of_8"])
def test_top_k_routing_matches_jax(t, e, k, cap, seed):
    logits = _logits(seed, t, e)
    _assert_no_ties(logits, k)
    jd, jc = jE.top_k_routing(jnp.asarray(logits), k=k, capacity=cap)
    d, c = E.top_k_routing(torch.from_numpy(logits), k, cap)
    assert d.dtype == c.dtype == torch.float32 and d.shape == (t, e, cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
    # test_parallel.py:496's invariants: each (expert, slot) used at most
    # once, each token dispatched at most k times, combine only where
    # dispatched, a token's weights summing to at most 1
    dn, cn = d.numpy(), c.numpy()
    assert dn.sum(axis=0).max() <= 1.0 + 1e-6
    assert dn.sum(axis=(1, 2)).max() <= k + 1e-6
    assert ((cn > 0) <= (dn > 0)).all()
    assert cn.sum(axis=(1, 2)).max() <= 1.0 + 1e-5
    if cap * e < t * k:            # capacity binds: some claims dropped
        assert dn.sum() == cap * e


@pytest.mark.parametrize("scaled", [False, True], ids=["native", "int8_scaled"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_jax(dtype, scaled):
    """moe_ffn at capacity factor 1.25 (tokens dropped), with and without
    w8a16's per-expert per-output-channel scales. Seed 0."""
    x, router, w_in, w_out = _ffn_inputs(0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # the inputs as the dtype holds them, so both sides route the same
    x = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
    router = np.asarray(jnp.asarray(router, jdt).astype(jnp.float32))
    _assert_no_ties(x @ router, 2)
    kw = {}
    if scaled:
        w_in = np.random.default_rng(1).integers(-127, 128, w_in.shape,
                                                 dtype=np.int8)
        w_out = np.random.default_rng(2).integers(-127, 128, w_out.shape,
                                                  dtype=np.int8)
        s_in = np.asarray(jnp.asarray(np.random.default_rng(3).uniform(
            1e-3, 3e-3, (4, 1, 16)), jdt).astype(jnp.float32))
        s_out = np.asarray(jnp.asarray(np.random.default_rng(4).uniform(
            1e-3, 3e-3, (4, 1, 8)), jdt).astype(jnp.float32))
        kw = dict(w_in_scale=s_in, w_out_scale=s_out)
    want = jE.moe_ffn(jnp.asarray(x, jdt), jnp.asarray(router, jdt),
                      jnp.asarray(w_in), jnp.asarray(w_out), k=2,
                      capacity_factor=1.25,
                      **{n: jnp.asarray(v, jdt) for n, v in kw.items()})
    xt, rt = _t(x, router, dtype=tdt)
    wi, wo = (torch.from_numpy(w) for w in (w_in, w_out))
    got = E.moe_ffn(xt, rt, wi if scaled else wi.to(tdt),
                    wo if scaled else wo.to(tdt), k=2, capacity_factor=1.25,
                    **{n: _t(v, dtype=tdt)[0] for n, v in kw.items()})
    assert got.dtype == tdt and got.shape == (32, 8)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        atol=ATOL if dtype == "float32" else BF16_ATOL)


def test_moe_ffn_gradients_match_jax():
    """d(sum(moe_ffn * cot)) by x, router, w_in and w_out against jax.grad
    (the router's gradient flows through the combine gates). Seed 0."""
    x, router, w_in, w_out = _ffn_inputs(0)
    _assert_no_ties(x @ router, 2)
    cot = np.random.default_rng(5).standard_normal((32, 8)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jE.moe_ffn(*a, k=2, capacity_factor=1.25) * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, router, w_in, w_out)))
    args = [a.requires_grad_() for a in _t(x, router, w_in, w_out)]
    loss = (E.moe_ffn(*args, k=2, capacity_factor=1.25)
            * torch.from_numpy(cot)).sum()
    got = torch.autograd.grad(loss, args)
    for name, g, w in zip(("x", "router", "w_in", "w_out"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   err_msg=name)
    assert float(got[1].abs().max()) > 0     # the router does learn


@pytest.mark.parametrize("t,e,k,seed", [(64, 8, 2, 0), (24, 8, 3, 2)])
def test_load_balancing_loss_matches_jax(t, e, k, seed):
    logits = _logits(seed, t, e)
    _assert_no_ties(logits, k)
    want, jgrad = jax.value_and_grad(jE.load_balancing_loss)(
        jnp.asarray(logits), k)
    lt = torch.from_numpy(logits).requires_grad_()
    got = E.load_balancing_loss(lt, k)
    (grad,) = torch.autograd.grad(got, lt)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad),
                               atol=GRAD_ATOL)
    # a uniform router: every expert's probability is 1/E whatever the
    # tie order, so the loss is exactly 1 in both frameworks
    flat = E.load_balancing_loss(torch.zeros(t, e), k)
    assert float(flat) == pytest.approx(1.0) == float(
        jE.load_balancing_loss(jnp.zeros((t, e)), k))


def test_capacity_never_truncates_a_drop_free_factor():
    """test_parallel.py:554: capacity_factor = E/k must give capacity >=
    tokens; (4/3) * 21 / 4 is 6.999... in floating point, and int() must
    not drop the seventh token (even with every token tied on the same
    experts)."""
    t, k, e = 7, 3, 4
    cf = e / k
    assert E.capacity_for(t, k, e, cf) == max(1, int(cf * t * k / e + 1e-6))
    assert E.capacity_for(t, k, e, cf) >= t
    _, combine = E.top_k_routing(torch.zeros(t, e), k,
                                 E.capacity_for(t, k, e, cf))
    assert (combine.sum(dim=(1, 2)) > 0).all()
    for tokens in range(1, 40):
        for kk, ee in ((1, 2), (2, 4), (2, 8), (3, 4)):
            assert E.capacity_for(tokens, kk, ee, ee / kk) >= tokens


def test_large_capacity_keeps_every_token_and_matches_jax():
    """test_parallel.py:511: with capacity >= 2 T every token keeps its
    whole gate weight; at the drop-free factor E/k moe_ffn equals the JAX
    package's. Seed 0."""
    x, router, w_in, w_out = _ffn_inputs(0)
    _assert_no_ties(x @ router, 2)
    _, combine = E.top_k_routing(torch.from_numpy(x @ router), 2, 64)
    np.testing.assert_allclose(combine.sum(dim=(1, 2)).numpy(), 1.0,
                               atol=1e-5)
    want = jE.moe_ffn(*(jnp.asarray(a) for a in (x, router, w_in, w_out)),
                      k=2, capacity_factor=4.0)
    got = E.moe_ffn(*_t(x, router, w_in, w_out), k=2, capacity_factor=4.0)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # drop-free: each token's output is its own, whatever else is routed
    alone = torch.cat([E.moe_ffn(*_t(x[i:i + 1], router, w_in, w_out), k=2,
                                 capacity_factor=2.0) for i in range(32)])
    np.testing.assert_allclose(alone.numpy(), got.numpy(), atol=ATOL)
