"""Ring attention (einsum and flash blocks) and Ulysses attention of the port
(parallel/ring_attention.py, parallel/ulysses.py) on 2 and 4 gloo processes,
held against the JAX package's make_ring_attention / make_ulysses_attention
on as many forced host devices (tests/conftest.py), causal and not, outputs
and gradients at float32 (the counterparts of test_parallel.py:89, :126,
:305 and :324); and the one-process replay of the flash ring's schedule
(what chip_smoke.py runs on the card) against plain attention."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tony_tpu.parallel import (
    MeshSpec, build_mesh, make_ring_attention, make_ulysses_attention,
)
# the module, not the package's function of the same name
R = importlib.import_module("tony_tpu_torch.parallel.ring_attention")
from torch_dist_worker import run_ranks

OUT_ATOL, GRAD_ATOL = 2e-5, 1e-4
SHAPE = (1, 128, 4, 128)        # B, L, H, D: the flash kernel's head dim
CASES = [(kind, causal) for kind in ("xla", "flash", "ulysses")
         for causal in (True, False)]


def _inputs():
    rng = np.random.default_rng(7)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _jax_case(n, kind, causal, q, k, v, g):
    mesh = build_mesh(MeshSpec(fsdp=1, seq=n), devices=jax.devices()[:n])
    if kind == "ulysses":
        fn = make_ulysses_attention(mesh, causal=causal)
    else:
        fn = make_ring_attention(mesh, causal=causal, impl=kind)
    shard = NamedSharding(mesh, P(None, "seq", None, None))
    args = [jax.device_put(jnp.asarray(x), shard) for x in (q, k, v)]

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                 has_aux=True))(*args)
    return {"out": np.asarray(out),
            **{n_: np.asarray(x) for n_, x in zip(("dq", "dk", "dv"), grads)}}


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def runs(request, tmp_path_factory):
    """The port on n gloo ranks and the JAX package on n devices, every
    case."""
    n = request.param
    q, k, v, g = _inputs()
    want = {case: _jax_case(n, *case, q, k, v, g) for case in CASES}
    ranks = run_ranks("attention", n, {
        "q": torch.from_numpy(q), "k": torch.from_numpy(k),
        "v": torch.from_numpy(v), "g": torch.from_numpy(g),
        "cases": CASES}, tmp_path_factory.mktemp(f"ring{n}"))
    return n, want, ranks


@pytest.mark.parametrize("kind,causal", CASES,
                         ids=[f"{k}-{'causal' if c else 'full'}"
                              for k, c in CASES])
def test_sequence_parallel_attention_matches_jax(runs, kind, causal):
    n, want, ranks = runs
    got = {name: np.concatenate([r[(kind, causal)][name].numpy()
                                 for r in ranks], axis=1)
           for name in ("out", "dq", "dk", "dv")}
    np.testing.assert_allclose(got["out"], want[(kind, causal)]["out"],
                               atol=OUT_ATOL)
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], want[(kind, causal)][name],
                                   atol=GRAD_ATOL, err_msg=name)


def test_ulysses_rejects_indivisible_heads(runs):
    n, _, ranks = runs
    for r in ranks:
        assert f"heads ({n + 1}) divisible by axis size ({n})" in \
            r["indivisible"]
    mesh = build_mesh(MeshSpec(fsdp=1, seq=n), devices=jax.devices()[:n])
    q = jnp.zeros((1, 2 * n, n + 1, 8))
    with pytest.raises(ValueError, match="divisible"):
        jax.jit(make_ulysses_attention(mesh))(q, q, q)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_replayed_ring_schedule_matches_plain_attention(n, causal):
    """replay_ring_flash walks every rank's schedule in one process (the
    smoke's check on the card) and must give plain attention's out, lse
    and gradients of the whole sequence, the lse cotangent included."""
    q, k, v, g = (torch.from_numpy(x).transpose(1, 2).contiguous()
                  for x in _inputs())
    g_lse = torch.from_numpy(np.random.default_rng(3).standard_normal(
        q.shape[:3]).astype(np.float32))
    got = R.replay_ring_flash(q, k, v, g, n, causal=causal, g_lse=g_lse)
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    from tony_tpu_torch.ops.attention import _flash_fwd_reference

    out, lse = _flash_fwd_reference(qq, kk, vv, causal, None, None)
    ((out * g).sum() + (lse * g_lse).sum()).backward()
    np.testing.assert_allclose(got["out"].numpy(), out.detach().numpy(),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(got["lse"].numpy(), lse.detach().numpy(),
                               atol=OUT_ATOL)
    for name, ref in (("dq", qq), ("dk", kk), ("dv", vv)):
        np.testing.assert_allclose(got[name].numpy(), ref.grad.numpy(),
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_schedule_cases(n):
    """Each rank sees its own block once (diag), the earlier ranks' blocks
    fully and the later ones not at all; without a mask every block is
    full. So a causal ring launches n(n+1)/2 visible steps."""
    cases = [[R.block_case(r, t, n, True) for t in range(n)]
             for r in range(n)]
    for r, row in enumerate(cases):
        assert sorted(src for src, _ in row) == list(range(n))
        for src, case in row:
            assert case == (R.FULL if src < r else
                            R.DIAG if src == r else R.SKIP)
    visible = sum(c != R.SKIP for row in cases for _, c in row)
    assert visible == n * (n + 1) // 2
    assert all(R.block_case(r, t, n, False)[1] == R.FULL
               for r in range(n) for t in range(n))
