"""Port parity: tony_tpu_torch.ops.cross_entropy (blockwise and dense
cross-entropy) against the JAX package's ops/cross_entropy.py on the CPU,
with the cases of tests/test_ops.py: ragged vocab (V % block != 0), a block
wider than the vocab, gradients under a non-uniform per-row cotangent, and
bf16 inputs. Tolerances are test_ops.py's: atol 1e-5 in float32, 5e-2 for
bf16 inputs against the float32 dense path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops import blockwise_cross_entropy as jax_blockwise
from tony_tpu.ops import dense_cross_entropy as jax_dense
from tony_tpu_torch.ops import cross_entropy as CE

ATOL = 1e-5


def _inputs(seed, n, d, v):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    w = rng.standard_normal((d, v), dtype=np.float32)
    t = rng.integers(0, v, (n,), dtype=np.int32)
    return x, w, t


@pytest.mark.parametrize("v,block_v", [(64, 16), (50, 16), (40, 64)])
def test_blockwise_ce_matches_jax(v, block_v):
    x, w, t = _inputs(v + block_v, 32, 16, v)
    got = CE.blockwise_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(t), block_v)
    assert got.dtype == torch.float32 and got.shape == (32,)
    want = jax_blockwise(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t),
                         block_v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    dense = jax_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), atol=ATOL)
    port_dense = CE.dense_cross_entropy(torch.from_numpy(x),
                                        torch.from_numpy(w),
                                        torch.from_numpy(t))
    np.testing.assert_allclose(port_dense.numpy(), np.asarray(dense),
                               atol=ATOL)


@pytest.mark.parametrize("v,block_v", [(50, 16), (64, 16), (40, 64)])
def test_blockwise_ce_gradients_match_jax(v, block_v):
    """The autograd Function's blockwise dx and dW (no [N, V] tensor) ==
    JAX's custom VJP and XLA autodiff of the dense path, for a non-uniform
    per-row cotangent."""
    x, w, t = _inputs(3 + v, 24, 8, v)
    weights = np.linspace(0.1, 1.0, 24, dtype=np.float32)

    def loss_blk(x, w):
        return jnp.sum(jax_blockwise(x, w, jnp.asarray(t), block_v) * weights)

    def loss_dense(x, w):
        return jnp.sum(jax_dense(x, w, jnp.asarray(t)) * weights)

    want_blk = jax.grad(loss_blk, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(w))
    want_dense = jax.grad(loss_dense, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(w))
    for fn in (lambda a, b: CE.blockwise_cross_entropy(a, b, torch.from_numpy(t),
                                                       block_v),
               lambda a, b: CE.dense_cross_entropy(a, b, torch.from_numpy(t))):
        tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
        (fn(tx, tw) * torch.from_numpy(weights)).sum().backward()
        for got, wb, wd in zip((tx.grad, tw.grad), want_blk, want_dense):
            np.testing.assert_allclose(got.numpy(), np.asarray(wb), atol=ATOL)
            np.testing.assert_allclose(got.numpy(), np.asarray(wd), atol=ATOL)


def test_blockwise_ce_bfloat16_inputs():
    """bf16 operands: float32 nll (block logits from bf16 operands kept in
    float32), within 5e-2 of the float32 dense path and within 1e-5 of the
    JAX blockwise op on the same bf16 inputs; gradients come back bf16."""
    x, w, t = _inputs(6, 16, 8, 64)
    xb, wb = (torch.from_numpy(a).bfloat16() for a in (x, w))
    got = CE.blockwise_cross_entropy(xb, wb, torch.from_numpy(t), 16)
    assert got.dtype == torch.float32
    x32, w32 = xb.float().numpy(), wb.float().numpy()
    dense = jax_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), atol=5e-2)
    same = jax_blockwise(jnp.asarray(x32, jnp.bfloat16),
                         jnp.asarray(w32, jnp.bfloat16), jnp.asarray(t), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(same), atol=ATOL)
    xg, wg = xb.clone().requires_grad_(), wb.clone().requires_grad_()
    CE.blockwise_cross_entropy(xg, wg, torch.from_numpy(t), 16).sum().backward()
    assert xg.grad.dtype == torch.bfloat16 and wg.grad.dtype == torch.bfloat16


def test_block_logits_are_float32_from_bf16_operands():
    """A bf16 x bf16 matmul would round the logits to bf16; the block
    product keeps every bit of the float32 sum."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 32), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 16), dtype=np.float32))
    xb, wb = x.bfloat16(), w.bfloat16()
    logits, start, owned = CE._block_cols(xb.float(), wb, 0, 16, 16)
    assert logits.dtype == torch.float32 and start == 0 and owned is None
    np.testing.assert_allclose(logits.numpy(),
                               (xb.double() @ wb.double()).numpy(),
                               atol=1e-5)
    # the ragged last block starts at V - block and masks the columns the
    # previous block owns
    logits, start, owned = CE._block_cols(xb.float(), wb, 1, 10, 16)
    assert start == 6 and owned.tolist() == [False] * 4 + [True] * 6
    assert (logits[:, :4] == CE.NEG_INF).all()
