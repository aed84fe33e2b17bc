"""Port parity: tony_tpu_torch.ops.attention (flash forward) against the JAX
package's Pallas flash forward, run in interpret mode on the CPU as
tests/test_ops.py runs it.

On a CPU tensor the port runs its plain version (the CUDA kernel's
reference); the CUDA kernel itself is held against that plain version on
the card by chip_smoke.py. Tolerance: atol 2e-5 on
out and lse in float32, the tolerance of tests/test_ops.py (both sides sum
in float32 in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops.attention import _flash_fwd
from tony_tpu.parallel import reference_attention as jax_reference_attention
from tony_tpu_torch.ops import attention as A

ATOL = 2e-5


def _inputs(seed, b, h, lq, lk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, d), dtype=np.float32)
    k = rng.standard_normal((b, h, lk, d), dtype=np.float32)
    v = rng.standard_normal((b, h, lk, d), dtype=np.float32)
    return q, k, v


def _jax_fwd(q, k, v, causal, window=None):
    out, lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal, None, block_q=128, block_k=128,
                          interpret=True, window=window)
    return np.asarray(out), np.asarray(lse)


def _port_fwd(q, k, v, causal, window=None):
    out, lse = A.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window)
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("length", [128, 256, 300])
def test_flash_forward_matches_jax(causal, length):
    q, k, v = _inputs(length + causal, 1, 2, length, length, 16)
    out, lse = _port_fwd(q, k, v, causal)
    ref_out, ref_lse = _jax_fwd(q, k, v, causal)
    np.testing.assert_allclose(out, ref_out, atol=ATOL)
    np.testing.assert_allclose(lse, ref_lse, atol=ATOL)


@pytest.mark.parametrize("causal,lq,lk", [
    (False, 128, 300),    # ragged kv, non-causal cross-attention
    (True, 128, 300),     # causal from absolute index 0 on both sides
    (True, 300, 200),     # more queries than keys
])
def test_flash_forward_cross_attention_ragged_kv(causal, lq, lk):
    q, k, v = _inputs(lq * 7 + lk, 2, 1, lq, lk, 16)
    out, lse = _port_fwd(q, k, v, causal)
    ref_out, ref_lse = _jax_fwd(q, k, v, causal)
    np.testing.assert_allclose(out, ref_out, atol=ATOL)
    np.testing.assert_allclose(lse, ref_lse, atol=ATOL)


@pytest.mark.parametrize("window", [64, 200])
def test_flash_forward_sliding_window(window):
    q, k, v = _inputs(window, 1, 2, 300, 300, 16)
    out, lse = _port_fwd(q, k, v, True, window)
    ref_out, ref_lse = _jax_fwd(q, k, v, True, window)
    np.testing.assert_allclose(out, ref_out, atol=ATOL)
    np.testing.assert_allclose(lse, ref_lse, atol=ATOL)


def test_flash_forward_rows_with_no_visible_key():
    """A window band past the last key leaves rows with no valid column:
    out 0 and lse NEG_INF on both sides (exp(NEG_INF - NEG_INF) = 1 must
    not leak in)."""
    q, k, v = _inputs(5, 1, 1, 300, 128, 16)
    out, lse = _port_fwd(q, k, v, True, 64)
    ref_out, ref_lse = _jax_fwd(q, k, v, True, 64)
    empty = np.arange(300) >= 128 + 64 - 1
    assert (out[0, 0, empty] == 0).all()
    assert (lse[0, 0, empty] == A.NEG_INF).all()
    np.testing.assert_allclose(out, ref_out, atol=ATOL)
    np.testing.assert_allclose(lse, ref_lse, atol=ATOL)


def test_attention_blhd_layout_matches_reference():
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal((2, 200, 2, 16), dtype=np.float32)
               for _ in range(3))
    out = A.attention_blhd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True, window=50)
    ref = jax_reference_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=50)
    assert out.shape == (2, 200, 2, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_validate_window_errors():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="causal"):
        A.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match=">= 1"):
        A.flash_attention(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="causal"):
        A.attention_blhd(q, q, q, causal=False, window=4)


def test_plain_version_is_differentiable():
    """The CPU path keeps autograd: gradients match JAX's gradient of its
    plain attention (atol 1e-4, test_ops.py's gradient tolerance)."""
    import jax

    q, k, v = _inputs(3, 1, 2, 64, 64, 16)
    g = np.random.default_rng(4).standard_normal(q.shape, dtype=np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = A.flash_attention(tq, tk, tv, causal=True)
    (out * torch.from_numpy(g)).sum().backward()

    def loss(q, k, v):
        o = jax_reference_attention(q.transpose(0, 2, 1, 3),
                                    k.transpose(0, 2, 1, 3),
                                    v.transpose(0, 2, 1, 3), causal=True)
        return jnp.sum(o.transpose(0, 2, 1, 3) * g)

    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, ref in zip((tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=1e-4)


def test_kernel_envelope_and_backward_guard():
    """The port's own envelope (head_dim 64/128, f32/bf16), not the TPU's
    % 128 rule; the backward kernels' wrapper refuses a CPU tensor (a CPU
    tensor takes the plain backward through the same autograd node)."""
    assert A.flash_supported(torch.zeros(1, 1, 4, 64))
    assert A.flash_supported(torch.zeros(1, 1, 4, 128, dtype=torch.bfloat16))
    assert not A.flash_supported(torch.zeros(1, 1, 4, 96))
    assert not A.flash_supported(torch.zeros(1, 1, 4, 128, dtype=torch.float16))
    x = torch.zeros(1, 1, 4, 64)
    with pytest.raises(ValueError, match="device"):
        A._flash_bwd_cuda(x, x, x, x, torch.zeros(1, 1, 4), x, None, True,
                          None, None)
    # a CPU tensor never reaches the kernel wrapper's launch
    with pytest.raises(ValueError, match="device"):
        A._check_kernel_inputs(*(torch.zeros(1, 1, 4, 64),) * 3)


def test_bf16_kernel_alignment_rule():
    """The bf16 kernels copy 16-byte chunks: a view whose data pointer or
    (B, H, L) strides are not multiples of 16 bytes is refused by the
    wrapper before the launch (the C entry point checks the same)."""
    x = torch.zeros(2, 2, 9, 64, dtype=torch.bfloat16)
    assert A._aligned16(x) and A._aligned16(x[:, :, 1:])
    assert A._aligned16(x.transpose(1, 2))
    assert not A._aligned16(x[..., 1:])          # pointer off by 2 bytes
    y = torch.zeros(2, 2, 9, 68, dtype=torch.bfloat16)[..., :64]
    assert not A._aligned16(y)                   # L stride of 136 bytes
