"""Port parity: tony_tpu_torch.ops.decode_attention (split-KV flash decode)
against the JAX package's Pallas flash-decode kernel, run in interpret mode
on the CPU as tests/test_ops.py runs it.

On a CPU tensor the port runs its plain version; the CUDA kernel's two
stages (per-chunk partials in its scratch, then their combine by the last
chunk of each head) each have a plain version too, and the tests here check
that those two compose to the whole over the kernel's split and over its
edge cases (an unaligned window start, a tail past the last whole tile,
rep 8, many small chunks, empty chunks). The kernel itself is held against
the plain versions on the card by chip_smoke.py. Tolerance: atol 2e-5 in
float32, test_ops.py's tolerance (both sides sum in float32, in different
orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops.decode_attention import flash_decode as jax_flash_decode
from tony_tpu_torch.ops import decode_attention as DA

ATOL = 2e-5
B, KVH, REP, D, M = 2, 2, 2, 32, 700     # GQA rep 2; M not a block multiple


def _normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _quant(x):
    """Symmetric per-position int8 with bf16 scales, as generate stores."""
    amax = np.abs(x).max(axis=-1, keepdims=True)
    sc = np.maximum(amax / 127.0, 1e-8)
    q = np.clip(np.round(x / sc), -127, 127).astype(np.int8)
    sc_bf16 = torch.from_numpy(sc[..., 0].astype(np.float32)).bfloat16()
    return q, sc_bf16


def _jax(q, ck, cv, length, ks=None, vs=None, window=0, layer=None):
    to_jax_bf16 = (lambda t: None if t is None
                   else jnp.asarray(t.float().numpy(), jnp.bfloat16))
    out = jax_flash_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                           jnp.int32(length), to_jax_bf16(ks),
                           to_jax_bf16(vs), window=window, layer=layer,
                           block_k=256, interpret=True)
    return np.asarray(out)


def _port(q, ck, cv, length, ks=None, vs=None, window=0, layer=None):
    return DA.flash_decode(torch.from_numpy(q), torch.from_numpy(ck),
                           torch.from_numpy(cv), length, ks, vs,
                           window=window, layer=layer).numpy()


@pytest.mark.parametrize("length", [0, 437, M - 1])
def test_flash_decode_matches_jax(length):
    rng = np.random.default_rng(100 + length)
    q = _normal(rng, B, KVH, REP, D)
    ck, cv = _normal(rng, B, KVH, M, D), _normal(rng, B, KVH, M, D)
    np.testing.assert_allclose(_port(q, ck, cv, length),
                               _jax(q, ck, cv, length), atol=ATOL)


@pytest.mark.parametrize("length,window", [(437, 64), (600, 200), (30, 64)])
def test_flash_decode_window_int8_matches_jax(length, window):
    """Sliding-window band on an int8 cache with bf16 scales: K's scale on
    the score columns, V's on p for the value sum only."""
    rng = np.random.default_rng(length + window)
    q = _normal(rng, B, KVH, REP, D)
    ck, ks = _quant(_normal(rng, B, KVH, M, D))
    cv, vs = _quant(_normal(rng, B, KVH, M, D))
    np.testing.assert_allclose(
        _port(q, ck, cv, length, ks, vs, window=window),
        _jax(q, ck, cv, length, ks, vs, window=window), atol=ATOL)


@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_layer_indexed_stack(int8):
    """``layer=`` reads one layer of the [Ly, B, kvH, M, D] stack."""
    rng = np.random.default_rng(7 + int8)
    q = _normal(rng, B, KVH, REP, D)
    ck, cv = _normal(rng, 3, B, KVH, M, D), _normal(rng, 3, B, KVH, M, D)
    ks = vs = None
    if int8:
        (ck, ks), (cv, vs) = _quant(ck), _quant(cv)
    for layer in range(3):
        np.testing.assert_allclose(
            _port(q, ck, cv, 437, ks, vs, layer=layer),
            _jax(q, ck, cv, 437, ks, vs, layer=layer), atol=ATOL)


@pytest.mark.parametrize("length,window,int8,tile", [
    (0, 0, False, 32), (437, 0, False, 32), (M - 1, 0, True, 64),
    (437, 100, True, 32), (M - 1, 0, False, 1024),
])
def test_kernel_passes_compose_to_jax(length, window, int8, tile):
    """The plain versions of the kernel's two stages (per-chunk partials,
    then the lse-weighted combine) give the JAX kernel's output over the
    kernel's split, scaled down (tiles of ``tile`` positions, 8 SMs of two
    CTAs): one chunk, several, and a ragged last chunk."""
    rng = np.random.default_rng(length + 3 * window + int8)
    q = _normal(rng, B, KVH, REP, D)
    ck, cv = _normal(rng, 2, B, KVH, M, D), _normal(rng, 2, B, KVH, M, D)
    ks = vs = None
    if int8:
        (ck, ks), (cv, vs) = _quant(ck), _quant(cv)
    lo, hi = DA._valid_range(length, window)
    chunk, n_chunks = DA._split(hi - lo + 1, B * KVH, tile, 8, 2)
    parts = DA._decode_partial_reference(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        ks, vs, lo, length, chunk, n_chunks, layer=1)
    assert parts[0].shape == (B * KVH, n_chunks, REP, D)
    assert torch.isfinite(parts[1]).all()          # every chunk holds a key
    out = DA._decode_combine_reference(*parts, torch.float32)
    np.testing.assert_allclose(
        out.reshape(B, KVH, REP, D).numpy(),
        _jax(q, ck, cv, length, ks, vs, window=window, layer=1), atol=ATOL)


def test_combine_gives_an_empty_chunk_no_weight():
    """A chunk with no valid key (m = NEG_INF, l = 0) adds nothing."""
    rng = np.random.default_rng(3)
    part_o = torch.from_numpy(_normal(rng, 4, 3, 2, D))
    part_m = torch.from_numpy(_normal(rng, 4, 3, 2))
    part_l = torch.from_numpy(rng.uniform(0.5, 2.0, (4, 3, 2))
                              .astype(np.float32))
    want = DA._decode_combine_reference(part_o[:, :2], part_m[:, :2],
                                        part_l[:, :2], torch.float32)
    part_m[:, 2], part_l[:, 2], part_o[:, 2] = DA.NEG_INF, 0.0, 0.0
    got = DA._decode_combine_reference(part_o, part_m, part_l, torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("n_valid,heads,rep", [
    (1, 64, 1), (700, 8, 2), (4096, 64, 1), (16384, 64, 1), (5000, 1, 8),
])
def test_chunking_covers_the_valid_range(n_valid, heads, rep):
    """The kernel's split covers the valid range with no empty chunk, runs
    in one wave of the CTAs the SMs hold at once (two up to rep 2), and
    evens the positions per SM: the busiest SM takes at most 5% more than
    the mean, plus one tile. No score buffer bounds a chunk any more. The
    geometry is the bf16 D128 kernel's: tiles of 64 positions, two CTAs an
    SM up to rep 2."""
    tile, per_sm = 64, 2 if rep <= 2 else 1
    chunk, n_chunks = DA._split(n_valid, heads, tile, 132, per_sm)
    assert (n_chunks - 1) * chunk < n_valid <= n_chunks * chunk
    ctas = heads * n_chunks
    assert ctas <= 132 * per_sm or n_chunks == 1
    assert -(-ctas // 132) * chunk <= 1.05 * heads * n_valid / 132 + tile


def _compose(q, ck, cv, length, ks, vs, window, chunk, n_chunks, layer):
    """The plain versions of the kernel's two stages, chained."""
    lo, _ = DA._valid_range(length, window)
    parts = DA._decode_partial_reference(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), ks,
        vs, lo, length, chunk, n_chunks, layer=layer)
    return parts, DA._decode_combine_reference(*parts, torch.float32)


@pytest.mark.parametrize("case", [
    "unaligned window lo", "tail tile past M", "rep 8",
    "many small chunks", "every chunk empty but one",
])
def test_kernel_split_edge_cases_match_jax(case):
    """The kernel's edge cases through the plain version and through its
    two stages, against the JAX kernel: a window whose first position is on
    no tile boundary; length M - 1 with M not a multiple of the tile; rep 8;
    a split of 7-position chunks; a split whose chunks are all past length
    but the first."""
    rep, length, window, m = REP, 437, 0, M
    if case == "unaligned window lo":
        window = 77                     # lo = 361
    elif case == "tail tile past M":
        length = m - 1                  # 700 positions, tiles of 128
    elif case == "rep 8":
        rep = 8
    rng = np.random.default_rng(sum(map(ord, case)))
    q = _normal(rng, B, KVH, rep, D)
    ck, cv = _normal(rng, 2, B, KVH, m, D), _normal(rng, 2, B, KVH, m, D)
    want = _jax(q, ck, cv, length, window=window, layer=1)
    np.testing.assert_allclose(_port(q, ck, cv, length, window=window,
                                     layer=1), want, atol=ATOL)
    lo, hi = DA._valid_range(length, window)
    n_valid = hi - lo + 1
    if case == "many small chunks":
        chunk, n_chunks = 7, -(-n_valid // 7)
    elif case == "every chunk empty but one":
        chunk, n_chunks = n_valid, 4
    else:
        # the kernel's split, at a tile scaled down with the sizes
        chunk, n_chunks = DA._split(n_valid, B * KVH, 16, sms=3)
    parts, out = _compose(q, ck, cv, length, None, None, window, chunk,
                          n_chunks, 1)
    if case == "every chunk empty but one":
        assert (parts[1][:, 1:] == DA.NEG_INF).all()
        assert (parts[2][:, 1:] == 0).all() and (parts[0][:, 1:] == 0).all()
    else:
        assert n_chunks > 1 and torch.isfinite(parts[1]).all()
    np.testing.assert_allclose(out.reshape(B, KVH, rep, D).numpy(), want,
                               atol=ATOL)


def test_combine_order_changes_the_bits():
    """Why the kernel's last CTA of a head combines the partials in chunk
    order, whichever CTA arrived last: the same partials summed in another
    order agree in value but not in their last bits, so a combine in arrival
    order would not repeat bit for bit. The kernel's repeat is checked on
    the card: chip_smoke.py launches it twice at every decode edge case and
    fails unless the outputs are bit-equal."""
    rng = np.random.default_rng(21)
    q = _normal(rng, B, KVH, REP, D)
    ck, cv = _normal(rng, 1, B, KVH, M, D), _normal(rng, 1, B, KVH, M, D)
    parts, out = _compose(q, ck, cv, M - 1, None, None, 0, 9, 78, 0)
    again = DA._decode_combine_reference(*parts, torch.float32)
    assert torch.equal(again, out)                 # same order, same bits
    differ = 0
    for seed in range(3):
        order = torch.from_numpy(np.random.default_rng(seed).permutation(78))
        shuffled = DA._decode_combine_reference(
            *(t[:, order] for t in parts), torch.float32)
        np.testing.assert_allclose(shuffled.numpy(), out.numpy(), atol=1e-6)
        differ += not torch.equal(shuffled, out)
    assert differ == 3


def test_kernel_input_checks():
    """A CUDA input the kernel does not take raises; these checks run before
    any launch, so they are testable on CPU tensors."""
    q = torch.zeros(1, 2, 1, 128, dtype=torch.bfloat16)
    ck = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one device"):
        DA._check_kernel_inputs(q, ck, ck, None, None, None)
    with pytest.raises(ValueError, match="4-d"):
        DA._check_kernel_inputs(q, ck[None], ck[None], None, None, None)
    with pytest.raises(ValueError, match="5-d"):
        DA._check_kernel_inputs(q, ck, ck, None, None, 0)


def test_flash_decode_bf16_cpu_returns_q_dtype():
    rng = np.random.default_rng(11)
    q = torch.from_numpy(_normal(rng, 1, 2, 2, 64)).bfloat16()
    ck = torch.from_numpy(_normal(rng, 1, 2, 40, 64)).bfloat16()
    out = DA.flash_decode(q, ck, ck, 39)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
