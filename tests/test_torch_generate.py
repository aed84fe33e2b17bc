"""Port parity: tony_tpu_torch.models.generate (KV-cache generation) against
the JAX package's generate on the CPU.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``;
prompts come from numpy. Both sides run in float32 with their plain
attention paths (the kernels run only on the card, where chip_smoke.py
holds them against these plain paths).

- Native caches: greedy tokens identical. Seeds 0 (params) and 1 (prompt)
  were chosen with no near-tie among the greedy logits (top-2 gap > 1e-3 at
  every step), so float32 summation order cannot flip a token.
- int8 caches: teacher-forced logits within atol 1e-3. Both sides quantise
  in float32 with the same rule, but a value that lands on a rounding
  boundary may round the other way in one framework; one int8 step in one
  cached element moves a logit by about 1e-4 at these widths.
- Sampling draws from a torch.Generator, whose numbers differ from JAX's, so
  it is checked within the port only."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu_torch.models import generate as G
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.ops import launch_counts, reset_launch_counts

# the JAX package's models/__init__ re-exports the function under the
# module's name
jG = importlib.import_module("tony_tpu.models.generate")

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=64, max_seq_len=64, dtype=jnp.float32)
INT8_LOGITS_ATOL = 1e-3


def _setup(seed=0, **over):
    jcfg = jT.TransformerConfig(**{**TINY, **over})
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


def _prompt(seed, b, l, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, l),
                                                dtype=np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


@pytest.mark.parametrize("over", [{}, {"n_kv_heads": 2},
                                  {"n_kv_heads": 2, "attn_window": 4}],
                         ids=["mha", "gqa", "window"])
def test_greedy_tokens_match_jax(over):
    jcfg, cfg, tree, params = _setup(**over)
    prompt = _prompt(1, 2, 6)
    ref = jG.generate(tree, jcfg, jnp.asarray(prompt), 10)
    got = G.generate(params, cfg, _t(prompt), 10)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _teacher_forced_logits(fwd, init, prompt, steps, cache_args):
    cache = init(*cache_args)
    logits, cache = fwd(prompt, cache, True)
    out = [np.asarray(logits)]
    for tok in steps:
        logits, cache = fwd(tok, cache, False)
        out.append(np.asarray(logits))
    return np.stack(out), cache


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_cached_forward_logits_match_jax(kv_dtype):
    """Prefill then single-token steps, fed the same tokens on both sides:
    native caches agree to the model-logits tolerance, int8 caches to the
    int8 tolerance (module docstring)."""
    jcfg, cfg, tree, params = _setup(n_kv_heads=2)
    prompt = _prompt(2, 2, 7)
    steps = _prompt(3, 6, 2)[:, :, None]            # 6 steps of [B, 1]
    jfused = jG._fuse_decode_weights(tree, jcfg)
    fused = G._fuse_decode_weights(params, cfg)

    def jfwd(tokens, cache, prefill):
        return jG._forward_with_cache(tree, jcfg, jnp.asarray(tokens), cache,
                                      jfused, prefill=prefill)

    def fwd(tokens, cache, prefill):
        return G._forward_with_cache(params, cfg, _t(tokens), cache, fused,
                                     prefill=prefill)

    ref, jcache = _teacher_forced_logits(jfwd, jG.init_cache, prompt, steps,
                                         (jcfg, 2, 16, kv_dtype))
    got, cache = _teacher_forced_logits(
        fwd, lambda *a: G.init_cache(*a, device="cpu"), prompt, steps,
        (cfg, 2, 16, kv_dtype))
    atol = 1e-4 if kv_dtype == "native" else INT8_LOGITS_ATOL
    np.testing.assert_allclose(got, ref, atol=atol)
    assert cache.length == int(jcache.length) == 13
    if kv_dtype == "int8":
        assert cache.k.dtype == torch.int8
        assert cache.k_scale.dtype == torch.bfloat16


def test_chunk_into_nonempty_cache_all_logits_match_jax():
    """A multi-token chunk into a non-empty cache takes the general
    cached-attention path; all_logits projects every position."""
    jcfg, cfg, tree, params = _setup(n_kv_heads=2, attn_window=5)
    a, b = _prompt(4, 2, 5), _prompt(5, 2, 4)
    jc = jG.init_cache(jcfg, 2, 16)
    _, jc = jG._forward_with_cache(tree, jcfg, jnp.asarray(a), jc, None,
                                   prefill=True)
    ref, _ = jG._forward_with_cache(tree, jcfg, jnp.asarray(b), jc, None,
                                    all_logits=True)
    c = G.init_cache(cfg, 2, 16, device="cpu")
    _, c = G._forward_with_cache(params, cfg, _t(a), c, None, prefill=True)
    got, c = G._forward_with_cache(params, cfg, _t(b), c, None,
                                   all_logits=True)
    assert got.shape == (2, 4, 64) and c.length == 9
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_int8_generate_tokens_match_jax():
    """At these seeds the int8 cache's greedy tokens agree as well (the
    logits agree within INT8_LOGITS_ATOL, far inside the top-2 gaps)."""
    jcfg, cfg, tree, params = _setup()
    prompt = _prompt(1, 2, 6)
    ref = jG.generate(tree, jcfg, jnp.asarray(prompt), 8, kv_dtype="int8")
    got = G.generate(params, cfg, _t(prompt), 8, kv_dtype="int8")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 2, 5, 16)) \
        .astype(np.float32)
    jq, js = jG._quantize_kv(jnp.asarray(x))
    q, s = G._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js).astype(np.float32))


def test_stop_tokens_early_exit_matches_jax():
    jcfg, cfg, tree, params = _setup()
    prompt = _prompt(1, 2, 6)
    free = np.asarray(jG.generate(tree, jcfg, jnp.asarray(prompt), 10))
    stops = (int(free[0, 2]), int(free[1, 2]))   # both rows stop by step 2
    ref, ref_steps = jG.generate(tree, jcfg, jnp.asarray(prompt), 10,
                                 stop_tokens=stops, pad_id=63,
                                 return_steps=True)
    got, steps = G.generate(params, cfg, _t(prompt), 10, stop_tokens=stops,
                            pad_id=63, return_steps=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert steps == int(ref_steps) <= 2
    assert (got[:, 3:] == 63).all()


def test_cache_continuation_matches_one_shot():
    """generate(return_cache=True) returns a cache holding prompt + every
    emitted token; continuing with only the new turn is token-exact against
    one generate over the whole conversation, here and in JAX."""
    jcfg, cfg, tree, params = _setup()
    t1, t2 = _prompt(7, 2, 6), _prompt(8, 2, 4)
    out1, cache = G.generate(params, cfg, _t(t1), 5, max_len=32,
                             return_cache=True)
    assert cache.length == 6 + 5
    k_ptr = cache.k.data_ptr()
    out2, cache2 = G.generate(params, cfg, _t(t2), 6, cache=cache,
                              return_cache=True)
    assert cache2.k.data_ptr() == k_ptr          # updated in place
    assert cache2.length == 11 + 4 + 6
    full = np.concatenate([t1, out1.numpy(), t2], axis=1)
    one_shot = G.generate(params, cfg, _t(full), 6)
    np.testing.assert_array_equal(out2.numpy(), one_shot.numpy())
    ref = jG.generate(tree, jcfg, jnp.asarray(full), 6)
    np.testing.assert_array_equal(out2.numpy(), np.asarray(ref))

    # an int8 cache continues too, its kv dtype inherited
    _, c8 = G.generate(params, cfg, _t(t1), 5, max_len=32, kv_dtype="int8",
                       return_cache=True)
    o2, c8b = G.generate(params, cfg, _t(t2), 4, cache=c8, return_cache=True)
    assert o2.shape == (2, 4) and c8b.k.dtype == torch.int8


def test_cache_continuation_rejections():
    _, cfg, _, params = _setup()
    t1, t2 = _t(_prompt(7, 2, 6)), _t(_prompt(8, 2, 4))
    _, small = G.generate(params, cfg, t1, 5, max_len=16, return_cache=True)
    with pytest.raises(ValueError, match="return_cache"):
        G.generate(params, cfg, t2, 6, cache=small)
    with pytest.raises(ValueError, match="capacity"):
        G.generate(params, cfg, t2, 6, cache=small, return_cache=True)
    with pytest.raises(ValueError, match="batch"):
        G.generate(params, cfg, t2[:1], 2, cache=small, return_cache=True)
    with pytest.raises(ValueError, match="kv_dtype"):
        G.generate(params, cfg, t2, 1, cache=small, kv_dtype="int8",
                   return_cache=True)
    with pytest.raises(ValueError, match="max_len"):
        G.generate(params, cfg, t2, 1, cache=small, max_len=20,
                   return_cache=True)


def test_generate_rejections():
    _, cfg, _, params = _setup()
    p = _t(_prompt(1, 1, 4))
    with pytest.raises(ValueError, match="max_new_tokens"):
        G.generate(params, cfg, p, 0)
    with pytest.raises(ValueError, match="causal"):
        G.generate(params, dataclasses.replace(cfg, causal=False), p, 2)
    with pytest.raises(ValueError, match="weight_dtype"):
        G.generate(params, cfg, p, 2, weight_dtype="fp8")
    with pytest.raises(ValueError, match="max_len"):
        G.generate(params, cfg, p, 4, max_len=6)
    prepared = G.prepare_decode(params, cfg)
    with pytest.raises(ValueError, match="prepare_decode"):
        G.generate(prepared, cfg, p, 2, weight_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        G.init_cache(cfg, 1, 8, "fp8", device="cpu")
    cache = G.init_cache(cfg, 1, 8, device="cpu")
    _, cache = G._forward_with_cache(params, cfg, p, cache, prefill=True)
    with pytest.raises(ValueError, match="empty cache"):
        G._forward_with_cache(params, cfg, p, cache, prefill=True)
    with pytest.raises(ValueError, match="capacity"):
        G._forward_with_cache(params, cfg, _t(_prompt(1, 1, 5)), cache)


def test_prepared_weights_give_the_same_tokens():
    _, cfg, _, params = _setup()
    bf = dataclasses.replace(cfg, dtype=torch.bfloat16)
    prepared = G.prepare_decode(params, bf)
    assert prepared.params["embed"].dtype == torch.bfloat16
    assert prepared.fused["wqkv"].shape == (2, 32, 96)
    assert prepared.fused["w_gu"].shape == (2, 32, 128)
    p = _t(_prompt(1, 2, 5))
    np.testing.assert_array_equal(G.generate(prepared, bf, p, 4).numpy(),
                                  G.generate(params, bf, p, 4).numpy())


def test_cpu_generate_launches_no_kernel():
    """On the CPU every attention runs its plain version: no launches."""
    _, cfg, _, params = _setup()
    reset_launch_counts()
    G.generate(params, cfg, _t(_prompt(1, 2, 5)), 4)
    assert set(launch_counts().values()) == {0}


def test_sampling_within_the_port():
    _, cfg, _, params = _setup()
    p = _t(_prompt(9, 2, 5))

    def draw(seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        return G.generate(params, cfg, p, 6, generator=gen, **kw)

    a = draw(0, temperature=0.8, top_k=5)
    assert torch.equal(a, draw(0, temperature=0.8, top_k=5))  # reproducible
    assert ((a >= 0) & (a < 64)).all()
    greedy = G.generate(params, cfg, p, 6)
    assert torch.equal(draw(3, temperature=1.0, top_k=1), greedy)

    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 64)).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    top3 = torch.topk(logits, 3).indices
    for _ in range(10):
        tok = G.sample_token(logits, gen, temperature=2.0, top_k=3)
        assert tok.dtype == torch.int32
        assert (top3 == tok[:, None].long()).any(dim=1).all()
    assert torch.equal(G.sample_token(logits),
                       logits.argmax(-1).to(torch.int32))


def test_sampling_follows_the_softmax():
    """4000 draws from fixed logits land within 0.03 of the softmax
    probabilities (a few standard errors of a frequency at n = 4000)."""
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).expand(4000, 4)
    gen = torch.Generator().manual_seed(2)
    tok = G.sample_token(logits, gen, temperature=1.5)
    freq = torch.bincount(tok.long(), minlength=4).float() / 4000
    want = torch.softmax(logits[0] / 1.5, -1)
    assert (freq - want).abs().max() < 0.03
