"""Port parity: tony_tpu_torch.models.transformer (forward pass) against the
JAX package's transformer on the CPU.

Parameters come from JAX ``transformer.init`` and go through
``from_jax_params``; tokens come from numpy. Both sides run in float32 with
the plain attention. Logits tolerance: atol 1e-4, test_ops.py's gradient
tolerance, because a logit is a sum over every layer's float32 rounding,
taken in another order in each framework."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params

LOGITS_ATOL = 1e-4
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=64, max_seq_len=64, dtype=jnp.float32)


def _configs(**over):
    jcfg = jT.TransformerConfig(**{**TINY, **over})
    return jcfg, config_from_fields(dataclasses.asdict(jcfg))


def _params(jcfg, cfg, seed=0):
    tree = jax.device_get(jT.init(jax.random.PRNGKey(seed), jcfg))
    return tree, from_jax_params(tree, cfg, "cpu")


def _tokens(seed, b, l, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, l),
                                                dtype=np.int32)


@pytest.mark.parametrize("over", [
    {},                                              # MHA
    {"n_kv_heads": 2},                               # GQA
    {"n_kv_heads": 1, "attn_window": 5},             # MQA + sliding window
    {"causal": False},                               # bidirectional encoder
    {"rope_scaling": ("llama3", 8.0, 1.0, 4.0, 16)},  # llama3 context ext.
], ids=["mha", "gqa", "window", "bidirectional", "llama3_rope"])
def test_apply_logits_match_jax(over):
    jcfg, cfg = _configs(**over)
    tree, params = _params(jcfg, cfg)
    tokens = _tokens(1, 2, 24, jcfg.vocab_size)
    ref, _ = jT.apply(tree, jnp.asarray(tokens), jcfg)
    got, aux = T.apply(params, torch.from_numpy(tokens).long(), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 64)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=LOGITS_ATOL)


def test_apply_flash_impl_on_cpu_matches_ref():
    """attn_impl="flash" on a CPU tensor runs the flash op's plain version:
    the same logits as "ref" within the flash tolerance."""
    jcfg, cfg = _configs(attn_window=7)
    _, params = _params(jcfg, cfg)
    tokens = torch.from_numpy(_tokens(2, 2, 20, 64)).long()
    flash, _ = T.apply(params, tokens, dataclasses.replace(cfg,
                                                           attn_impl="flash"))
    ref, _ = T.apply(params, tokens, dataclasses.replace(cfg, attn_impl="ref"))
    np.testing.assert_allclose(flash.numpy(), ref.numpy(), atol=2e-5)


def test_apply_bf16_activations_close_to_jax():
    """bf16 activations (the flagship's dtype): the two frameworks round at
    the same places; atol 5e-2 allows a few bf16 ulps of drift in logits of
    magnitude about 1 after two layers."""
    jcfg, cfg = _configs(dtype=jnp.bfloat16)
    assert cfg.dtype == torch.bfloat16
    tree, params = _params(jcfg, cfg)
    tokens = _tokens(3, 2, 16, 64)
    ref, _ = jT.apply(tree, jnp.asarray(tokens), jcfg)
    got, _ = T.apply(params, torch.from_numpy(tokens).long(), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-2)


@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 1e-6),
                                        (jnp.bfloat16, 8e-3)])
def test_rms_norm_matches_jax(dtype, atol):
    """Normalised in float32, cast back to x's dtype BEFORE the weight
    multiply; bf16 tolerance is one bf16 ulp at |x| < 2."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    ref = jT.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w), 1e-6)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = T.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w), 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref).astype(np.float32), atol=atol)


@pytest.mark.parametrize("scaling", [None, ("llama3", 8.0, 1.0, 4.0, 32)])
def test_rope_matches_jax(scaling):
    """Positions up to 200: f32 angles, where sin/cos of the two libraries
    agree to a few ulps of the angle (atol 2e-5)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 200, (2, 5))
    ref = jT.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, scaling)
    got = T.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_rope_rejects_unknown_scaling():
    with pytest.raises(ValueError, match="rope scaling"):
        T.rope(torch.zeros(1, 1, 1, 8), torch.zeros(1, 1), 1e4,
               ("yarn", 2.0, 1.0, 4.0, 16))


def test_attention_dispatch():
    """"ref" is the plain attention everywhere; the sequence-parallel impls
    need a mesh, as the JAX package's do; bad windows raise."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 6, 2, 8))
                                .astype(np.float32)) for _ in range(3))
    _, cfg = _configs()
    for impl in ("auto", "ref", "flash"):
        out = T._attention(q, k, v, dataclasses.replace(cfg, attn_impl=impl))
        assert out.shape == q.shape
    for impl in ("ring", "ulysses"):
        with pytest.raises(ValueError, match="requires a mesh"):
            T._attention(q, k, v, dataclasses.replace(cfg, attn_impl=impl))
    with pytest.raises(ValueError, match="unknown attn_impl"):
        T._attention(q, k, v, dataclasses.replace(cfg, attn_impl="nope"))
    with pytest.raises(ValueError, match="attn_window must be"):
        T._attention(q, k, v, dataclasses.replace(cfg, attn_window=-1))
    with pytest.raises(ValueError, match="causal"):
        T._attention(q, k, v, dataclasses.replace(cfg, attn_window=2,
                                                  causal=False))


def test_init_shapes_and_scales_match_jax():
    """The port's own init draws from a torch.Generator: the numbers differ
    from JAX's, the shapes, dtypes and scales do not."""
    jcfg, cfg = _configs(n_kv_heads=2)
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    gen = torch.Generator().manual_seed(0)
    params = T.init(cfg, gen, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = params
        for key in keys:
            t = t[key]
        assert tuple(t.shape) == leaf.shape, keys
        assert t.dtype == torch.float32
    assert T.num_params(params) == sum(x.size for _, x in flat_j)
    # N(0, 1/in) draws: the embed's std is d_model ** -0.5
    assert abs(params["embed"].std().item() - 32 ** -0.5) < 0.02
    assert torch.equal(params["layers"]["attn_norm"], torch.ones(2, 32))
    again = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["unembed"], params["unembed"])


@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 2e-5),
                                         (jnp.bfloat16, 3e-2)],
                         ids=["float32", "bfloat16"])
def test_moe_mlp_matches_jax(dtype, atol):
    """One layer's MoE MLP (4 experts, top-2, capacity factor 1.25: the
    24 tokens overflow some experts) from the same hidden states: out and
    the aux loss against the JAX _mlp's. At bf16 the experts route on the
    bf16-rounded router and the aux loss on the float32 one, in both
    frameworks. JAX seed 0 and numpy seed 4 hold no router near-tie."""
    jcfg, cfg = _configs(n_experts=4, dtype=dtype)
    tree, params = _params(jcfg, cfg)
    h = np.random.default_rng(4).standard_normal((2, 12, 32)).astype(
        np.float32)
    jh = jnp.asarray(h, dtype)
    jlp = {n: w[0] for n, w in tree["layers"].items()}
    want, want_aux = jT._mlp(jcfg, jh, jlp)
    got, aux = T._mlp(cfg, torch.from_numpy(np.array(
        jh.astype(jnp.float32))).to(cfg.dtype), T.layer_params(params, 0))
    assert got.dtype == cfg.dtype and aux.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=2e-5)


def test_from_jax_params_rejects_bad_trees():
    jcfg, cfg = _configs()
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    bad = {**tree, "layers": {**tree["layers"]}}
    del bad["layers"]["wq"]
    with pytest.raises(ValueError, match="parameter keys"):
        from_jax_params(bad, cfg, "cpu")
    bad["layers"]["wq"] = np.zeros((2, 32, 4, 4), np.float32)
    with pytest.raises(ValueError, match="wq: shape"):
        from_jax_params(bad, cfg, "cpu")
    bf16 = from_jax_params(tree, cfg, "cpu", torch.bfloat16)
    assert bf16["embed"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="does not have"):
        config_from_fields({"d_model": 8, "bogus": 1})
