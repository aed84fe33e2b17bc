"""Port parity: tony_tpu_torch.models.speculative (greedy speculative
decoding, batch 1) against the JAX package's speculative_generate and the
port's own greedy generate, on the CPU at float32.

The target and drafts come from JAX ``transformer.init`` (converted with
``from_jax_params``); prompts come from numpy. Tokens must be identical
(every emitted token is the target's greedy argmax; seeds chosen with no
near-tie at these widths, as in test_torch_generate.py), and the stats
dict must equal the JAX one key for key.

Also: lm_generate's speculative path with a draft that lm_train trained
(the CLI, no --mesh), and the head_dim-32 envelope of the flash forward,
backward and decode kernels (a draft's heads), checked without a card."""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu_torch.models import generate as G
from tony_tpu_torch.models import speculative as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.ops import attention as A
from tony_tpu_torch.ops import decode_attention as DA

jG = importlib.import_module("tony_tpu.models.generate")
jS = importlib.import_module("tony_tpu.models.speculative")

TARGET = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
              d_ff=128, max_seq_len=128, dtype=jnp.float32)
DRAFT = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
             d_ff=64, max_seq_len=128, dtype=jnp.float32)
STAT_KEYS = ("rounds", "drafted", "accepted", "acceptance_rate", "delivered")


def _model(fields, seed):
    jcfg = jT.TransformerConfig(**fields)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def models():
    return {"target": _model(TARGET, 0), "draft": _model(DRAFT, 7)}


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 64, (1, n), dtype=np.int32)


def _both(models, draft_key, prompt, n_new, **kw):
    jt, t, tree, params = models["target"]
    jd, d, dtree, dparams = models[draft_key]
    ref, ref_stats = jS.speculative_generate(
        tree, jt, dtree, jd, jnp.asarray(prompt), n_new, return_stats=True,
        **kw)
    got, stats = S.speculative_generate(
        params, t, dparams, d, torch.from_numpy(prompt).long(), n_new,
        return_stats=True, **kw)
    return np.asarray(ref), ref_stats, got, stats


@pytest.mark.parametrize("draft_key", ["draft", "target"],
                         ids=["random_draft", "self_draft"])
@pytest.mark.parametrize("gamma", [1, 4])
def test_tokens_and_stats_match_jax_and_generate(models, draft_key, gamma):
    prompt = _prompt(1, 9)
    ref, ref_stats, got, stats = _both(models, draft_key, prompt, 20,
                                       gamma=gamma)
    assert got.dtype == torch.int32 and got.shape == (1, 20)
    np.testing.assert_array_equal(got.numpy(), ref)
    _, t, _, params = models["target"]
    plain = G.generate(params, t, torch.from_numpy(prompt).long(), 20)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert set(stats) == set(STAT_KEYS)
    for k in STAT_KEYS:
        assert stats[k] == pytest.approx(float(ref_stats[k])), k
    if draft_key == "target":
        # a self-draft agrees everywhere: gamma + 1 tokens a round
        assert stats["acceptance_rate"] == 1.0


def test_stop_tokens_match_jax_and_generate(models):
    prompt = _prompt(3, 7)
    _, t, _, params = models["target"]
    plain = G.generate(params, t, torch.from_numpy(prompt).long(), 24)
    stop = int(plain[0, 5])          # a token the greedy stream emits
    kw = dict(gamma=3, stop_tokens=(stop,), pad_id=63)
    ref, ref_stats, got, stats = _both(models, "draft", prompt, 24, **kw)
    np.testing.assert_array_equal(got.numpy(), ref)
    want = G.generate(params, t, torch.from_numpy(prompt).long(), 24,
                      stop_tokens=(stop,), pad_id=63)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    first = int(np.nonzero(plain[0].numpy() == stop)[0][0])
    assert stats["delivered"] == first + 1 == ref_stats["delivered"]
    assert (got[0, first + 1:] == 63).all()


def test_prepared_weights_and_one_token(models):
    jt, t, tree, params = models["target"]
    _, d, _, dparams = models["draft"]
    prompt = torch.from_numpy(_prompt(4, 5)).long()
    got = S.speculative_generate(G.prepare_decode(params, t), t,
                                 G.prepare_decode(dparams, d), d, prompt, 12)
    np.testing.assert_array_equal(got.numpy(),
                                  G.generate(params, t, prompt, 12).numpy())
    one, st = S.speculative_generate(params, t, dparams, d, prompt, 1,
                                     return_stats=True)
    assert one.shape == (1, 1) and st["rounds"] == 0 and st["delivered"] == 1


def test_validation_matches_jax(models):
    """The same rejections, with the JAX package's exception types."""
    jt, t, tree, params = models["target"]
    _, d, _, dparams = models["draft"]
    p1 = torch.zeros((1, 4), dtype=torch.long)
    cases = [
        (dict(prompt=torch.zeros((2, 4), dtype=torch.long)), "batch-1"),
        (dict(gamma=0), "gamma"),
        (dict(max_new_tokens=0), "max_new_tokens"),
        (dict(draft_cfg=dataclasses.replace(d, vocab_size=65)),
         "vocabulary"),
        (dict(draft_cfg=dataclasses.replace(d, causal=False)), "causal"),
    ]
    for over, match in cases:
        kw = {**dict(params=params, cfg=t, draft_params=dparams,
                     draft_cfg=d, prompt=p1, max_new_tokens=4, gamma=2),
              **over}
        with pytest.raises(ValueError, match=match):
            S.speculative_generate(**kw)
    jd = jT.TransformerConfig(**{**DRAFT, "vocab_size": 65})
    with pytest.raises(ValueError, match="vocabulary"):
        jS.speculative_generate(tree, jt, tree, jd, jnp.zeros((1, 4),
                                                              jnp.int32), 4)


def test_lm_generate_own_trained_draft(tmp_path, capsys):
    """lm_generate with --draft-checkpoint-dir on a draft lm_train trained:
    the same tokens as the plain run, and the speculative metrics."""
    from tony_tpu_torch.examples import lm_generate, lm_train

    dims = ["--vocab", "64", "--dtype", "float32", "--device", "cpu"]
    target = ["--d-model", "64", "--n-layers", "2", "--n-heads", "4",
              "--d-ff", "128"]
    ck, dck = tmp_path / "target", tmp_path / "draft"
    for out, shape in ((ck, target),
                       (dck, ["--d-model", "32", "--n-layers", "1",
                              "--n-heads", "2", "--d-ff", "64"])):
        lm_train.main(dims + shape + [
            "--steps", "3", "--batch-size", "2", "--seq-len", "16",
            "--checkpoint-dir", str(out), "--checkpoint-every", "3"])
    capsys.readouterr()
    gen = dims + target + ["--checkpoint-dir", str(ck), "--batch", "1",
                           "--prompt-len", "8", "--max-new", "12"]
    plain_metrics = tmp_path / "plain.json"
    lm_generate.main(gen + ["--metrics-out", str(plain_metrics)])
    plain = json.loads(plain_metrics.read_text())
    spec_metrics = tmp_path / "spec.json"
    lm_generate.main(gen + [
        "--draft-checkpoint-dir", str(dck), "--draft-d-model", "32",
        "--draft-n-layers", "1", "--draft-n-heads", "2", "--draft-d-ff",
        "64", "--metrics-out", str(spec_metrics)])
    spec = json.loads(spec_metrics.read_text())
    assert spec["tokens"] == plain["tokens"]
    assert "speculative" not in plain
    st = spec["speculative"]
    assert set(STAT_KEYS) <= set(st) and st["gamma"] == 4
    assert st["target_forwards"] == st["rounds"] + 1
    assert st["draft"]["head_dim"] == 16
    assert spec["generated_tokens"] == len(spec["tokens"]) == 12


@pytest.mark.parametrize("d", [16, 32, 48, 64, 128])
def test_head_dim_32_envelope(d):
    """K1's forward, the backward kernels (K3-K5) and K6 take head_dim 32
    (the default draft's), so a draft trains on the card; the envelope is
    checked before the device, so a CPU tensor shows which shapes would
    launch."""
    ok = d in (32, 64, 128)
    x = torch.zeros(1, 1, 4, d)
    assert A.flash_supported(x) == ok
    assert A.flash_supported(x, backward=True) == ok
    match = "same device" if ok else "head_dim in"
    with pytest.raises(ValueError, match=match):
        A._check_kernel_inputs(x, x, x)
    with pytest.raises(ValueError, match="same device" if ok
                       else "backward kernel takes head_dim"):
        A._check_kernel_inputs(x, x, x, backward=True)
    q = torch.zeros(1, 2, 1, d)
    ck = torch.zeros(1, 2, 8, d)
    with pytest.raises(ValueError, match="one device" if ok else "head_dim in"):
        DA._check_kernel_inputs(q, ck, ck, None, None, None)
