"""Port parity: the Mixture-of-Experts model (models/transformer.py's MoE
MLP, models/generate.py's MoE decode, speculative decoding, the
SlotServer and the entry points' ``--n-experts``) against the JAX package
on the CPU.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``
(TINY widths: 2 layers, d_model 32-64, 4 experts, top-2); tokens come from
numpy. Both sides run in float32 with the plain attention. The forward,
aux loss and loss are held within 2e-5, gradients within 1e-4 (the parity
contract); greedy tokens are identical. The JAX seeds below were drawn
with no router near-tie at these widths (``torch.topk`` and
``lax.top_k`` may order tied probabilities differently) and no near-tie
among the greedy logits. Every JAX reference is computed once, in a
module-scoped fixture."""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu.models.serving import Request as JRequest
from tony_tpu.models.serving import SlotServer as JSlotServer
from tony_tpu_torch import train as ptrain
from tony_tpu_torch.examples import lm_generate, lm_train
from tony_tpu_torch.models import generate as G
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models import speculative as SP
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.train import checkpoint as C
from tony_tpu_torch.train.step import _leaves

jG = importlib.import_module("tony_tpu.models.generate")
jSP = importlib.import_module("tony_tpu.models.speculative")

ATOL, GRAD_ATOL = 2e-5, 1e-4
# the training-forward model: the default capacity factor 1.25, so the
# 32-token batch drops tokens (capacity 20 an expert)
TRAIN_MOE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                 n_kv_heads=4, d_ff=64, max_seq_len=64, dtype=jnp.float32,
                 n_experts=4, expert_top_k=2, ce_block_v=16)
# test_models.py:669's model (vocab 128, d64, capacity factor 2.0)
GEN_MOE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
               n_kv_heads=4, d_ff=64, max_seq_len=128, dtype=jnp.float32,
               n_experts=4, expert_top_k=2, capacity_factor=2.0,
               attn_impl="ref")
DRAFT = dict(vocab_size=128, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
             d_ff=64, max_seq_len=128, dtype=jnp.float32)
SRV = dict(slots=2, max_len=64, block_size=4, prefill_chunk=8)
POLICIES = (None, "full", "dots", "attn")


def _model(fields, seed):
    jcfg = jT.TransformerConfig(**fields)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


def _flat_jax(tree, prefix=""):
    out = {}
    for name in sorted(tree):
        node = tree[name]
        if isinstance(node, dict):
            out.update(_flat_jax(node, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = np.asarray(node)
    return out


def _ids(seed, b, l, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, l),
                                                dtype=np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


@pytest.fixture(scope="module")
def train_moe():
    """TRAIN_MOE (JAX seed 0), a batch of 2 x 16 (numpy seeds 1, 2) and the
    JAX package's logits, aux, loss and gradients on it."""
    model = _model(TRAIN_MOE, 0)
    jcfg, _, tree, _ = model
    tokens, targets = _ids(1, 2, 16, 64), _ids(2, 2, 16, 64)
    logits, aux = jT.apply(tree, jnp.asarray(tokens), jcfg)
    loss, grads = jax.value_and_grad(jT.loss_fn)(
        tree, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    want = dict(logits=np.asarray(logits), aux=float(aux), loss=float(loss),
                grads=_flat_jax(jax.device_get(grads)))
    return model, tokens, targets, want


@pytest.fixture(scope="module")
def gen_moe():
    """GEN_MOE (JAX seed 4) and a dense draft (JAX seed 7)."""
    return {"target": _model(GEN_MOE, 4), "draft": _model(DRAFT, 7)}


# ---------------------------------------------------------------- the model

def test_moe_tree_init_and_conversion(train_moe):
    """init's MoE tree (router [L, d, E], w_in [L, E, d, f], w_out [L, E,
    f, d] at the JAX package's scales, no dense MLP) and from_jax_params
    carrying it; a dense tree under an MoE config raises."""
    (jcfg, cfg, tree, params), *_ = train_moe
    mine = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for p in (mine, params):
        lp = p["layers"]
        assert "w_gate" not in lp and "w_up" not in lp and "w_down" not in lp
        assert tuple(lp["router"].shape) == (2, 32, 4)
        assert tuple(lp["w_in"].shape) == (2, 4, 32, 64)
        assert tuple(lp["w_out"].shape) == (2, 4, 64, 32)
    assert T.num_params(mine) == T.num_params(params) == sum(
        x.size for x in jax.tree.leaves(tree))
    # N(0, 1/in) draws: w_out's fan-in is d_ff
    assert abs(mine["layers"]["w_out"].std().item() - 64 ** -0.5) < 0.01
    assert abs(mine["layers"]["router"].std().item() - 32 ** -0.5) < 0.02
    dense = jax.device_get(jT.init(jax.random.PRNGKey(0), dataclasses.replace(
        jcfg, n_experts=0)))
    with pytest.raises(ValueError, match="parameter keys"):
        from_jax_params(dense, cfg, "cpu")


def test_forward_aux_and_loss_match_jax(train_moe):
    (_, cfg, _, params), tokens, targets, want = train_moe
    logits, aux = T.apply(params, _t(tokens), cfg)
    assert logits.shape == (2, 16, 64) and aux.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want["logits"], atol=ATOL)
    np.testing.assert_allclose(float(aux), want["aux"], atol=ATOL)
    assert float(aux) > 0          # aux_loss_weight x the balancing loss
    loss = T.loss_fn(params, _t(tokens), _t(targets), cfg)
    np.testing.assert_allclose(float(loss), want["loss"], atol=ATOL)


@pytest.mark.parametrize("policy", POLICIES,
                         ids=["no_remat", "full", "dots", "attn"])
def test_loss_and_gradients_match_jax(train_moe, policy):
    """Every leaf's gradient (the router's through the gates and the aux
    loss) under each remat policy: remat keeps the aux loss."""
    (_, cfg, tree, _), tokens, targets, want = train_moe
    if policy is not None:
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    params = from_jax_params(tree, cfg, "cpu")
    leaves = [p.requires_grad_() for _, p in _leaves(params)]
    loss = T.loss_fn(params, _t(tokens), _t(targets), cfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), want["loss"], atol=ATOL)
    for (name, _), g in zip(_leaves(params), grads):
        np.testing.assert_allclose(g.numpy(), want["grads"][name],
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.fixture(scope="module")
def train_ref(gen_moe):
    """A batch of 4 x 16 (numpy seed 3, next-token targets; 8 x 16 until
    the per-test time budget needed it) and the JAX loss and gradient norm
    of GEN_MOE on it."""
    jcfg, _, tree, _ = gen_moe["target"]
    tokens = _ids(3, 4, 16, 128)
    targets = np.roll(tokens, -1, axis=1)
    loss, grads = jax.value_and_grad(jT.loss_fn)(
        tree, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(grads))))
    return tokens, targets, float(loss), norm


def test_moe_model_trains(gen_moe, train_ref):
    """test_models.py:107's counterpart on one device (its model, GEN_MOE):
    eight steps on one batch of 4 x 16 lower the loss by more than 0.05;
    the first step's loss and gradient norm are the JAX loss_fn's."""
    _, cfg, tree, _ = gen_moe["target"]
    tokens, targets, want_loss, want_norm = train_ref
    bundle = ptrain.create_train_step(
        cfg, device="cpu", params=from_jax_params(tree, cfg, "cpu"))
    params, opt, losses = bundle.params, bundle.opt_state, []
    for i in range(8):
        params, opt, m = bundle.step_fn(params, opt, _t(tokens), _t(targets))
        if i == 0:
            np.testing.assert_allclose(float(m["loss"]), want_loss,
                                       atol=ATOL)
            np.testing.assert_allclose(float(m["grad_norm"]), want_norm,
                                       rtol=1e-5)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.05, losses


DIMS = ["--d-model", "32", "--n-layers", "2", "--n-heads", "4", "--d-ff",
        "64", "--vocab", "64", "--dtype", "float32", "--n-experts", "4"]
TRAIN = ["--device", "cpu", "--batch-size", "2", "--seq-len", "16"] + DIMS


def _losses(argv):
    out = argv[argv.index("--metrics-out") + 1]
    assert lm_train.main(argv) == 0
    with open(out) as f:
        return json.load(f)["losses"]


def test_lm_train_checkpoint_resume_and_generate(tmp_path):
    """lm_train --n-experts 4: 6 steps straight against 3 and 3 resumed
    from the checkpoint, the same losses digit for digit (the MoE tree and
    its optimizer state restored bit-equal); then lm_generate --n-experts 4
    --checkpoint-dir decodes generate's greedy tokens on the restored
    parameters, native and int8 weights alike running."""
    m = str(tmp_path / "m.json")
    straight = _losses(TRAIN + ["--steps", "6", "--metrics-out", m])
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "3"]
    first = _losses(TRAIN + ck + ["--steps", "3", "--metrics-out", m])
    resumed = _losses(TRAIN + ck + ["--steps", "3", "--metrics-out", m])
    assert first == straight[:3] and resumed == straight[3:]
    assert all(np.isfinite(straight))

    cfg = T.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                              n_heads=4, n_kv_heads=4, d_ff=64, n_experts=4,
                              dtype=torch.float32)
    mgr = C.CheckpointManager(str(tmp_path / "ck"), save_interval=3)
    saved = mgr.restore()
    mgr.close()
    assert set(saved["params"]["layers"]) >= {"router", "w_in", "w_out"}
    params = C.restore_lm_params(str(tmp_path / "ck"), T.init(
        cfg, torch.Generator().manual_seed(9), "cpu"))
    for (name, a), (_, b) in zip(_leaves(params), _leaves(saved["params"])):
        assert torch.equal(a, b), name
    want = G.generate(params, cfg, torch.tensor([[1, 2, 3, 4, 5]]),
                      6)[0].tolist()
    out = tmp_path / "gen.json"
    base = ["--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
            "--prompt", "1 2 3 4 5", "--max-new", "6"] + DIMS
    assert lm_generate.main(base + ["--metrics-out", str(out)]) == 0
    assert json.loads(out.read_text())["tokens"] == want
    assert lm_generate.main(base + ["--weight-dtype", "int8",
                                    "--metrics-out", str(out)]) == 0
    toks = json.loads(out.read_text())["tokens"]
    assert len(toks) == 6 and all(0 <= t < 64 for t in toks)


# --------------------------------------------------------------- generation

def test_generate_matches_teacher_forcing_and_jax(gen_moe):
    """test_models.py:669: with drop-free capacity the cached path equals
    the full forward's argmax continuation; the tokens are the JAX
    generate's (seeds 4 and 5)."""
    jcfg, cfg, tree, params = gen_moe["target"]
    prompt = _ids(5, 2, 6, 128)
    got = G.generate(params, cfg, _t(prompt), 8)
    want = jG.generate(tree, jcfg, jnp.asarray(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    seq = _t(prompt)
    for i in range(8):
        logits, _ = T.apply(params, seq, G.moe_dropfree(cfg))
        nxt = logits[:, -1].argmax(-1)
        np.testing.assert_array_equal(got[:, i].numpy(), nxt.numpy())
        seq = torch.cat([seq, nxt[:, None]], dim=1)


W8_PROMPT = _ids(1, 2, 8, 128)


@pytest.fixture(scope="module")
def w8_ref(gen_moe):
    """The JAX package's int8 decode weights of GEN_MOE and its w8 prefill
    logits for W8_PROMPT (numpy seed 1)."""
    jcfg, _, tree, _ = gen_moe["target"]
    fused = jG._fuse_decode_weights(tree, jcfg, "int8")
    jcfg = jG.moe_dropfree(jcfg)
    logits, _ = jG._forward_with_cache(tree, jcfg, jnp.asarray(W8_PROMPT),
                                       jG.init_cache(jcfg, 2, 12), fused,
                                       prefill=True)
    return {k: np.asarray(v) for k, v in fused.items()}, np.asarray(logits)


def test_w8_decode_weights_and_numerics_bounded(gen_moe, w8_ref):
    """test_models.py:576: int8 experts with per-expert per-output-channel
    scales, quantized as the JAX package quantizes them; the prefill
    logits within int8 resolution of native; generation runs."""
    _, cfg, _, params = gen_moe["target"]
    fused8 = G._fuse_decode_weights(params, cfg, "int8")
    want, want_logits = w8_ref
    assert sorted(fused8) == sorted(want) == sorted(
        ["wqkv", "wqkv_s", "wo", "wo_s", "unembed", "unembed_s", "w_in",
         "w_in_s", "w_out", "w_out_s"])
    for name, w in want.items():
        if name.endswith("_s"):
            np.testing.assert_allclose(fused8[name].numpy(), w, rtol=1e-7)
        else:
            assert fused8[name].dtype == torch.int8
            np.testing.assert_array_equal(fused8[name].numpy(), w)
    assert tuple(fused8["w_in_s"].shape) == (2, 4, 1, 64)
    assert sorted(G._fuse_decode_weights(params, cfg)) == ["wqkv"]

    prompt = _t(W8_PROMPT)
    cfg = G.moe_dropfree(cfg)
    native, _ = G._forward_with_cache(params, cfg, prompt,
                                      G.init_cache(cfg, 2, 12, device="cpu"),
                                      None, prefill=True)
    w8, _ = G._forward_with_cache(params, cfg, prompt,
                                  G.init_cache(cfg, 2, 12, device="cpu"),
                                  fused8, prefill=True)
    ln, l8 = native.numpy(), w8.numpy()
    span = (ln.max(-1) - ln.min(-1))[..., None]
    assert (np.abs(l8 - ln) <= 0.05 * span + 0.05).all()
    assert not np.array_equal(l8, ln)
    np.testing.assert_allclose(l8, want_logits, atol=1e-4)
    out = G.generate(params, cfg, prompt, 6, weight_dtype="int8")
    assert out.shape == (2, 6) and ((out >= 0) & (out < 128)).all()


def test_decode_precast_keeps_the_router_float32(gen_moe):
    """test_models.py:611: the bf16 decode pre-cast rounds every float32
    weight but the router; bf16 MoE decode runs end to end, int8 too."""
    _, cfg, _, params = gen_moe["target"]
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    for cast in (G._cast_decode_params(params, cfg),
                 G.prepare_decode(params, cfg).params,
                 G.prepare_decode(params, cfg, weight_dtype="int8").params):
        assert cast["layers"]["router"].dtype == torch.float32
        assert torch.equal(cast["layers"]["router"],
                           params["layers"]["router"])
        assert cast["layers"]["wq"].dtype == torch.bfloat16
        assert cast["layers"]["w_in"].dtype == torch.bfloat16
        assert cast["embed"].dtype == torch.bfloat16
    assert params["layers"]["router"].dtype == torch.float32
    prompt = _t(_ids(1, 2, 8, 128))
    for wd in ("native", "int8"):
        out = G.generate(params, cfg, prompt, 4, weight_dtype=wd)
        assert out.shape == (2, 4)


SPEC_PROMPT = _ids(1, 1, 8, 128)


@pytest.fixture(scope="module")
def spec_ref(gen_moe):
    """The JAX speculative_generate of GEN_MOE on SPEC_PROMPT (numpy seed
    1), gamma 2, with the dense draft and with itself: (tokens, stats)."""
    jt, _, tree, _ = gen_moe["target"]
    jd, _, dtree, _ = gen_moe["draft"]
    return [jSP.speculative_generate(tree, jt, dm, dc, jnp.asarray(
        SPEC_PROMPT), 8, gamma=2, return_stats=True)
        for dm, dc in ((dtree, jd), (tree, jt))]


def test_speculative_moe_and_rejections(gen_moe, spec_ref):
    """test_models.py:1235: an MoE target speculates with a dense draft and
    with itself (drop-free capacity on both models): the JAX package's
    tokens and stats, and generate's; bad calls fail as the JAX ones do."""
    _, t, _, params = gen_moe["target"]
    _, d, _, dparams = gen_moe["draft"]
    prompt = SPEC_PROMPT
    ref = G.generate(params, t, _t(prompt), 8)
    for (dm, dc), (want, wst) in zip(((dparams, d), (params, t)), spec_ref):
        got, st = SP.speculative_generate(params, t, dm, dc, _t(prompt), 8,
                                          gamma=2, return_stats=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        assert st["rounds"] == int(wst["rounds"])
        assert st["accepted"] == int(wst["accepted"])
    with pytest.raises(ValueError, match="batch-1"):
        SP.speculative_generate(params, t, dparams, d,
                                torch.zeros(2, 4, dtype=torch.long), 4)
    bad = dataclasses.replace(d, vocab_size=256)
    with pytest.raises(ValueError, match="vocab"):
        SP.speculative_generate(params, t, T.init(
            bad, torch.Generator().manual_seed(2), "cpu"), bad, _t(prompt), 4)
    with pytest.raises(ValueError, match="gamma"):
        SP.speculative_generate(params, t, dparams, d, _t(prompt), 4,
                                gamma=0)


# ------------------------------------------------------------------ serving

def _prompts(n, seed, lo=2, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, int(rng.integers(lo, hi)), dtype=np.int32)
            for _ in range(n)]


PROMPTS, BUDGETS = _prompts(5, 11), [9, 6, 12, 7, 10]


@pytest.fixture(scope="module")
def served(gen_moe):
    """The JAX SlotServer's completions and JAX solo generate on GEN_MOE
    for PROMPTS (numpy seed 11): the references of every engine below."""
    jcfg, _, tree, _ = gen_moe["target"]
    jsrv = JSlotServer(tree, jcfg, **SRV)
    reqs = [JRequest(prompt=p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    for r in reqs:
        jsrv.submit(r)
    done = jsrv.run_until_drained()
    jsrv.shutdown()
    solo = [[int(x) for x in np.asarray(jG.generate(
        tree, jcfg, jnp.asarray(p)[None], b))[0]]
        for p, b in zip(PROMPTS, BUDGETS)]
    return [done[r.id].tokens for r in reqs], solo


ENGINES = {"ring": {}, "paged": dict(paged=True, kv_block=4),
           "ring_self_draft": "self", "paged_self_draft": "self_paged"}


@pytest.fixture(scope="module")
def port_solo_served(gen_moe):
    """The port's solo generate for PROMPTS, once for every engine."""
    _, cfg, _, params = gen_moe["target"]
    return [G.generate(params, cfg, torch.from_numpy(p).long()[None],
                       b)[0].tolist() for p, b in zip(PROMPTS, BUDGETS)]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_slot_server_matches_jax_server_and_solo(gen_moe, served,
                                                 port_solo_served, engine):
    """The SlotServer on an MoE config, ring and paged, with and without a
    self-draft (spec_gamma 3): every request's greedy tokens equal the JAX
    SlotServer's and solo generate's (the port's and the JAX one's)."""
    _, cfg, _, params = gen_moe["target"]
    want_srv, want_solo = served
    kw = ENGINES[engine]
    if isinstance(kw, str):
        kw = dict(draft=params, draft_cfg=cfg, spec_gamma=3,
                  **(dict(paged=True, kv_block=4) if kw == "self_paged"
                     else {}))
    srv = S.SlotServer(params, cfg, device="cpu", **SRV, **kw)
    assert srv.cfg.capacity_factor == 2.0     # E/k: already drop-free
    reqs = [S.Request(prompt=p, max_new_tokens=b)
            for p, b in zip(PROMPTS, BUDGETS)]
    for r in reqs:
        srv.submit(r)
    done = srv.run_until_drained()
    got = [done[r.id].tokens for r in reqs]
    srv.shutdown()
    assert got == want_srv == want_solo
    assert got == port_solo_served
    if "draft" in engine:
        st = srv.stats()["speculative"]
        assert st["rounds"] > 0 and st["accepted_tokens"] > 0


def test_slot_server_applies_drop_free_capacity(gen_moe):
    """A server on the default capacity factor 1.25 routes drop-free
    (moe_dropfree: E/k = 2.0), so its tokens are solo generate's."""
    _, cfg, _, params = gen_moe["target"]
    cfg = dataclasses.replace(cfg, capacity_factor=1.25)
    srv = S.SlotServer(params, cfg, device="cpu", **SRV)
    assert srv.cfg.capacity_factor == 2.0
    r = S.Request(prompt=PROMPTS[0], max_new_tokens=6)
    srv.submit(r)
    got = srv.run_until_drained()[r.id].tokens
    srv.shutdown()
    assert got == G.generate(params, cfg, torch.from_numpy(
        PROMPTS[0]).long()[None], 6)[0].tolist()
