"""Port parity: w8a16 (``weight_dtype="int8"``: tony_tpu_torch.models.generate
``_quantize_weight``, ``_fuse_decode_weights``, ``_forward_with_cache``,
``prepare_decode``, ``generate``; ``SlotServer(weight_dtype="int8")`` on the
ring and the paged engine; lm_generate's and serve's ``--weight-dtype
int8``) against the JAX package on the CPU.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``
(float32); prompts from numpy. Both sides quantize in float32 by the same
rule, so the int8 matrices and their scales are equal, teacher-forced
logits agree within atol 1e-4 and greedy tokens are equal at the seeds
below (chosen away from near-ties: every step's top-2 logit gap above
1e-3, checked in ``test_int8_generate_matches_jax``). The slot pool is held
to the JAX package's int8 carve-out (its test_serving.py:102 and
test_serving_robustness.py:448): completions the same under either
admission policy and on both engines, and at least half equal to solo int8
decoding (serving chunk-prefills through the cast weights and the
quantized cache, where generate's prefill runs the int8 weights on raw
K/V)."""

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
from tony_tpu_torch.cli import serve
from tony_tpu_torch.examples import lm_generate
from tony_tpu_torch.models import generate as G
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params

jG = importlib.import_module("tony_tpu.models.generate")

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=jnp.float32)
SRV = dict(slots=2, max_len=64, block_size=4, prefill_chunk=8)
ENGINES = {"ring": {}, "paged": dict(paged=True, kv_block=8)}
LOGITS_ATOL = 1e-4
NEAR_TIE = 1e-3


@pytest.fixture(scope="module")
def model():
    jcfg = jT.TransformerConfig(**TINY)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


def _prompts(n, seed, lo=2, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], int(rng.integers(lo, hi)),
                         dtype=np.int32) for _ in range(n)]


def _solo(model, prompt, max_new, **kw):
    _, cfg, _, params = model
    out = G.generate(params, cfg, torch.from_numpy(prompt).long()[None],
                     max_new, **kw)
    return out[0].tolist()


def test_int8_weight_quantization_matches_dequant(model):
    """test_models.py:545's counterpart: the scale-folded product equals
    the product with the dequantized matrix, the round trip stays within
    the quantizer's resolution, and the port quantizes as the JAX package
    does; then int8 weights generate in-vocabulary tokens."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 16, 24), dtype=np.float32) * 2.0
    q, s = G._quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.shape == (3, 1, 24)
    deq = q.float().numpy() * s.numpy()
    amax = np.abs(w).max(axis=-2, keepdims=True)
    assert (np.abs(deq - w) <= amax / 254.0 + 1e-6).all()
    jq, js = jG._quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)

    x = rng.standard_normal((2, 16), dtype=np.float32)
    folded = (torch.from_numpy(x) @ q[0].float()) * s[0, 0]
    np.testing.assert_allclose(folded.numpy(), x @ deq[0], rtol=1e-5,
                               atol=1e-5)

    _, cfg, _, params = model
    prompt = torch.from_numpy(_prompts(1, 3, 8, 9)[0]).long()[None]
    out = G.generate(params, cfg, prompt.expand(2, -1), 6,
                     weight_dtype="int8")
    assert out.shape == (2, 6)
    assert ((out >= 0) & (out < cfg.vocab_size)).all()


def test_fused_int8_weights_equal_jax(model):
    jcfg, cfg, tree, params = model
    want = jG._fuse_decode_weights(tree, jcfg, "int8")
    got = G._fuse_decode_weights(params, cfg, "int8")
    assert sorted(got) == sorted(want) == sorted(
        ["wqkv", "wqkv_s", "wo", "wo_s", "unembed", "unembed_s", "w_gu",
         "w_gu_s", "w_down", "w_down_s"])
    for name, w in want.items():
        w = np.asarray(w)
        assert tuple(got[name].shape) == w.shape, name
        if name.endswith("_s"):
            assert got[name].dtype == cfg.dtype
            np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-7)
        else:
            assert got[name].dtype == torch.int8
            np.testing.assert_array_equal(got[name].numpy(), w)
    assert sorted(G._fuse_decode_weights(params, cfg)) == ["w_gu", "wqkv"]


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_int8_generate_matches_jax(model, kv_dtype):
    """Greedy tokens equal to the JAX generate(weight_dtype="int8"), and
    teacher-forced logits on those tokens within LOGITS_ATOL, every step's
    top-2 gap above NEAR_TIE (so the tokens hold at these seeds)."""
    jcfg, cfg, tree, params = model
    prompt = np.stack(_prompts(2, 11, 9, 10))
    want = np.array(jG.generate(tree, jcfg, jnp.asarray(prompt), 10,
                                  kv_dtype=kv_dtype, weight_dtype="int8"))
    got = G.generate(params, cfg, torch.from_numpy(prompt).long(), 10,
                     kv_dtype=kv_dtype, weight_dtype="int8")
    np.testing.assert_array_equal(got.numpy(), want)

    jw = jG.prepare_decode(tree, jcfg, weight_dtype="int8")
    pw = G.prepare_decode(params, cfg, weight_dtype="int8")
    jc = jG.init_cache(jcfg, 2, 24, kv_dtype)
    pc = G.init_cache(cfg, 2, 24, kv_dtype, device="cpu")
    steps = [prompt] + [want[:, i:i + 1] for i in range(9)]
    for i, toks in enumerate(steps):
        jl, jc = jG._forward_with_cache(jw.params, jcfg, jnp.asarray(toks),
                                        jc, jw.fused, prefill=i == 0)
        pl, pc = G._forward_with_cache(pw.params, cfg,
                                       torch.from_numpy(toks).long(), pc,
                                       pw.fused, prefill=i == 0)
        jl = np.asarray(jl)
        np.testing.assert_allclose(pl.numpy(), jl, atol=LOGITS_ATOL)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > NEAR_TIE).all(), i


def test_int8_prepare_decode_and_generate_checks(model):
    _, cfg, _, params = model
    p = torch.tensor([[1, 2, 3]])
    with pytest.raises(ValueError, match="weight_dtype"):
        G.prepare_decode(params, cfg, weight_dtype="int4")
    native = G.prepare_decode(params, cfg)
    with pytest.raises(ValueError, match="prepare_decode"):
        G.generate(native, cfg, p, 2, weight_dtype="int8")
    w8 = G.prepare_decode(params, cfg, weight_dtype="int8")
    assert w8.weight_dtype == "int8" and w8.fused["wqkv"].dtype == torch.int8
    # the cast params stay beside the int8 matrices (the serving prefill)
    assert w8.params["layers"]["wq"].dtype == cfg.dtype
    np.testing.assert_array_equal(
        G.generate(w8, cfg, p, 4).numpy(),
        G.generate(params, cfg, p, 4, weight_dtype="int8").numpy())


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_slot_server_int8_kv_and_weights(model, engine):
    """test_serving.py:102's counterpart on both engines: int8 KV and int8
    weights through the slot pool, the same completions under either
    admission policy, at least half equal to solo
    int8 decoding; the ring engine's equal the JAX SlotServer's."""
    jcfg, cfg, tree, params = model
    prompts = _prompts(4, seed=7)
    kw = dict(kv_dtype="int8", weight_dtype="int8", **SRV)
    outs = {}
    for batched in (True, False):
        srv = S.SlotServer(params, cfg, device="cpu", batched_admission=batched,
                           **kw, **ENGINES[engine])
        assert srv.weight_dtype == "int8"
        reqs = [S.Request(prompt=p, max_new_tokens=5) for p in prompts]
        for r in reqs:
            srv.submit(r)
        done = srv.run_until_drained()
        outs[batched] = [done[r.id].tokens for r in reqs]
    assert outs[True] == outs[False]
    for toks in outs[True]:
        assert len(toks) == 5
        assert all(0 <= t < cfg.vocab_size for t in toks)
    refs = [_solo(model, p, 5, kv_dtype="int8", weight_dtype="int8")
            for p in prompts]
    agree = sum(t == r for t, r in zip(outs[True], refs))
    assert agree * 2 >= len(refs), (outs[True], refs)
    jsrv = JSlotServer(tree, jcfg, **kw)
    jreqs = [JRequest(prompt=p, max_new_tokens=5) for p in prompts]
    for r in jreqs:
        jsrv.submit(r)
    jdone = jsrv.run_until_drained()
    assert outs[True] == [jdone[r.id].tokens for r in jreqs]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_replay_int8_tolerance(model, engine):
    """test_serving_robustness.py:448's counterpart on both engines: after
    reset() the journaled prefix is kept verbatim, and at least half the
    continuations equal an uninterrupted int8 run's."""
    _, cfg, _, params = model
    prompts = _prompts(4, seed=331)
    kw = dict(kv_dtype="int8", weight_dtype="int8", **SRV, **ENGINES[engine])

    def server():
        return S.SlotServer(params, cfg, device="cpu", **kw)

    ref_srv = server()
    ref_reqs = [S.Request(prompt=p, max_new_tokens=12) for p in prompts]
    for r in ref_reqs:
        ref_srv.submit(r)
    ref_done = ref_srv.run_until_drained()
    refs = [ref_done[r.id].tokens for r in ref_reqs]
    srv = server()
    reqs = [S.Request(prompt=p, max_new_tokens=12) for p in prompts]
    for r in reqs:
        srv.submit(r)
    for _ in range(2):
        srv.step()
    srv.drain_completed()
    prefixes = {r.id: list(e.emitted) for r in reqs
                if (e := srv._journal.get(r.id)) is not None}
    assert any(prefixes.values()), "setup: need partial prefixes"
    assert srv.reset() == []
    done = srv.run_until_drained()
    for r in reqs:
        pre = prefixes.get(r.id)
        if pre:
            assert done[r.id].tokens[:len(pre)] == pre
    got = [done[r.id].tokens for r in reqs]
    agree = sum(t == s for t, s in zip(got, refs))
    assert agree * 2 >= len(refs), (got, refs)
    assert srv.replays >= 1


DIMS = ["--device", "cpu", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "4", "--d-ff", "128", "--vocab", "256", "--dtype",
        "float32"]


def test_lm_generate_weight_dtype_int8(tmp_path):
    """lm_generate --weight-dtype int8 decodes on the int8 weights: its
    tokens are generate's with weight_dtype="int8" on the same random
    weights, and the JSON records the weight dtype."""
    out = tmp_path / "m.json"
    flags = DIMS + ["--prompt", "5 17 42 9", "--max-new", "8",
                    "--metrics-out", str(out)]
    assert lm_generate.main(flags + ["--weight-dtype", "int8"]) == 0
    m = json.loads(out.read_text())
    assert m["weight_dtype"] == "int8" and len(m["tokens"]) == 8
    args = serve.build_argparser().parse_args(DIMS)
    params, cfg = serve.load_model(args)
    want = G.generate(params, cfg, torch.tensor([[5, 17, 42, 9]]), 8,
                      weight_dtype="int8")
    assert m["tokens"] == want[0].tolist()


def test_serve_weight_dtype_int8_builds_int8_engine():
    """serve --weight-dtype int8 (ring and --paged-kv): the engine holds
    the int8 fused matrices and answers as a SlotServer built from the
    same weights with weight_dtype="int8"."""
    for extra in ([], ["--paged-kv", "--kv-block", "8"]):
        args = serve.build_argparser().parse_args(
            DIMS + ["--weight-dtype", "int8", "--slots", "2", "--max-len",
                    "64", "--block-size", "4", "--prefill-chunk", "8"]
            + extra)
        srv = serve.build_server(args)
        assert srv.weight_dtype == "int8"
        assert srv._fused["wqkv"].dtype == torch.int8
        r = S.Request(prompt=[5, 17, 42], max_new_tokens=6)
        srv.submit(r)
        got = srv.run_until_drained()[r.id].tokens
        params, cfg = serve.load_model(args)
        ref = S.SlotServer(params, cfg, device="cpu", weight_dtype="int8",
                           slots=2, max_len=64, block_size=4,
                           prefill_chunk=8, paged=bool(extra),
                           kv_block=8 if extra else 0)
        r2 = S.Request(prompt=[5, 17, 42], max_new_tokens=6)
        ref.submit(r2)
        assert got == ref.run_until_drained()[r2.id].tokens
