"""Port parity: speculative serving in the SlotServer and the model
registry (tony_tpu_torch.models.serving ``_spec_block``,
tony_tpu_torch.models.registry) against the JAX package on the CPU.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``
(TINY widths, as tests/test_spec_serving.py); prompts from numpy. Both
sides run in float32 through their einsum attention paths.

- A greedy request served with a draft is token-identical to the JAX
  spec server, to the port's spec-off server and to solo generate, for a
  random draft (acceptance near 0: the correction path) and a self-draft
  (acceptance 1: the bonus path), on the ring and on the paged engine,
  with and without the prefix cache.
- The event log survives speculation: a cancel mid-verify leaves a true
  prefix, a crash replays to the same tokens with only true prefixes in
  the journal, stop tokens and stop sequences cut where the plain path
  does.
- The acceptance EWMA steers gamma (up to the max for an agreeing draft,
  down to 1 for a random one); ``spec_gamma`` pins it.
- The rejections are the JAX package's, with its exception types."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu.models.registry import ModelRegistry as JModelRegistry
from tony_tpu.models.serving import Request as JRequest
from tony_tpu.models.serving import SlotServer as JSlotServer
from tony_tpu_torch.models import generate as G
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.models.registry import ModelRegistry

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=jnp.float32)
DRAFT = dict(vocab_size=256, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
             d_ff=64, max_seq_len=128, dtype=jnp.float32)
SRV = dict(slots=2, max_len=64, block_size=4, prefill_chunk=8)


def _model(fields, seed):
    jcfg = jT.TransformerConfig(**fields)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def target():
    return _model(TINY, 0)


@pytest.fixture(scope="module")
def draft():
    return _model(DRAFT, 1)


def _prompts(n, seed, lo=2, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], int(rng.integers(lo, hi)),
                         dtype=np.int32) for _ in range(n)]


def _solo(target, prompt, max_new, **kw):
    _, cfg, _, params = target
    out = G.generate(params, cfg, torch.from_numpy(prompt).long()[None],
                     max_new, **kw)
    return out[0].tolist()


def _srv(target, draft=None, **kw):
    _, cfg, _, params = target
    if draft is not None:
        kw.update(draft=draft[3], draft_cfg=draft[1])
    return S.SlotServer(params, cfg, device="cpu", **{**SRV, **kw})


def _burst(srv, prompts, budgets, request=S.Request):
    reqs = [request(prompt=p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    for r in reqs:
        srv.submit(r)
    done = srv.run_until_drained()
    return reqs, [done[r.id] for r in reqs]


def _jax_spec(target, draft, prompts, budgets, **kw):
    jcfg, _, tree, _ = target
    jd, _, dtree, _ = draft
    jsrv = JSlotServer(tree, jcfg, draft=dtree, draft_cfg=jd,
                       **{**SRV, **kw})
    _, done = _burst(jsrv, prompts, budgets, JRequest)
    st = jsrv.stats()["speculative"]
    jsrv.shutdown()
    return [c.tokens for c in done], st


# ------------------------------------------------------------------ registry

def _registry_ops(reg, cfg, dcfg):
    """The JAX package's registry unit test, as a record of what each
    operation gave."""
    out = []
    with pytest.raises(KeyError):
        reg.default
    e1 = reg.register("target", {"w": 1}, cfg, source="random:0")
    out += [e1.generation, reg.default is e1, "target" in reg, len(reg)]
    e2 = reg.register("target", {"w": 2}, cfg, source="random:9")
    out += [e2.generation, reg.get("target").weights]
    reg.register("mini", {"w": 3}, dcfg)
    reg.get("target").draft = "mini"
    out += [reg.resolve_draft("target").name, reg.resolve_draft("mini")]
    reg.get("target").draft = "ghost"
    with pytest.raises(KeyError, match="ghost"):
        reg.resolve_draft("target")
    with pytest.raises(KeyError, match="unknown model"):
        reg.get("nope")
    with pytest.raises(ValueError, match="its own draft"):
        reg.register("self", {"w": 4}, cfg, draft="self")
    with pytest.raises(ValueError, match="non-empty"):
        reg.register("", {"w": 5}, cfg)
    out += [reg.names(), [e.name for e in reg], reg.get("mini").source,
            reg.get("target").source]
    return out


def test_registry_matches_jax(target, draft):
    """The port's registry and the JAX package's through the same
    operations give the same answers and raise the same types."""
    got = _registry_ops(ModelRegistry(), target[1], draft[1])
    want = _registry_ops(JModelRegistry(), target[0], draft[0])
    assert got == want
    assert got[-4] == ["target", "mini"]


def test_server_builds_its_registry(target, draft):
    """(params, cfg) registers under ``model``; an inline draft registers
    as "draft" and pairs with it; registry= serves an entry and resolves
    its draft; an unknown name raises with the names."""
    srv = _srv(target, draft, spec_gamma=2)
    assert srv.model == "default"
    assert srv.registry.names() == ["default", "draft"]
    assert srv.registry.resolve_draft("default").cfg is draft[1]
    assert srv.stats()["registry"] == ["default", "draft"]
    srv2 = S.SlotServer(registry=srv.registry, device="cpu", **SRV)
    assert srv2._spec and srv2.draft_model == "draft"
    assert srv2.model == "default"
    with pytest.raises(KeyError, match="unknown model"):
        S.SlotServer(registry=srv.registry, model="ghost", device="cpu",
                     **SRV)
    with pytest.raises(ValueError, match="registry="):
        S.SlotServer(device="cpu")
    reg = ModelRegistry()
    reg.register("a", target[3], target[1])
    reg.register("b", target[3], target[1], draft="a")
    srv3 = S.SlotServer(registry=reg, model="b", device="cpu", **SRV)
    assert srv3.model == "b" and srv3.draft_model == "a"
    assert "speculative" in srv3.stats() and "speculative" not in \
        S.SlotServer(registry=reg, device="cpu", **SRV).stats()
    for s in (srv, srv2, srv3):
        s.shutdown()


# ---------------------------------------------------- parity: both regimes

PARITY_PROMPTS = _prompts(8, 3)
PARITY_BUDGETS = [6 + (i % 5) for i in range(8)]


@pytest.fixture(scope="module")
def jax_spec_parity(target, draft):
    """The JAX spec server's tokens and stats for both regimes, once."""
    return {regime: _jax_spec(target, d, PARITY_PROMPTS, PARITY_BUDGETS,
                              spec_gamma=2)
            for regime, d in (("random_draft", draft), ("self_draft", target))}


@pytest.mark.parametrize("regime", ["random_draft", "self_draft"])
def test_spec_parity_with_jax_spec_off_and_solo(target, draft,
                                                jax_spec_parity, regime):
    prompts, budgets = PARITY_PROMPTS, PARITY_BUDGETS
    d = draft if regime == "random_draft" else target
    spec = _srv(target, d, spec_gamma=2)
    reqs, got = _burst(spec, prompts, budgets)
    _, plain = _burst(_srv(target), prompts, budgets)
    jtoks, jst = jax_spec_parity[regime]
    for i, c in enumerate(got):
        want = _solo(target, prompts[i], budgets[i])
        assert c.tokens == want == plain[i].tokens == jtoks[i], i
        assert c.finish_reason == "length"
    st = spec.stats()["speculative"]
    for k in ("rounds", "proposed_tokens", "accepted_tokens",
              "acceptance_ewma", "gamma", "gamma_pinned"):
        assert st[k] == jst[k], k
    assert st["rounds"] > 0 and st["acceptance"]["count"] > 0
    if regime == "random_draft":
        assert st["acceptance_ewma"] < 0.3
    else:
        assert st["acceptance_ewma"] > 0.8
        assert st["verify_rounds_per_request"]["count"] == len(reqs)
    tr = got[0].trace
    assert tr["attrs"]["spec_rounds"] >= 1
    assert "spec_accepted_tokens" in tr["attrs"]
    spec.shutdown()


def test_spec_eos_matches_generate(target, draft):
    prompts = _prompts(6, 11)
    solo = [_solo(target, p, 10) for p in prompts]
    stop = solo[0][4]
    spec = _srv(target, draft, spec_gamma=2, stop_tokens=(stop,))
    _, got = _burst(spec, prompts, [10] * 6)
    stopped = 0
    for i, c in enumerate(got):
        want = _solo(target, prompts[i], 10, stop_tokens=(stop,))
        if stop in want:                # generate pads past the stop
            want = want[:want.index(stop) + 1]
            stopped += 1
        assert c.tokens == want, i
        assert c.finish_reason == ("stop" if want[-1] == stop else "length")
    assert stopped >= 1
    spec.shutdown()


def test_spec_per_request_stop_sequences(target, draft):
    prompts = _prompts(4, 19)
    spec = _srv(target, draft, spec_gamma=2)
    reqs = []
    for p in prompts:
        full = _solo(target, p, 12)
        reqs.append((S.Request(prompt=p, max_new_tokens=12,
                               stop=[full[3:5]]), full))
        spec.submit(reqs[-1][0])
    done = spec.run_until_drained()
    for r, full in reqs:
        seq = full[3:5]
        end = next(e for e in range(2, 6) if full[e - 2:e] == seq)
        assert done[r.id].tokens == full[:end]
        assert done[r.id].finish_reason == "stop"
    spec.shutdown()


def test_spec_cancel_mid_verify(target, draft):
    """A cancel between rounds leaves a true prefix of the solo stream, and
    the freed slot's next occupant is token-identical."""
    prompts = _prompts(2, 7, lo=4, hi=10)
    srv = _srv(target, draft, slots=1, spec_gamma=2)
    a = S.Request(prompt=prompts[0], max_new_tokens=12)
    b = S.Request(prompt=prompts[1], max_new_tokens=6)
    srv.submit(a)
    srv.submit(b)
    for _ in range(3):
        srv.step()
    assert srv.cancel(a.id)
    done = srv.run_until_drained()
    assert done[a.id].finish_reason == "cancelled"
    full = _solo(target, prompts[0], 12)
    assert done[a.id].tokens == full[:len(done[a.id].tokens)]
    assert done[b.id].tokens == _solo(target, prompts[1], 6)
    srv.shutdown()


def test_spec_crash_replay(target, draft, monkeypatch):
    monkeypatch.setenv("TONY_TEST_SERVING_CRASH_AT_BLOCKS", "3")
    prompts = _prompts(6, 13)
    srv = _srv(target, draft, spec_gamma=2)
    reqs = [S.Request(prompt=p, max_new_tokens=8) for p in prompts]
    for r in reqs:
        srv.submit(r)
    crashed, out, prefixes = False, {}, {}
    while not srv.idle:
        try:
            srv.step()
        except RuntimeError:
            crashed = True
            for r in reqs:
                entry = srv._journal.get(r.id)
                if entry is not None and entry.emitted:
                    prefixes[r.id] = list(entry.emitted)
            assert srv.reset() == []
        out.update(srv.drain_completed())
    out.update(srv.drain_completed())
    assert crashed and srv.replays >= 1
    for i, r in enumerate(reqs):
        want = _solo(target, prompts[i], 8)
        assert out[r.id].tokens == want, i
        pre = prefixes.get(r.id)
        if pre:
            assert want[:len(pre)] == pre
    srv.shutdown()


def test_spec_gamma_autotune_and_pin(target, draft):
    prompts = _prompts(4, 17)
    up = _srv(target, target, spec_gamma_max=4)
    _burst(up, prompts, [10] * 4)
    assert up._current_gamma() == 4
    down = _srv(target, draft, spec_gamma_max=4)
    _burst(down, prompts, [10] * 4)
    assert down._current_gamma() == 1
    pinned = _srv(target, target, spec_gamma=2)
    _burst(pinned, prompts, [6] * 4)
    assert pinned._current_gamma() == 2
    st = pinned.stats()["speculative"]
    assert st["gamma_pinned"] is True and st["gamma"] == 2
    # a ceiling off the power-of-two ladder: the largest power below it
    odd = _srv(target, target, spec_gamma_max=3)
    odd._accept_ewma[:] = 0.99
    assert odd._current_gamma() == 2
    for s in (up, down, pinned, odd):
        s.shutdown()


def _rejections(pkg, target, draft):
    """(name, constructor or submit thunk) for every rejection the JAX
    package makes, built over ``pkg`` ("port" or "jax")."""
    jcfg, cfg, tree, params = target
    jd, d, dtree, dparams = draft
    if pkg == "port":
        P, Dp, C, Dc = params, dparams, cfg, d
        Srv = lambda *a, **k: S.SlotServer(*a, device="cpu", **k)  # noqa
        Req = S.Request
        bad_vocab = dataclasses.replace(d, vocab_size=128)
        non_causal = dataclasses.replace(d, causal=False)
    else:
        P, Dp, C, Dc = tree, dtree, jcfg, jd
        Srv, Req = JSlotServer, JRequest
        bad_vocab = dataclasses.replace(jd, vocab_size=128)
        non_causal = dataclasses.replace(jd, causal=False)
    ok = lambda: Srv(P, C, draft=Dp, draft_cfg=Dc, **SRV)  # noqa: E731
    return {
        "temperature": lambda: Srv(P, C, draft=Dp, draft_cfg=Dc,
                                   temperature=0.7),
        "no_draft_cfg": lambda: Srv(P, C, draft=Dp),
        "vocab": lambda: Srv(P, C, draft=Dp, draft_cfg=bad_vocab),
        "non_causal": lambda: Srv(P, C, draft=Dp, draft_cfg=non_causal),
        "int8_weights": lambda: Srv(P, C, draft=Dp, draft_cfg=Dc,
                                    weight_dtype="int8"),
        "prefill_role": lambda: Srv(P, C, draft=Dp, draft_cfg=Dc,
                                    paged=True, role="prefill", **SRV),
        "unknown_draft": lambda: Srv(P, C, draft="ghost"),
        "request_temperature": lambda: ok().submit(
            Req(prompt=[1, 2, 3], max_new_tokens=4, temperature=0.5)),
        "request_logprobs": lambda: ok().submit(
            Req(prompt=[1, 2, 3], max_new_tokens=4, logprobs=2)),
        "import": lambda: Srv(P, C, draft=Dp, draft_cfg=Dc, paged=True,
                              **SRV).import_blocks({"model": "default"}),
    }


@pytest.mark.parametrize("case", [
    "temperature", "no_draft_cfg", "vocab", "non_causal", "int8_weights",
    "prefill_role", "unknown_draft", "request_temperature",
    "request_logprobs", "import"])
def test_spec_rejections_match_jax(target, draft, case):
    errors = []
    for pkg in ("port", "jax"):
        with pytest.raises(Exception) as info:
            _rejections(pkg, target, draft)[case]()
        errors.append(type(info.value))
    assert errors[0] is errors[1], errors
    assert errors[0] in (ValueError, KeyError)


def test_spec_greedy_request_with_zero_temperature(target, draft):
    srv = _srv(target, draft, spec_gamma=2)
    srv.submit(S.Request(prompt=[1, 2, 3], max_new_tokens=2,
                         temperature=0.0))
    assert len(srv.run_until_drained()) == 1
    srv.shutdown()


# ------------------------------------------- paged, prefix cache, int8 KV

@pytest.mark.parametrize("mode", [
    "paged", "paged_prefix", "ring_prefix", "paged_int8"])
def test_spec_engines_identical(target, draft, mode):
    """The paged engine (its draft in a mirror pool), the prefix cache
    (its draft pool riding the trie) and int8 KV under speculation give
    the spec-off ring engine's tokens; a second pass over shared prefixes
    reuses the draft's prefill too."""
    rng = np.random.default_rng(23)
    shared = rng.integers(0, 256, 16, dtype=np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, 256, int(rng.integers(1, 6)), dtype=np.int32)]) for _ in range(4)]
    prompts += _prompts(3, 29)
    budgets = [5 + (i % 4) for i in range(len(prompts))]
    kw = dict(slots=3, max_len=64)
    if mode.startswith("paged"):
        kw.update(paged=True, kv_block=4)
    if mode.endswith("prefix"):
        kw.update(prefix_cache_blocks=16)
    if mode.endswith("int8"):
        kw.update(kv_dtype="int8")
    base = dict(kv_dtype=kw.get("kv_dtype", "native"), slots=3, max_len=64)
    _, want = _burst(_srv(target, **base), prompts, budgets)
    spec = _srv(target, draft, spec_gamma=2, **kw)
    for _ in range(2):
        _, got = _burst(spec, prompts, budgets)
        assert [c.tokens for c in got] == [c.tokens for c in want]
    st = spec.stats()
    if mode.endswith("prefix"):
        assert st["speculative"]["draft_prefill_tokens_reused"] > 0
        assert st["speculative"]["draft_prefill_tokens_reused"] == \
            st["prefill_tokens_reused"]
    if mode.startswith("paged"):
        spec._allocator.check()
    spec.shutdown()
