"""Port parity: tony_tpu_torch.models.serving (the SlotServer ring engine)
and the per-row decode it runs on, against the JAX package on the CPU.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``
(TINY widths, as tests/test_serving.py); prompts come from numpy. Both
sides run in float32 through their einsum attention paths (the serving
path launches no kernel on either side).

- Per-row cached attention, one ring decode step and ``_prefill_batch``:
  within atol 2e-5 (ROADMAP.md's parity contract).
- Completions: greedy tokens identical to the JAX SlotServer and to JAX
  solo generate. Seed 0 (params) and the numpy prompt seeds below were
  chosen to give identical tokens; another seed can meet a near-tie among
  the greedy logits, where float32 summation order (which differs
  between the frameworks) may pick the other token.
- Logprobs: within 1e-4 of the JAX SlotServer's.
- Sampling draws from a torch.Generator, whose numbers differ from JAX's,
  so sampled requests are checked within the port only."""

import dataclasses
import importlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu.models.serving import Request as JRequest
from tony_tpu.models.serving import SlotServer as JSlotServer
from tony_tpu.models.serving import _prefill_batch as j_prefill_batch
from tony_tpu_torch.models import generate as G
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params

# the JAX package's models/__init__ re-exports the function under the
# module's name
jG = importlib.import_module("tony_tpu.models.generate")

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=jnp.float32)
ATOL = 2e-5
LOGPROB_ATOL = 1e-4


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


def _jax_solo(model, prompt, max_new, **kw):
    jcfg, _, tree, _ = model
    out = jG.generate(tree, jcfg, jnp.asarray(prompt)[None], max_new, **kw)
    return [int(t) for t in np.asarray(out)[0]]


def _port_solo(model, prompt, max_new, **kw):
    _, cfg, _, params = model
    out = G.generate(params, cfg, torch.from_numpy(prompt).long()[None],
                     max_new, **kw)
    return out[0].tolist()


def _serve(model, prompts, max_news, *, jax_too=True, **kw):
    """The same requests through the port's and (optionally) the JAX
    package's SlotServer -> (port completions, JAX completions, port
    server), each completion list in request order."""
    jcfg, cfg, tree, params = model
    srv = S.SlotServer(params, cfg, device="cpu", **kw)
    reqs = [S.Request(prompt=p, max_new_tokens=m)
            for p, m in zip(prompts, max_news)]
    for r in reqs:
        srv.submit(r)
    done = srv.run_until_drained()
    got = [done[r.id] for r in reqs]
    if not jax_too:
        return got, None, srv
    jsrv = JSlotServer(tree, jcfg, **kw)
    jreqs = [JRequest(prompt=p, max_new_tokens=m)
             for p, m in zip(prompts, max_news)]
    for r in jreqs:
        jsrv.submit(r)
    jdone = jsrv.run_until_drained()
    return got, [jdone[r.id] for r in jreqs], srv


# ------------------------------------------------------------- per-row decode

def _bf16_exact(x):
    """float32 values that bf16 represents exactly (the int8 scales)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("mode", ["vector_ring", "scalar_ring", "vector"])
def test_cached_attention_per_row_matches_jax(model, kv, window, mode):
    jcfg, cfg, _, _ = model
    jcfg = dataclasses.replace(jcfg, attn_window=window)
    cfg = dataclasses.replace(cfg, attn_window=window)
    rng = np.random.default_rng(7)
    b, l, h, kvh, m, d = 3, 2 if mode == "scalar_ring" else 1, 4, 2, 16, 16
    q = rng.standard_normal((b, l, h, d), dtype=np.float32)
    if kv == "int8":
        ck = rng.integers(-127, 128, (b, kvh, m, d), dtype=np.int8)
        cv = rng.integers(-127, 128, (b, kvh, m, d), dtype=np.int8)
        ks = _bf16_exact(rng.uniform(0.001, 0.02, (b, kvh, m))
                         .astype(np.float32))
        vs = _bf16_exact(rng.uniform(0.001, 0.02, (b, kvh, m))
                         .astype(np.float32))
    else:
        ck = rng.standard_normal((b, kvh, m, d), dtype=np.float32)
        cv = rng.standard_normal((b, kvh, m, d), dtype=np.float32)
        ks = vs = None
    lens = np.array([3, 15, 9], np.int32)
    offsets = np.array([5, 0, 13], np.int32)
    cache_len = 6 if mode == "scalar_ring" else lens
    ring = offsets if mode != "vector" else None

    def j_scale(x):
        return None if x is None else jnp.asarray(x, jnp.bfloat16)

    def t_scale(x):
        return None if x is None else torch.from_numpy(x).to(torch.bfloat16)

    want = jG._cached_attention(
        jcfg, jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(cache_len) if mode != "scalar_ring" else cache_len, l,
        j_scale(ks), j_scale(vs),
        ring_offsets=None if ring is None else jnp.asarray(ring))
    got = G._cached_attention(
        cfg, torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(lens) if mode != "scalar_ring" else cache_len, l,
        t_scale(ks), t_scale(vs),
        ring_offsets=None if ring is None else torch.from_numpy(ring))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_decode_kernel_gate_excludes_per_row_lengths_and_rings(model):
    """Only a lockstep single-token step (one int length, no ring) may go
    to the flash-decode kernel on the card: the kernel takes one scalar
    length and absolute positions."""
    _, cfg, _, _ = model
    lens = torch.tensor([3, 5], dtype=torch.int32)
    offs = torch.tensor([1, 2], dtype=torch.int32)
    gate = G._takes_decode_kernel
    assert gate(cfg, 1, True, 7, None)
    assert not gate(cfg, 1, True, lens, offs)
    assert not gate(cfg, 1, True, lens, None)
    assert not gate(cfg, 1, True, 7, offs)
    assert not gate(cfg, 1, False, 7, None)         # the CPU
    assert not gate(cfg, 2, True, 7, None)          # a chunk
    assert not gate(cfg, 1, True, 7, None, allow_kernel=False)
    assert not gate(dataclasses.replace(cfg, attn_impl="ref"), 1, True, 7,
                    None)


def _random_cache(model, s, m, seed):
    """Identical random caches (per-row lengths) for both frameworks."""
    jcfg, cfg, _, _ = model
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, s, cfg.n_kv_heads, m, cfg.head_dim)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    return k, v


def test_forward_with_cache_ring_step_matches_jax(model):
    """One per-row decode step: every row at its own logical length, every
    row's K/V written at the shared cursor; logits and the written column
    against the JAX package."""
    jcfg, cfg, tree, params = model
    s, m, cursor = 3, 16, 11
    k, v = _random_cache(model, s, m, 3)
    lens = np.array([4, 10, 0], np.int32)
    offsets = ((cursor - lens) % m).astype(np.int32)
    tokens = np.array([[5], [77], [200]], np.int32)
    jw = jG.prepare_decode(tree, jcfg)
    w = G.prepare_decode(params, cfg)
    jcache = jG.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                        length=jnp.asarray(lens))
    want, jnew = jG._forward_with_cache(
        jw.params, jcfg, jnp.asarray(tokens), jcache, jw.fused,
        ring=(jnp.int32(cursor), jnp.asarray(offsets)))
    cache = G.KVCache(k=torch.from_numpy(k.copy()),
                      v=torch.from_numpy(v.copy()),
                      length=torch.from_numpy(lens.copy()))
    got, new = G._forward_with_cache(
        w.params, cfg, torch.from_numpy(tokens), cache, w.fused,
        ring=(cursor, torch.from_numpy(offsets)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            getattr(new, name)[:, :, :, cursor].numpy(),
            np.asarray(getattr(jnew, name))[:, :, :, cursor], atol=ATOL,
            rtol=0)
        # nothing else of the ring was touched
        rest = np.delete(getattr(new, name).numpy(), cursor, axis=3)
        np.testing.assert_array_equal(rest, np.delete(
            k if name == "k" else v, cursor, axis=3))
    np.testing.assert_array_equal(new.length.numpy(), lens + 1)
    with pytest.raises(ValueError, match="ring"):
        G._forward_with_cache(w.params, cfg, torch.from_numpy(tokens), cache,
                              w.fused)


def test_prefill_batch_matches_jax(model):
    """Three chunk rounds of a burst into the same random cache on both
    sides: a multi-chunk prompt, a 1-token prompt (a zero-valid final
    chunk), and a prompt whose last chunk's pad tail runs past the ring's
    capacity (M=40, chunk 16, 35 body tokens). The JAX side also gets
    padding rows with out-of-bounds slots, which must write nowhere; the
    port is given only the real rows."""
    jcfg, cfg, tree, params = model
    s, m, C = 3, 40, 16
    k, v = _random_cache(model, s, m, 11)
    rng = np.random.default_rng(12)
    bodies = {0: rng.integers(0, 256, 20, dtype=np.int32),
              2: np.zeros(0, np.int32),
              1: rng.integers(0, 256, 35, dtype=np.int32)}
    offsets = {0: 5, 2: 9, 1: 7}
    lasts = {0: 3, 2: 250, 1: 99}
    jstate = [jnp.zeros(s, jnp.int32), jnp.zeros(s, bool),
              jnp.zeros(s, jnp.int32), jnp.zeros(s, jnp.int32),
              jnp.zeros(s, jnp.float32), jnp.zeros(s, jnp.int32)]
    jcache = jG.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                        length=jnp.zeros(s, jnp.int32))
    cache = G.KVCache(k=torch.from_numpy(k.copy()),
                      v=torch.from_numpy(v.copy()),
                      length=torch.zeros(s, dtype=torch.int32))
    state = S._SlotState(
        tokens=torch.zeros(s, dtype=torch.int32),
        active=torch.zeros(s, dtype=torch.bool),
        target=torch.zeros(s, dtype=torch.int32),
        offsets=torch.zeros(s, dtype=torch.int32),
        temps=torch.zeros(s, dtype=torch.float32),
        topks=torch.zeros(s, dtype=torch.int32))
    for r in range(3):
        rows = []
        for slot, body in bodies.items():
            starts = list(range(0, body.size, C)) or [0]
            if r < len(starts):
                c0 = starts[r]
                nv = max(0, min(C, body.size - c0))
                chunk = np.zeros(C, np.int32)
                chunk[:nv] = body[c0:c0 + nv]
                rows.append((chunk, slot, c0, offsets[slot], nv, lasts[slot],
                             body.size + 6, 0.5 * slot, slot + 1,
                             r == len(starts) - 1))
        cols = [np.array(c) for c in zip(*rows)]
        S._prefill_batch(params, cfg, cache, state, *cols)
        k_rows = 4      # the JAX caller pads to a power of two
        pad = k_rows - len(rows)
        jcols = [np.concatenate([c, np.zeros((pad,) + c.shape[1:], c.dtype)])
                 for c in cols]
        jcols[1][len(rows):] = s + np.arange(pad)   # out-of-bounds slots
        jcache, *jstate, _ = j_prefill_batch(
            tree, jcache, *jstate, *(jnp.asarray(c) for c in jcols),
            cfg=jcfg, chunk=C, kv_dtype="native")
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(cache, name).numpy(),
                                   np.asarray(getattr(jcache, name)),
                                   atol=ATOL, rtol=0)
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jcache.length))
    np.testing.assert_array_equal(cache.length.numpy(), [20, 35, 0])
    for got, want in zip(dataclasses.astuple(state), jstate):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # slot 1's last chunk (start 32, 3 valid) writes ring indices
    # (7 + 32 + j) % 40 = 39, 0, 1; its pad tail would wrap onto 2..14,
    # of which 7..14 hold its positions 0..7 and 2..6 were never written
    np.testing.assert_array_equal(cache.k[:, 1, :, 2:7].numpy(),
                                  k[:, 1, :, 2:7])


def test_sample_token_per_row():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 50, generator=gen)
    greedy = logits.argmax(-1).to(torch.int32)
    temps = torch.tensor([0.0, 1.0, 0.0, 2.0])
    got = G.sample_token(logits, gen, temps, 0)
    assert got[0] == greedy[0] and got[2] == greedy[2]
    topk = torch.tensor([1, 3, 0, 100], dtype=torch.int32)
    hot = torch.full((4,), 5.0)
    allowed = [set(torch.topk(logits[r], k).indices.tolist()) if 0 < k < 50
               else set(range(50)) for r, k in enumerate(topk.tolist())]
    seen = [set() for _ in range(4)]
    for _ in range(200):
        tok = G.sample_token(logits, gen, hot, topk)
        assert tok.dtype == torch.int32
        for r in range(4):
            assert int(tok[r]) in allowed[r]
            seen[r].add(int(tok[r]))
    assert seen[0] == {int(greedy[0])}          # top_k=1 is the argmax
    assert seen[1] == allowed[1]                # all three drawn
    assert len(seen[2]) > 10 and len(seen[3]) > 10   # k <= 0 or >= V: all
    # seeded: the same generator state draws the same tokens
    a = G.sample_token(logits, torch.Generator().manual_seed(5), hot, topk)
    b = G.sample_token(logits, torch.Generator().manual_seed(5), hot, topk)
    assert torch.equal(a, b)


# ------------------------------------------------------------- the SlotServer

def _mixed_requests():
    """12 mixed-length prompts, a 1-token one among them, and their
    budgets."""
    prompts = _prompts(12, seed=3, lo=2, hi=22)
    prompts[4] = prompts[4][:1]
    return prompts, [6 + i % 5 for i in range(12)]


@pytest.fixture(scope="module")
def mixed_reference(model):
    """The JAX side of test_slot_server_matches_jax_server_and_solo,
    computed once for both cases (its first compiles dominate): the JAX
    SlotServer's completions for each admission mode, and JAX solo
    generate's tokens for each prompt."""
    jcfg, _, tree, _ = model
    prompts, max_news = _mixed_requests()
    servers = {}
    for batched in (True, False):
        jsrv = JSlotServer(tree, jcfg, slots=3, max_len=64, block_size=4,
                           prefill_chunk=8, batched_admission=batched)
        jreqs = [JRequest(prompt=p, max_new_tokens=m)
                 for p, m in zip(prompts, max_news)]
        for r in jreqs:
            jsrv.submit(r)
        jdone = jsrv.run_until_drained()
        servers[batched] = [jdone[r.id] for r in jreqs]
    solo = [_jax_solo(model, p, n) for p, n in zip(prompts, max_news)]
    return servers, solo


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "per_slot"])
def test_slot_server_matches_jax_server_and_solo(model, mixed_reference,
                                                 batched):
    """12 mixed-length requests through 3 slots (re-admission into freed
    slots mid-flight), with a 1-token prompt among them: token-identical
    to the JAX SlotServer and to JAX solo generate."""
    prompts, max_news = _mixed_requests()
    got, _, srv = _serve(model, prompts, max_news, jax_too=False, slots=3,
                         max_len=64, block_size=4, prefill_chunk=8,
                         batched_admission=batched)
    servers, solo = mixed_reference
    for g, w, p, ref in zip(got, servers[batched], prompts, solo):
        assert g.finish_reason == w.finish_reason == "length"
        assert g.tokens == w.tokens == ref, (
            f"prompt of {p.size} tokens diverged")
    if not batched:         # one prefill call per chunk of each body
        assert srv.admission_dispatches == sum(
            max(1, -(-(p.size - 1) // 8)) for p in prompts)
    assert srv.blocks_dispatched > 0 and srv.idle


def test_batched_admission_makes_fewer_calls(model):
    prompts = _prompts(9, seed=61, lo=2, hi=22)
    counts, outs = {}, {}
    for batched in (True, False):
        got, _, srv = _serve(model, prompts, [5] * 9, jax_too=False,
                             slots=3, max_len=64, block_size=4,
                             prefill_chunk=8, batched_admission=batched)
        counts[batched] = srv.admission_dispatches
        outs[batched] = [c.tokens for c in got]
    assert outs[True] == outs[False]
    assert counts[True] < counts[False], counts


def test_slot_server_eos_matches_jax(model):
    """Stop tokens end requests mid-block (EOS mode: blocks read behind
    the pipeline lag); streams end with the stop token, as the JAX
    SlotServer's and JAX generate(stop_tokens=..., pad_id=...)'s do."""
    prompts = _prompts(6, seed=11)
    stop = _port_solo(model, prompts[0], 10)[3]
    got, want, _ = _serve(model, prompts, [10] * 6, slots=2, max_len=64,
                          block_size=4, prefill_chunk=8, stop_tokens=(stop,),
                          pad_id=255)
    saw_stop = False
    for g, w, p in zip(got, want, prompts):
        ref = _jax_solo(model, p, 10, stop_tokens=(stop,), pad_id=255)
        if stop in ref:
            ref = ref[:ref.index(stop) + 1]
            saw_stop = True
            assert g.finish_reason == "stop"
        else:
            assert g.finish_reason == "length"
        assert g.tokens == w.tokens == ref
        assert g.finish_reason == w.finish_reason
    assert saw_stop


def test_int8_kv_server_matches_jax_server(model):
    """kv_dtype="int8" through the slot pool: both sides quantize in
    float32 by the same rule, so at these seeds the port's completions
    equal the JAX SlotServer's, under either admission policy (against
    solo generate int8 agrees only within quantization tolerance, as the
    JAX package's own test says: generate's prefill attends raw K/V)."""
    prompts = _prompts(6, seed=7, lo=2, hi=22)
    got, want, _ = _serve(model, prompts, [8] * 6, slots=2, max_len=64,
                          block_size=4, prefill_chunk=8, kv_dtype="int8")
    per_slot, _, _ = _serve(model, prompts, [8] * 6, jax_too=False, slots=2,
                            max_len=64, block_size=4, prefill_chunk=8,
                            kv_dtype="int8", batched_admission=False)
    for g, w, p in zip(got, want, per_slot):
        assert g.tokens == w.tokens == p.tokens


def test_single_token_prompt_and_tail_past_ring_capacity(model):
    """A 1-token prompt has no prefill body; a 36-token prompt at max_len
    40 and chunk 16 has a final chunk whose pad tail runs past the ring's
    capacity, which must be written nowhere."""
    prompt = np.random.default_rng(41).integers(0, 256, 36, dtype=np.int32)
    for p, n, kw in ((np.array([7], np.int32), 6, dict(max_len=32)),
                     (prompt, 4, dict(max_len=40, prefill_chunk=16))):
        got, want, _ = _serve(model, [p], [n], slots=2, block_size=4, **kw)
        assert got[0].tokens == want[0].tokens == _jax_solo(model, p, n)


def test_logprobs_match_jax(model):
    _, _, tree, _ = model
    prompts = _prompts(3, seed=5)
    jcfg, cfg, tree, params = model
    srv = S.SlotServer(params, cfg, device="cpu", slots=2, max_len=64,
                       block_size=4, prefill_chunk=8)
    jsrv = JSlotServer(tree, jcfg, slots=2, max_len=64, block_size=4,
                       prefill_chunk=8)
    reqs = [S.Request(prompt=p, max_new_tokens=5, logprobs=3)
            for p in prompts]
    jreqs = [JRequest(prompt=p, max_new_tokens=5, logprobs=3)
             for p in prompts]
    for r, jr in zip(reqs, jreqs):
        srv.submit(r)
        jsrv.submit(jr)
    done, jdone = srv.run_until_drained(), jsrv.run_until_drained()
    for r, jr in zip(reqs, jreqs):
        got, want = done[r.id].logprobs, jdone[jr.id].logprobs
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g["token"] == w["token"] and g["top"][0] == w["top"][0]
            assert abs(g["logprob"] - w["logprob"]) <= LOGPROB_ATOL
            np.testing.assert_allclose(g["top"][1], w["top"][1],
                                       atol=LOGPROB_ATOL, rtol=0)


# ------------------------------------------------------- within the port

def _port_server(model, **kw):
    _, cfg, _, params = model
    kw = {"slots": 2, "max_len": 64, "block_size": 4, "prefill_chunk": 8,
          **kw}
    return S.SlotServer(params, cfg, device="cpu", **kw)


def test_cancel_mid_decode_then_readmission_is_fresh(model):
    """A cancelled request's partial tokens are a prefix of its solo
    stream; the request admitted into its freed slot is token-identical
    to a fresh server's; the other slot is undisturbed."""
    pa, pc, pb = _prompts(3, seed=223)
    srv = _port_server(model)
    a = S.Request(prompt=pa, max_new_tokens=30)
    c = S.Request(prompt=pc, max_new_tokens=30)
    srv.submit(a)
    srv.submit(c)
    for _ in range(3):
        srv.step()
    assert srv.n_active == 2 and srv.cancel(a.id)
    b = S.Request(prompt=pb, max_new_tokens=6)
    srv.submit(b)
    done = srv.run_until_drained()
    assert done[a.id].finish_reason == "cancelled"
    got = done[a.id].tokens
    assert 0 < len(got) < 30
    assert got == _port_solo(model, pa, 30)[:len(got)]
    fresh = _port_server(model)
    fb = S.Request(prompt=pb, max_new_tokens=6)
    fresh.submit(fb)
    assert done[b.id].tokens == fresh.run_until_drained()[fb.id].tokens
    assert done[c.id].tokens == _port_solo(model, pc, 30)
    assert srv.cancel(a.id) is False and srv.cancel(10 ** 9) is False
    assert srv.stats()["cancelled"] == 1


def test_queue_bound_deadline_and_batch_shed(model):
    srv = _port_server(model, max_queue=2)
    p = np.array([1, 2, 3], np.int32)
    keep = [S.Request(prompt=p, max_new_tokens=2) for _ in range(2)]
    for r in keep:
        srv.submit(r)
    with pytest.raises(S.QueueFullError):
        srv.submit(S.Request(prompt=p, max_new_tokens=2))
    assert srv.stats()["shed"] == 1

    # the batch tier sheds at max_queue * batch_queue_frac, and a queued
    # batch request is displaced by an interactive arrival
    srv = _port_server(model, max_queue=2)
    bat = S.Request(prompt=p, max_new_tokens=2, priority="batch")
    srv.submit(bat)
    with pytest.raises(S.QueueFullError):
        srv.submit(S.Request(prompt=p, max_new_tokens=2, priority="batch"))
    inter = [S.Request(prompt=p, max_new_tokens=2) for _ in range(2)]
    for r in inter:
        srv.submit(r)               # the second displaces the batch one
    done = srv.run_until_drained()
    assert done[bat.id].finish_reason == "shed" and done[bat.id].tokens == []
    assert all(done[r.id].finish_reason == "length" for r in inter)
    assert srv.shed_by_class == {"interactive": 0, "batch": 2}

    srv = _port_server(model)
    late = S.Request(prompt=p, max_new_tokens=2,
                     deadline=time.monotonic() - 1)
    ok = S.Request(prompt=p, max_new_tokens=2)
    srv.submit(late)
    srv.submit(ok)
    done = srv.run_until_drained()
    assert done[late.id].finish_reason == "expired"
    assert done[ok.id].finish_reason == "length"
    assert srv.stats()["expired"] == 1 and srv.blocks_dispatched > 0


def test_per_request_sampling_is_seeded(model):
    """Greedy, hot and top-k=1 requests share one pool: top_k=1 at a hot
    temperature and temperature 0 both reproduce solo greedy; the sampled
    rows repeat under the same seed and move under another."""
    prompts = _prompts(6, seed=149)
    solo = [_port_solo(model, p, 6) for p in prompts]

    def run(seed):
        srv = _port_server(model, slots=3, temperature=0.8, seed=seed)
        reqs = [S.Request(prompt=p, max_new_tokens=6,
                          temperature=(4.0, 0.0, None)[i % 3],
                          top_k=(1, None, 7)[i % 3])
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        done = srv.run_until_drained()
        return [done[r.id].tokens for r in reqs]

    a, b, c = run(11), run(11), run(12)
    assert a == b
    for i, toks in enumerate(a):
        assert len(toks) == 6 and all(0 <= t < 256 for t in toks)
        if i % 3 != 2:
            assert toks == solo[i], f"greedy request {i} diverged"
    assert [a[i] for i in (2, 5)] != [c[i] for i in (2, 5)]


def test_stop_sequence_and_reset(model):
    """A per-request stop sequence ends the stream at its match; reset()
    keeps the queue and replays the admitted request from the journal
    (under replay=False it returns the admitted ids as lost)."""
    p = _prompts(1, seed=17)[0]
    solo = _port_solo(model, p, 12)
    srv = _port_server(model)
    r = S.Request(prompt=p, max_new_tokens=12, stop=solo[4:6])
    srv.submit(r)
    done = srv.run_until_drained()
    end = S._stop_match_end(solo, [tuple(solo[4:6])])
    assert end is not None and end <= 6
    assert done[r.id].tokens == solo[:end]
    assert done[r.id].finish_reason == "stop"

    for replay in (True, False):
        srv = _port_server(model, slots=1, replay=replay)
        first = S.Request(prompt=p, max_new_tokens=12)
        queued = S.Request(prompt=p, max_new_tokens=3)
        srv.submit(first)
        srv.submit(queued)
        srv.step()
        assert srv.reset() == ([] if replay else [first.id])
        done = srv.run_until_drained()
        assert done[queued.id].tokens == solo[:3]
        if replay:
            assert list(done) == [first.id, queued.id]
            assert done[first.id].tokens == solo
        else:
            assert list(done) == [queued.id]
        assert srv.stats()["resets"] == 1


def test_submit_rejections(model):
    srv = _port_server(model, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        srv.submit(S.Request(prompt=list(range(10)), max_new_tokens=10))
    with pytest.raises(ValueError, match="empty"):
        srv.submit(S.Request(prompt=[], max_new_tokens=4))
    with pytest.raises(ValueError, match="max_new_tokens"):
        srv.submit(S.Request(prompt=[1], max_new_tokens=0))
    with pytest.raises(ValueError, match="token ids"):
        srv.submit(S.Request(prompt=[1, 256], max_new_tokens=2))
    with pytest.raises(ValueError, match="logprobs"):
        srv.submit(S.Request(prompt=[1], max_new_tokens=2, logprobs=9))
    with pytest.raises(ValueError, match="priority"):
        srv.submit(S.Request(prompt=[1], max_new_tokens=2, priority="x"))
    with pytest.raises(ValueError, match="resume_tokens"):
        srv.submit(S.Request(prompt=[1], max_new_tokens=2,
                             resume_tokens=[3, 256]))
    # a resume prefix within the vocabulary is accepted
    rid = srv.submit(S.Request(prompt=[1], max_new_tokens=2,
                               resume_tokens=[3]))
    assert srv.progress(rid) == {"tokens": [3], "prompt_tokens": 1}


def _mesh_shape(**sizes):
    """A mesh's shape and this rank's coordinates alone: what the checks
    made before any placement read."""
    import types

    from tony_tpu_torch.parallel.mesh import AXIS_ORDER

    return types.SimpleNamespace(
        mesh_dim_names=AXIS_ORDER,
        mesh=torch.empty([sizes.get(a, 1) for a in AXIS_ORDER]),
        get_coordinate=lambda: [0] * len(AXIS_ORDER))


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"rules": {}}],
                         ids=lambda kw: next(iter(kw)))
def test_not_ported_arguments_raise(model, kw):
    """``mesh=`` and ``rules=`` are ported; the JAX package's refusals on a
    tensor-parallel mesh stand: a draft (``mesh``) and int8 weights
    (``rules``, the rule table that shards the heads)."""
    from tony_tpu_torch.models.generate import DecodeWeights
    from tony_tpu_torch.parallel import TP_DECODE_RULES

    _, cfg, _, params = model
    mesh = _mesh_shape(tensor=2)
    if "mesh" in kw:
        prep = DecodeWeights(params=params, fused=None, mesh=mesh,
                             rules=TP_DECODE_RULES)
        with pytest.raises(ValueError,
                           match="speculative serving is single-device"):
            S.SlotServer(prep, cfg, slots=2, max_len=64, device="cpu",
                         draft=params, draft_cfg=cfg)
    else:
        with pytest.raises(ValueError, match="weight_dtype='int8'"):
            _port_server(model, mesh=mesh, rules=TP_DECODE_RULES,
                         weight_dtype="int8")


@pytest.mark.parametrize("kw", [{"journal": "file"}, {"replay": False}],
                         ids=lambda kw: next(iter(kw)))
def test_journal_and_replay_arguments(model, kw, tmp_path):
    """The journal arguments: a caller's journal is the
    one the server writes, and replay=False runs without one."""
    from tony_tpu_torch.events import RequestJournal, read_journal

    if "journal" in kw:
        kw = {"journal": RequestJournal(tmp_path / "j.jsonl")}
    srv = _port_server(model, **kw)
    r = S.Request(prompt=[5, 6, 7], max_new_tokens=4)
    srv.submit(r)
    assert (srv.progress(r.id) is None) == ("replay" in kw)
    assert srv.run_until_drained()[r.id].tokens == _port_solo(
        model, np.asarray([5, 6, 7]), 4)
    st = srv.stats()
    assert st["replay"] is ("journal" in kw)
    if "journal" in kw:
        assert st["journal"]["entries"] == 0 and st["journal"]["durable"]
        srv.shutdown()
        assert read_journal(tmp_path / "j.jsonl") == []
    else:
        assert "journal" not in st


def test_unported_model_features_raise(model):
    _, cfg, _, params = model
    with pytest.raises(TypeError, match="unexpected keyword"):
        S.SlotServer(params, cfg, device="cpu", no_such_option=1)
    # the off values of the not-ported arguments are accepted
    S.SlotServer(params, cfg, device="cpu", max_len=16, mesh=None,
                 replay=True, role="both", prefix_cache_blocks=0, rules=None,
                 draft_cfg=None, spec_gamma=0, spec_gamma_max=4, kv_block=0,
                 kv_pool_blocks=0, class_budgets=None, prefill_interleave=0)
