"""The port's paged KV and admission tiers (tony_tpu_torch.models.serving
``BlockAllocator``, ``PrefixCache(allocator=)``, ``_gather_paged_view`` /
``_scatter_paged_rows``, ``SlotServer(paged=True, ...)`` and serve's
``--paged-kv`` flags) on the CPU, against the JAX package.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``
(TINY widths, float32); prompts come from numpy.

- The allocator and the trie on it are host bookkeeping: seeded random
  operation sequences must leave the port's and the JAX package's in the
  same state after every operation (free lists, refcounts, class use,
  peaks, trie blocks).
- The paged engine runs the ring engine's programs on a gathered view,
  so its completions are the port's ring engine's token for token in
  every mode (predictive, EOS, int8 KV, prefix cache, interleaved
  prefill), and, at float32, the JAX ring SlotServer's (the JAX paged
  engine is not the reference here: its own byte-identity tests flake).
- The gather and the scatter are held against a plain loop over slots,
  positions and layers.
- The unit tests of tests/test_paged_kv.py are repeated on the port's
  classes (an underflow raises RuntimeError here, AssertionError there);
  the tiers' Retry-After is tests/test_torch_serving_telemetry.py's."""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import serving as jS
from tony_tpu.models import transformer as jT
from tony_tpu_torch.api.stream import TokenStream
from tony_tpu_torch.cli import serve
from tony_tpu_torch.cli.serve import ServeApp
from tony_tpu_torch.models import generate as G
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=jnp.float32)
SRV = dict(slots=2, max_len=64, block_size=4, prefill_chunk=8)


@pytest.fixture(scope="module")
def model():
    jcfg = jT.TransformerConfig(**TINY)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


def _prompts(n, seed, lo=2, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], int(rng.integers(lo, hi)),
                         dtype=np.int32) for _ in range(n)]


def _mk(model, **kw):
    _, cfg, _, params = model
    return S.SlotServer(params, cfg, device="cpu", **{**SRV, **kw})


def _run(srv, prompts, max_new=10, Req=S.Request, **req_kw):
    reqs = [Req(prompt=p, max_new_tokens=max_new, **req_kw) for p in prompts]
    for r in reqs:
        srv.submit(r)
    done = srv.run_until_drained()
    return [(done[r.id].tokens, done[r.id].finish_reason) for r in reqs]


def _template_prompts(n, seed, tmpl_len=24):
    """n prompts sharing one ``tmpl_len``-token template, each with its
    own tail."""
    tmpl = np.random.default_rng(seed).integers(0, 256, tmpl_len,
                                                dtype=np.int32)
    return [np.concatenate([tmpl, p])
            for p in _prompts(n, seed + 1, lo=3, hi=9)]


# ------------------------------------------------- allocator and trie parity

def _alloc_state(a):
    return (list(a._free), a.refs.tolist(), dict(a.class_used), a.peak_used,
            a.free_blocks, a.used_blocks)


@pytest.mark.parametrize("seed", range(8))
def test_block_allocator_matches_jax_op_for_op(seed):
    """Random take / alloc_for / ref / unref / credit sequences (valid ones
    only) through both allocators, budgets on one class: the same results
    and the same state after every operation."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 24))
    budgets = {"batch": int(rng.integers(1, n))} if seed % 2 else None
    ours, ref = S.BlockAllocator(n, budgets), jS.BlockAllocator(n, budgets)
    held: list[int] = []            # one entry a reference
    for _ in range(200):
        op = rng.integers(0, 5)
        if op == 0:
            got = (ours.take(), ref.take())
            assert got[0] == got[1]
            if got[0] is not None:
                held.append(got[0])
        elif op == 1:
            cls = ("interactive", "batch")[rng.integers(0, 2)]
            k = int(rng.integers(0, 5))
            got = (ours.alloc_for(cls, k), ref.alloc_for(cls, k))
            assert got[0] == got[1]
            held.extend(got[0] or [])
        elif op == 2 and held:
            b = held[rng.integers(0, len(held))]
            ours.ref(b)
            ref.ref(b)
            held.append(b)
        elif op == 3 and held:
            b = held.pop(rng.integers(0, len(held)))
            ours.unref(b)
            ref.unref(b)
        elif op == 4:
            cls = ("interactive", "batch")[rng.integers(0, 2)]
            k = int(rng.integers(0, 4))
            ours.credit(cls, k)
            ref.credit(cls, k)
        assert _alloc_state(ours) == _alloc_state(ref)
    ours.check()
    ref.check()


def _trie_state(pc):
    return (sorted(n.block for n in pc._owned), pc.hits, pc.misses,
            pc.evictions, pc.inserted_blocks)


@pytest.mark.parametrize("seed", range(8))
def test_paged_trie_matches_jax_op_for_op(seed):
    """``PrefixCache(allocator=)``: random adopt / lookup+acquire / release
    / reclaim / alloc sequences over bodies drawn from a few templates,
    through the port's and the JAX package's trie on their own allocator:
    the same matched blocks, counters and allocator state throughout."""
    rng = np.random.default_rng(100 + seed)
    chunk, n = 2, 12
    sides = []
    for mod in (S, jS):
        alloc = mod.BlockAllocator(n)
        sides.append((alloc, mod.PrefixCache(6, chunk, allocator=alloc)))
    tmpls = [rng.integers(0, 5, 8, dtype=np.int32) for _ in range(3)]
    paths = []                      # acquired paths, as block lists
    for _ in range(120):
        op = rng.integers(0, 5)
        body = tmpls[rng.integers(0, 3)][:int(rng.integers(1, 9))]
        if op == 0:
            got = []
            for alloc, pc in sides:
                blocks = alloc.alloc_for("interactive", len(body) // chunk)
                if blocks is None:
                    got.append(None)
                    continue
                added = pc.adopt(body, dict(enumerate(blocks)))
                for b in blocks:        # the slot table lets go
                    alloc.unref(b)
                alloc.credit("interactive", len(blocks))
                got.append((blocks, added))
            assert got[0] == got[1]
        elif op == 1:
            found = [pc.lookup(body) for _, pc in sides]
            assert [n.block for n in found[0]] == [n.block for n in found[1]]
            for (_, pc), path in zip(sides, found):
                pc.acquire(path)
            paths.append(found)
        elif op == 2 and paths:
            found = paths.pop(rng.integers(0, len(paths)))
            for (_, pc), path in zip(sides, found):
                pc.release(path)
        elif op == 3:
            k = int(rng.integers(0, 4))
            assert sides[0][1].reclaim(k) == sides[1][1].reclaim(k)
        elif op == 4:
            got = [pc.alloc() for _, pc in sides]
            assert got[0] == got[1]
            for (alloc, _), b in zip(sides, got):
                if b is not None:
                    alloc.unref(b)
        assert _trie_state(sides[0][1]) == _trie_state(sides[1][1])
        assert _alloc_state(sides[0][0]) == _alloc_state(sides[1][0])
    for alloc, _ in sides:
        alloc.check()


# ------------------------------------------ tests/test_paged_kv.py's units

def test_block_allocator_refcount_invariant():
    alloc = S.BlockAllocator(4)
    blocks = alloc.alloc_for("interactive", 2)
    assert len(blocks) == 2 and alloc.free_blocks == 2
    alloc.ref(blocks[0])                    # shared with the trie
    alloc.unref(blocks[0])                  # the slot table lets go
    assert alloc.free_blocks == 2           # the trie's ref keeps it
    alloc.unref(blocks[0])
    assert alloc.free_blocks == 3           # the last holder frees it
    alloc.check()
    with pytest.raises(RuntimeError, match="underflow"):
        alloc.unref(blocks[0])
    with pytest.raises(RuntimeError, match="free"):
        alloc.ref(blocks[0])
    alloc.refs[blocks[1]] = 0               # an orphan
    with pytest.raises(RuntimeError, match="refcount 0"):
        alloc.check()


def test_block_allocator_class_budget_all_or_nothing():
    alloc = S.BlockAllocator(8, {"batch": 3})
    assert alloc.alloc_for("batch", 4) is None      # over budget: nothing
    got = alloc.alloc_for("batch", 3)
    assert len(got) == 3
    assert alloc.alloc_for("batch", 1) is None      # budget spent
    assert len(alloc.alloc_for("interactive", 5)) == 5  # the other tier
    alloc.credit("batch", 3)
    for b in got:
        alloc.unref(b)
    assert len(alloc.alloc_for("batch", 3)) == 3    # the credit reopens it
    with pytest.raises(ValueError, match="unknown priority class"):
        S.BlockAllocator(4, {"bulk": 2})
    with pytest.raises(ValueError, match=">= 1 block"):
        S.BlockAllocator(0)


def test_trie_eviction_skips_slot_shared_blocks():
    """A leaf whose block a slot table still holds (refcount > 1) is not
    evictable: a new writer would corrupt its reader's KV."""
    alloc = S.BlockAllocator(4)
    trie = S.PrefixCache(4, chunk=2, allocator=alloc)
    body = np.asarray([1, 2, 3, 4], np.int32)
    blocks = alloc.alloc_for("interactive", 2)
    assert trie.adopt(body, {0: blocks[0], 1: blocks[1]}) == 2
    for b in blocks:                        # the slot lets go
        alloc.unref(b)
    path = trie.lookup(body)                # a new slot hits chunk 0
    assert [n.block for n in path] == blocks
    alloc.ref(blocks[0])
    assert trie.reclaim(4) == 1             # only the sole-owner leaf
    assert alloc.refs[blocks[0]] == 2       # the shared leaf survived
    alloc.unref(blocks[0])                  # the slot table lets go...
    assert trie.reclaim(4) == 1             # ...now it is reclaimable
    assert alloc.free_blocks == 4
    alloc.check()
    with pytest.raises(RuntimeError, match="allocator"):
        S.PrefixCache(4, 2).reclaim(1)


def test_pool_gated_admission_small_pool_defers_and_completes(model):
    """A pool far below slots x max_len: admission defers instead of
    failing, every request completes with the ring engine's tokens, and
    the pool drains back to empty with the invariant intact."""
    prompts = _prompts(6, seed=3)
    srv = _mk(model, paged=True, kv_block=8, kv_pool_blocks=4)
    got = _run(srv, prompts)
    assert got == _run(_mk(model), prompts)
    assert all(r == "length" for _, r in got)
    st = srv.stats()["paged_kv"]
    assert st["pool_blocks_free"] == 4 and st["pool_blocks_used"] == 0
    assert st["admission_defers"] > 0 and st["pool_blocks_peak"] <= 4
    srv._allocator.check()


def test_cancel_mid_prefill_frees_blocks(model):
    """Cancel a request whose chunks are still pending (an interleave of 2
    tokens a turn leaves them there): it completes "cancelled" and every
    block it held comes back once the others drain."""
    srv = _mk(model, paged=True, prefill_interleave=2)
    reqs = [S.Request(prompt=p, max_new_tokens=6)
            for p in _prompts(3, seed=5, lo=20, hi=30)]
    for r in reqs:
        srv.submit(r)
    srv.step()
    pend = [a.req.id for a, _ in srv._pending_prefill]
    assert pend, "the interleave cap should leave chunks pending"
    held = srv.stats()["paged_kv"]["pool_blocks_used"]
    assert srv.cancel(pend[0])
    assert srv.stats()["paged_kv"]["pool_blocks_used"] < held
    comp = srv.drain_completed()[pend[0]]
    assert comp.finish_reason == "cancelled" and comp.tokens == []
    done = srv.run_until_drained()
    assert sorted(done) == sorted(r.id for r in reqs if r.id != pend[0])
    assert srv.stats()["paged_kv"]["pool_blocks_used"] == 0
    srv._allocator.check()


def test_trie_reclaim_under_pool_pressure_never_orphans(model):
    """A pool too small to keep the cached prefixes: the trie yields only
    leaves it alone holds, completions equal the ring engine's with its
    own prefix cache, and what the pool still holds after the drain is
    exactly the trie."""
    by_tmpl = [_template_prompts(2, seed=77 + 10 * t) for t in range(3)]
    prompts = [by_tmpl[t][i] for i in range(2) for t in range(3)]
    ring = _run(_mk(model, prefix_cache_blocks=8), prompts, max_new=6)
    srv = _mk(model, paged=True, kv_block=8, kv_pool_blocks=10,
              prefix_cache_blocks=8)
    assert _run(srv, prompts, max_new=6) == ring
    st = srv.stats()
    assert st["paged_kv"]["admission_defers"] > 0, "no pool pressure"
    assert st["prefix_cache"]["evictions"] > 0, "nothing reclaimed"
    assert (st["paged_kv"]["pool_blocks_used"]
            == st["prefix_cache"]["blocks_used"]
            == st["paged_kv"]["pool_state"]["trie"])
    srv._allocator.check()


@pytest.mark.parametrize("kw,match", [
    (dict(paged=True, max_len=60, kv_block=8), "multiple of"),
    (dict(paged=True, prefill_chunk=10, kv_block=4), "prefill_chunk"),
    (dict(prefill_interleave=2), "requires paged"),
    (dict(class_budgets={"batch": 4}), "requires paged"),
    (dict(paged=True, class_budgets={"bulk": 4}), "unknown priority"),
], ids=["max_len", "prefill_chunk", "interleave", "budgets", "class"])
def test_paged_mode_constructor_carveouts(model, kw, match):
    with pytest.raises(ValueError, match=match):
        _mk(model, **kw)


def test_paged_defaults_and_ring_free_memory(model):
    """kv_block defaults to block_size and the pool to the ring's bytes;
    paged mode allocates no ring; the pad block stays zero through a
    run."""
    srv = _mk(model, paged=True)
    assert srv.kv_block == SRV["block_size"]
    assert srv.kv_pool_blocks == 2 * 64 // 4
    assert srv._cache is None
    assert tuple(srv._kv_pool.k.shape) == (2, 33, 2, 4, 16)
    _run(srv, _prompts(4, seed=8))
    assert not srv._kv_pool.k[:, -1].any() and not srv._kv_pool.v[:, -1].any()


# ------------------------------------------------------ byte identity

MODES = {
    "predictive": ({}, {}),
    "eos": ({"stop_tokens": (5,)}, {}),
    "int8": ({"kv_dtype": "int8"}, {}),
    "prefix_cache": ({"prefix_cache_blocks": 16}, {"kv_block": 8}),
    "interleaved": ({}, {"prefill_interleave": 4}),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("batched", [True, False])
def test_paged_byte_identity_against_ring(model, mode, batched):
    """The same requests through the ring engine and the paged one: the
    same tokens and finish reasons, and the pool back to the trie alone
    afterwards."""
    common, paged_kw = MODES[mode]
    prompts = (_template_prompts(6, seed=99) if mode == "prefix_cache"
               else _prompts(6, seed=11))
    ring = _run(_mk(model, batched_admission=batched, **common), prompts)
    srv = _mk(model, paged=True, **common, **paged_kw)
    assert _run(srv, prompts) == ring
    st = srv.stats()
    if mode == "eos":
        assert any(r == "stop" for _, r in ring), "the stop never fired"
    if mode == "prefix_cache":
        assert st["prefix_cache"]["hits"] > 0
        assert st["prefill_tokens_reused"] > 0
        assert st["prefix_cache"]["copy_dispatches"] == 0
    if mode == "interleaved":
        assert st["paged_kv"]["prefill_chunks_interleaved"] > 0
    assert (st["paged_kv"]["pool_blocks_used"]
            == st["paged_kv"]["pool_state"]["trie"])
    srv._allocator.check()


@pytest.mark.parametrize("mode", ["predictive", "eos", "interleaved",
                                  "prefix_cache"])
def test_paged_matches_jax_ring_server(model, mode):
    """The port's paged engine against the JAX package's ring SlotServer
    on the same weights: token for token at float32."""
    jcfg, _, tree, _ = model
    common, paged_kw = MODES[mode]
    prompts = (_template_prompts(5, seed=41) if mode == "prefix_cache"
               else _prompts(5, seed=21))
    want = _run(jS.SlotServer(tree, jcfg, **{**SRV, **common}), prompts,
                Req=jS.Request)
    srv = _mk(model, paged=True, **common, **paged_kw)
    assert _run(srv, prompts) == want
    srv._allocator.check()


def test_paged_sampling_and_logprobs_match_ring(model):
    """Per-request temperature, top-k and logprobs ride the same slot
    state: with one seed the paged engine draws the ring engine's tokens
    and reports its logprobs."""
    prompts = _prompts(4, seed=31)
    got = {}
    for paged in (False, True):
        srv = _mk(model, paged=paged, seed=7)
        reqs = [S.Request(prompt=p, max_new_tokens=8,
                          temperature=0.9 if i % 2 else None,
                          top_k=20 if i == 1 else None, logprobs=3)
                for i, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        done = srv.run_until_drained()
        got[paged] = [(done[r.id].tokens, done[r.id].logprobs) for r in reqs]
    assert got[True] == got[False]


def test_finished_slot_never_commits_below_its_floor(model):
    """A request finishes and keeps its slot (and its blocks, which the
    trie adopted) while another decodes for more than a ring's length:
    the decode program writes a row for the finished slot at every step,
    and the cursor wraps its logical positions back over the prefix. The
    floor keeps those rows out of the pool, so a later request that hits
    the cached prefix gets the ring engine's tokens."""
    tmpl = _template_prompts(2, seed=211)
    filler = _prompts(1, seed=212, lo=3, hi=4)[0]
    got = []
    for paged in (False, True):
        kw = dict(paged=True, kv_block=8) if paged else {}
        srv = _mk(model, prefix_cache_blocks=16, **kw)
        long_ = S.Request(prompt=filler, max_new_tokens=60)
        short = S.Request(prompt=tmpl[0], max_new_tokens=4)
        srv.submit(long_)
        srv.submit(short)
        first = srv.run_until_drained()
        # the short one ends in block 1; the blocks after it carry its
        # rows past the ring's end and over its first kv block
        target = short.prompt.size - 1 + 4
        assert (srv.blocks_dispatched - 1) * SRV["block_size"] \
            > SRV["max_len"] - target + 8
        got.append((first[short.id].tokens, first[long_.id].tokens,
                    _run(srv, tmpl[1:], max_new=8)))
        assert srv.stats()["prefix_cache"]["hits"] >= 1
    assert got[0] == got[1]


@pytest.mark.parametrize("paged", [False, True])
def test_readmitted_slot_stays_busy_until_its_admit_is_processed(model,
                                                                 paged):
    """A slot re-admitted (predictively) after its request finished stays
    busy while processing has passed the predecessor's completion but not
    the successor's admit event: the decode blocks dispatched meanwhile
    must still sample the successor (temperature 1.0) rather than take
    the all-greedy variant, and the engine must not read idle. The same
    run without the intermediate processing is the reference."""
    p_short, p_long, p_late = _prompts(3, seed=201, lo=5, hi=9)
    got = []
    for split in (False, True):
        srv = _mk(model, paged=paged, seed=3)
        short = S.Request(prompt=p_short, max_new_tokens=4)
        long_ = S.Request(prompt=p_long, max_new_tokens=40)
        srv.submit(short)
        srv.submit(long_)
        for _ in range(3):                  # the short one ends in block 1
            srv.step()
        late = S.Request(prompt=p_late, max_new_tokens=12, temperature=1.0)
        srv.submit(late)
        srv.step()                          # admits into the short's slot
        if split:
            # processes block 1 (the short's completion), not the block
            # the late request's admit event rides on
            srv.checkpoint_progress()
            assert short.id in srv._done and not srv.idle
            assert srv.n_active == 2
        for _ in range(3):
            srv.step()
        done = srv.run_until_drained()
        got.append((done[late.id].tokens, done[long_.id].tokens))
    assert got[0] == got[1]


# --------------------------------------------------- tiers and admission

def test_class_budgets_shed_order(model):
    """Queue pressure with both tiers queued: queued batch work is shed
    to make room for interactive arrivals before any interactive request
    is refused; no request fails; the counts add up."""
    srv = _mk(model, paged=True, max_queue=4, batch_queue_frac=0.5)
    occ = [S.Request(prompt=p, max_new_tokens=12)
           for p in _prompts(2, seed=90, lo=8, hi=9)]
    for r in occ:
        srv.submit(r)
    for _ in range(4):
        srv.step()
    refused = {"batch": 0, "interactive": 0}
    for p in _prompts(3, seed=91, lo=6, hi=7):
        try:
            srv.submit(S.Request(prompt=p, max_new_tokens=4,
                                 priority="batch"))
        except S.QueueFullError:
            refused["batch"] += 1
    for p in _prompts(5, seed=92, lo=6, hi=7):
        try:
            srv.submit(S.Request(prompt=p, max_new_tokens=4,
                                 priority="interactive"))
        except S.QueueFullError:
            refused["interactive"] += 1
    done = srv.run_until_drained()
    shed = [c for c in done.values() if c.finish_reason == "shed"]
    st = srv.stats()
    assert refused["batch"] >= 1 and len(shed) >= 1
    assert st["shed_by_class"]["batch"] >= len(shed)
    assert st["shed_by_class"]["interactive"] == refused["interactive"]
    ok = [c for c in done.values() if c.finish_reason in ("stop", "length")]
    assert len(ok) == (2 + (5 - refused["interactive"])
                       + (3 - refused["batch"]) - len(shed))
    srv._allocator.check()


def test_class_budget_defers_and_skips_head_of_line(model):
    """A batch budget of one request's blocks: a second batch request at
    the head of the queue defers, the interactive request behind it is
    admitted past it, and everything completes as the ring engine's."""
    prompts = _prompts(3, seed=61, lo=10, hi=12)
    prio = ["batch", "batch", "interactive"]
    srv = _mk(model, paged=True, slots=3, class_budgets={"batch": 5})
    reqs = [S.Request(prompt=p, max_new_tokens=8, priority=c)
            for p, c in zip(prompts, prio)]
    for r in reqs:
        srv.submit(r)
    srv.step()
    assert [r.id for r in srv._queue] == [reqs[1].id]
    assert srv.stats()["paged_kv"]["class_used"] == {"interactive": 5,
                                                     "batch": 5}
    assert srv.stats()["paged_kv"]["admission_defers"] >= 1
    done = srv.run_until_drained()
    ring = _run(_mk(model, slots=3), prompts, max_new=8)
    assert [(done[r.id].tokens, done[r.id].finish_reason)
            for r in reqs] == ring
    assert srv.stats()["paged_kv"]["class_used"] == {"interactive": 0,
                                                     "batch": 0}
    srv._allocator.check()


# ---------------------------------------------------- replay and streams

def _crash_harness(srv, reqs):
    """Drive the engine as ServeApp's loop does (reset() after a chaos
    exception) to the end -> completions by id."""
    for r in reqs:
        srv.submit(r)
    done = {}
    while not srv.idle:
        try:
            srv.step()
            done.update(srv.drain_completed())
        except RuntimeError as e:
            assert "chaos" in str(e)
            assert srv.reset() == []
            srv._allocator.check()
    done.update(srv.drain_completed())
    return done


@pytest.mark.parametrize("interleave", [0, 4])
def test_replay_under_paged_mode(model, monkeypatch, interleave):
    """Crashes at decode blocks 2 and 5: reset() rebuilds the pool, the
    in-flight requests (mid-prefill ones too) replay from the journal,
    and every completion equals the crashless paged server's."""
    prompts = _prompts(5, seed=71, lo=6, hi=24)
    want = _run(_mk(model, paged=True, prefill_interleave=interleave),
                prompts, max_new=16)
    monkeypatch.setenv("TONY_TEST_SERVING_CRASH_AT_BLOCKS", "2,5")
    srv = _mk(model, paged=True, prefill_interleave=interleave)
    monkeypatch.delenv("TONY_TEST_SERVING_CRASH_AT_BLOCKS")
    reqs = [S.Request(prompt=p, max_new_tokens=16) for p in prompts]
    done = _crash_harness(srv, reqs)
    assert srv.chaos_faults_injected == 2 and srv.replays >= 1
    assert [(done[r.id].tokens, done[r.id].finish_reason)
            for r in reqs] == want
    assert srv.stats()["paged_kv"]["pool_blocks_used"] == 0
    srv._allocator.check()


def test_stream_under_paged_mode_equals_its_completion(model):
    """An attached TokenStream is fed at processing, which cannot tell
    the engines apart: in EOS mode (a feed a block) and predictive mode
    its tokens are the completion's and the ring engine's."""
    prompts = _prompts(3, seed=81, lo=6, hi=16)
    for kw in ({"stop_tokens": (5,)}, {}):
        ring = _run(_mk(model, **kw), prompts, max_new=12)
        srv = _mk(model, paged=True, prefill_interleave=4, **kw)
        streams = {}
        reqs = [S.Request(prompt=p, max_new_tokens=12) for p in prompts]
        for r in reqs:
            srv.submit(r)
            streams[r.id] = TokenStream()
            srv.attach_stream(r.id, streams[r.id])
        done = srv.run_until_drained()
        for r, want in zip(reqs, ring):
            toks, reason, err = streams[r.id].drain_all(timeout=5)
            assert (toks, reason) == (done[r.id].tokens,
                                      done[r.id].finish_reason) == want
            assert err is None


# ---------------------------------------------------- gather and scatter

def _plain_pool_pos(tables, offsets, s, i, kv_block, m_cap):
    p = (i - int(offsets[s])) % m_cap
    return p, int(tables[s, p // kv_block]), p % kv_block


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("seed", range(3))
def test_gather_and_scatter_against_a_plain_loop(model, kv, seed):
    """Random tables (pad entries included), offsets, floors and
    n_valids: the gathered view holds, at every (layer, slot, head, ring
    index), the pool row a plain loop finds; the scatter changes exactly
    the pool rows the loop lists (valid column, at or above the floor,
    not the pad block) to the view's values; the pad block stays zero."""
    _, cfg, _, _ = model
    rng = np.random.default_rng(seed)
    S_, B, n_tbl, n = 3, 4, 4, 10
    M = n_tbl * B
    pool = G.init_prefix_pool(cfg, n + 1, B, kv, "cpu")
    for t in (pool.k, pool.v, pool.k_scale, pool.v_scale):
        if t is None:
            continue
        if t.dtype == torch.int8:
            t[:, :n] = torch.from_numpy(
                rng.integers(-127, 128, t[:, :n].shape).astype(np.int8))
        else:
            t[:, :n] = torch.from_numpy(
                rng.standard_normal(t[:, :n].shape).astype(np.float32)
            ).to(t.dtype)
    # tables: each slot's blocks distinct across slots, some entries pad
    perm = rng.permutation(n)
    tables = np.full((S_, n_tbl), n, np.int32)
    for s in range(S_):
        k = int(rng.integers(1, n_tbl + 1))
        tables[s, :k] = perm[s * 3:s * 3 + k][:k]
        tables[s, :k][tables[s, :k] >= n] = n
    offsets = rng.integers(0, M, S_).astype(np.int32)
    kvh = cfg.n_kv_heads
    _, blk, row = S._paged_rows(tables, offsets, B, np.arange(M)[None, :])
    lens = torch.zeros(S_, dtype=torch.int32)
    view = S._gather_paged_view(
        pool, torch.from_numpy(blk * (kvh * B) + row), lens)
    assert tuple(view.k.shape) == (cfg.n_layers, S_, kvh, M, cfg.head_dim)
    assert view.length is lens
    for s in range(S_):
        for i in range(M):
            _, b, r = _plain_pool_pos(tables, offsets, s, i, B, M)
            assert torch.equal(view.k[:, s, :, i], pool.k[:, b, :, r])
            assert torch.equal(view.v[:, s, :, i], pool.v[:, b, :, r])
            if kv == "int8":
                assert torch.equal(view.k_scale[:, s, :, i],
                                   pool.k_scale[:, b, :, r])
    # the program writes new values everywhere in the view
    for t in (view.k, view.v, view.k_scale, view.v_scale):
        if t is not None:
            t.copy_(torch.from_numpy(
                rng.integers(-100, 100, t.shape).astype(np.float32)
            ).to(t.dtype))
    W = 6
    ring_ids = rng.integers(0, M, (S_, 1)) + np.arange(W)[None, :]
    ring_ids %= M
    n_valids = rng.integers(0, W + 1, S_)
    floors = rng.integers(0, M, S_)
    expect = {}
    for s in range(S_):
        for j in range(W):
            i = int(ring_ids[s, j])
            p, b, r = _plain_pool_pos(tables, offsets, s, i, B, M)
            if j < n_valids[s] and p >= floors[s] and b != n:
                expect[(b, r)] = (s, i)
    before = [t.clone() for t in (pool.k, pool.v, pool.k_scale, pool.v_scale)
              if t is not None]
    p_, blk, row = S._paged_rows(tables, offsets, B, ring_ids)
    keep = ((np.arange(W)[None, :] < n_valids[:, None])
            & (p_ >= floors[:, None]) & (blk < n))
    s_idx, j_idx = np.nonzero(keep)
    rows = np.stack([s_idx * (kvh * M) + ring_ids[s_idx, j_idx],
                     blk[s_idx, j_idx] * (kvh * B) + row[s_idx, j_idx]])
    assert rows.shape[1] == len(expect)
    S._scatter_paged_rows(pool, view, torch.from_numpy(rows.astype(np.int64)))
    names = ("k", "v", "k_scale", "v_scale")
    for name, old in zip(names, before):
        new, src = getattr(pool, name), getattr(view, name)
        for b in range(n + 1):
            for r in range(B):
                if (b, r) in expect:
                    s, i = expect[(b, r)]
                    assert torch.equal(new[:, b, :, r], src[:, s, :, i])
                else:
                    assert torch.equal(new[:, b, :, r], old[:, b, :, r])
        assert not new[:, n].any(), "the pad block was written"


def test_scatter_refuses_a_duplicate_target(model):
    """Two slots whose tables name one block, both committing the same
    logical position: the host raises before anything reaches the pool
    (on the card, a racy index_copy_)."""
    srv = _mk(model, paged=True)
    view = srv._gather_view()
    srv._np_tables[:, 0] = 3
    srv._np_offs[:] = 0
    with pytest.raises(RuntimeError, match="targeted twice"):
        srv._scatter_view(view, np.zeros((2, 1), np.int64),
                          np.ones(2, np.int64), np.zeros(2, np.int64))


# ----------------------------------------------------------- serve CLI

TINY_FLAGS = ["--device", "cpu", "--d-model", "64", "--n-layers", "2",
              "--n-heads", "4", "--d-ff", "128", "--vocab", "256",
              "--dtype", "float32", "--slots", "2", "--max-len", "64",
              "--block-size", "4", "--prefill-chunk", "8"]


def test_serve_paged_flags_over_http(model):
    """``serve --paged-kv`` and its flags reach the engine; /generate
    answers the ring engine's tokens, a batch request included; /stats
    carries ``paged_kv`` with the JAX package's keys."""
    jcfg, _, tree, _ = model
    args = serve.build_argparser().parse_args(TINY_FLAGS + [
        "--paged-kv", "--kv-block", "8", "--kv-pool-blocks", "12",
        "--prefill-interleave", "8", "--class-budget-interactive", "10",
        "--class-budget-batch", "6", "--prefix-cache-blocks", "4"])
    app = serve.build_app(args)
    srv = app.server
    assert (srv._paged, srv.kv_block, srv.kv_pool_blocks,
            srv.prefill_interleave) == (True, 8, 12, 8)
    assert srv._allocator.class_budgets == {"interactive": 10, "batch": 6}
    assert srv._prefix_cache.chunk == 8
    httpd = serve.make_httpd(app, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    app.start()
    try:
        # the CLI draws its weights from --seed: the ring engine it builds
        # without the paged flags is the reference
        ring = serve.build_server(serve.build_argparser().parse_args(
            TINY_FLAGS + ["--prefix-cache-blocks", "4"]))
        prompts = _prompts(3, seed=51, lo=4, hi=14)
        want = _run(ring, prompts, max_new=6)
        for p, prio, (toks, reason) in zip(prompts, ["interactive", "batch",
                                                     "interactive"], want):
            body = json.dumps({"prompt": p.tolist(), "max_new_tokens": 6,
                               "priority": prio}).encode()
            with urllib.request.urlopen(url + "/generate", data=body,
                                        timeout=60) as r:
                got = json.loads(r.read())
            assert (got["tokens"], got["finish_reason"]) == (toks, reason)
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.shutdown()
    jsrv = jS.SlotServer(tree, jcfg, **{**SRV, "paged": True})
    assert set(stats["paged_kv"]) == set(jsrv.stats()["paged_kv"])
    assert set(stats["paged_kv"]["pool_state"]) == {"free", "slot", "trie",
                                                    "shared"}
    pk = stats["paged_kv"]
    assert pk["pool_blocks_total"] == 12 and pk["pool_blocks_used"] == \
        pk["pool_state"]["trie"]
    assert pk["class_budgets"] == {"interactive": 10, "batch": 6}
    assert pk["gather_dispatches"] > 0


def test_serve_interleave_without_paged_is_refused():
    with pytest.raises(ValueError, match="requires paged"):
        serve.build_app(serve.build_argparser().parse_args(
            TINY_FLAGS + ["--prefill-interleave", "8"]))


def test_serve_app_paged_drain_and_reset(model):
    """ServeApp over a paged engine: the loop's recovery (a crash at a
    decode block) and a drain leave no request failed and the pool
    empty."""
    _, cfg, _, params = model
    import os
    os.environ["TONY_TEST_SERVING_CRASH_AT_BLOCKS"] = "3"
    try:
        srv = S.SlotServer(params, cfg, device="cpu", paged=True,
                           prefill_interleave=8, **SRV)
    finally:
        del os.environ["TONY_TEST_SERVING_CRASH_AT_BLOCKS"]
    app = ServeApp(srv, loop_backoff_s=0.01)
    app.start()
    prompts = _prompts(4, seed=13, lo=4, hi=20)
    want = _run(_mk(model), prompts, max_new=12)
    try:
        results = [None] * len(prompts)

        def call(i):
            results[i] = app.generate(prompts[i], 12, timeout=60)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
    finally:
        app.shutdown(drain=True, drain_timeout_s=30)
    assert [(c.tokens, c.finish_reason) for c in results] == want
    assert srv.chaos_faults_injected == 1
    assert srv.stats()["paged_kv"]["pool_blocks_used"] == 0
    srv._allocator.check()
