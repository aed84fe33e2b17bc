"""Port parity: the serving prefix cache (tony_tpu_torch.models.serving
``PrefixCache``, ``_copy_prefix_blocks``/``_insert_prefix_blocks`` and the
SlotServer's ``prefix_cache_blocks``/``cache_prompts``) against the JAX
package on the CPU, mirroring tests/test_serving.py's prefix-cache tests
and tests/test_serving_robustness.py's cancel test.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``
(TINY widths, as tests/test_serving.py); prompts come from numpy. Both
sides run in float32. The contract: completions with the cache on are
token-identical to the port's own cold engine (the cache moves bytes and
changes no arithmetic), to the JAX SlotServer with its prefix cache, and
to solo generate. Seed 0 (params) and the numpy seeds below give
near-tie-free greedy streams, as in tests/test_torch_serving.py. The two
device programs are held bit-exact against the JAX ones."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu.models.serving import PrefixCache as JPrefixCache
from tony_tpu.models.serving import Request as JRequest
from tony_tpu.models.serving import SlotServer as JSlotServer
from tony_tpu.models.serving import _copy_prefix_blocks as j_copy
from tony_tpu.models.serving import _insert_prefix_blocks as j_insert
from tony_tpu_torch.models import generate as G
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params

jG = importlib.import_module("tony_tpu.models.generate")

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=jnp.float32)
SERVER = dict(slots=2, max_len=64, block_size=4, prefill_chunk=8)
# two full chunks at prefill_chunk=8
TEMPLATE = np.random.default_rng(97).integers(0, 256, 16, dtype=np.int32)


@pytest.fixture(scope="module")
def model():
    jcfg = jT.TransformerConfig(**TINY)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


def _prompts(n, seed, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.int32)
            for _ in range(n)]


def _templated(n, seed, template=TEMPLATE):
    """n prompts sharing the template, each with a short unique suffix."""
    return [np.concatenate([template, s]) for s in _prompts(n, seed)]


def _solo(model, prompt, n):
    _, cfg, _, params = model
    out = G.generate(params, cfg, torch.from_numpy(prompt).long()[None], n)
    return out[0].tolist()


def _serve_all(model, prompts, budgets, **kw):
    """The requests through one port SlotServer -> (tokens in request
    order, the server)."""
    _, cfg, _, params = model
    srv = S.SlotServer(params, cfg, device="cpu", **{**SERVER, **kw})
    reqs = [S.Request(prompt=p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    for r in reqs:
        srv.submit(r)
    done = srv.run_until_drained()
    return [done[r.id].tokens for r in reqs], srv


def _jax_serve_all(model, prompts, budgets, **kw):
    jcfg, _, tree, _ = model
    srv = JSlotServer(tree, jcfg, **{**SERVER, **kw})
    reqs = [JRequest(prompt=p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    for r in reqs:
        srv.submit(r)
    done = srv.run_until_drained()
    return [done[r.id].tokens for r in reqs], srv


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "per_slot"])
def test_prefix_cache_hit_path_token_identical(model, batched):
    """Completions with the cache on equal the cold engine's, the JAX
    SlotServer's with its prefix cache, and solo generate, the prompt
    whose body is exactly the cached prefix (nothing left to prefill)
    included; the counters match the JAX server's."""
    prompts = _templated(6, 101)
    prompts.append(np.concatenate([TEMPLATE, TEMPLATE[:1]]))
    budgets = [5 + (i % 3) for i in range(len(prompts))]
    kw = dict(batched_admission=batched)
    cold, cold_srv = _serve_all(model, prompts, budgets, **kw)
    warm, srv = _serve_all(model, prompts, budgets, prefix_cache_blocks=8,
                           **kw)
    jwarm, jsrv = _jax_serve_all(model, prompts, budgets,
                                 prefix_cache_blocks=8, **kw)
    assert warm == cold == jwarm
    for toks, p, b in zip(warm, prompts, budgets):
        assert toks == _solo(model, p, b)
    st, jst = srv.stats(), jsrv.stats()
    assert st["prefix_cache"] == jst["prefix_cache"]
    assert st["prefill_tokens_reused"] == jst["prefill_tokens_reused"] >= \
        4 * TEMPLATE.size
    assert st["prefill_tokens_computed"] + st["prefill_tokens_reused"] == \
        cold_srv.stats()["prefill_tokens_computed"]
    assert st["prefix_cache"]["hits"] >= 4
    assert srv.admission_dispatches < cold_srv.admission_dispatches
    assert "prefix_cache" not in cold_srv.stats()


def test_prefix_cache_int8_kv_hit_identical(model):
    """int8 KV: the pool holds the quantized blocks and their scales, so
    hit and cold paths read the same bytes: completions identical, and
    equal to the JAX int8 server's with its prefix cache."""
    prompts = _templated(5, 103)
    budgets = [5] * len(prompts)
    cold, _ = _serve_all(model, prompts, budgets, kv_dtype="int8")
    warm, srv = _serve_all(model, prompts, budgets, kv_dtype="int8",
                           prefix_cache_blocks=8)
    jwarm, _ = _jax_serve_all(model, prompts, budgets, kv_dtype="int8",
                              prefix_cache_blocks=8)
    assert warm == cold == jwarm
    assert srv.prefill_tokens_reused > 0
    assert srv._pool.k.dtype == torch.int8
    assert srv._pool.k_scale.dtype == torch.bfloat16


def test_prefix_cache_ring_wrap_reuse(model):
    """A copied prefix that spans the ring's end lands at the wrapped
    indices as the prefill's own writes would: filler requests
    (cache_prompt=False, so they leave the trie alone) advance the cursor
    until the next admission's copy wraps, and the templated request
    still equals solo generate."""
    _, cfg, _, params = model
    max_len = 48
    template = np.random.default_rng(113).integers(0, 256, 32,
                                                   dtype=np.int32)
    sfx = _prompts(2, 127, lo=2, hi=4)
    srv = S.SlotServer(params, cfg, device="cpu", slots=2, max_len=max_len,
                       block_size=4, prefill_chunk=8, prefix_cache_blocks=8)

    def run_one(prompt, **kw):
        r = S.Request(prompt=prompt, max_new_tokens=4, **kw)
        srv.submit(r)
        return srv.run_until_drained()[r.id].tokens

    first = np.concatenate([template, sfx[0]])
    assert run_one(first) == _solo(model, first, 4)
    second = np.concatenate([template, sfx[1]])
    body = second.size - 1
    rng = np.random.default_rng(131)
    for _ in range(40):
        offset = (srv._cursor - body) % max_len
        if offset + template.size > max_len:    # the copy will wrap
            break
        run_one(rng.integers(0, 256, 5, dtype=np.int32), cache_prompt=False)
    else:
        pytest.fail("the cursor never reached a wrapping offset")
    reused = srv.prefill_tokens_reused
    assert run_one(second) == _solo(model, second, 4)
    assert srv.prefill_tokens_reused == reused + template.size
    assert srv.stats()["prefix_cache"]["inserted_blocks"] == 4


def _exercise_trie(cls):
    """The reference's refcount and eviction sequence on one PrefixCache
    class -> every observable along the way."""
    seen = []
    pc = cls(2, 4)
    a = np.arange(8, dtype=np.int32)                # 2 chunks
    created = pc.insert(a)
    seen.append([(ci, n.block) for ci, n in created])
    assert pc.blocks_used == 2
    pc.release([n for _, n in created])             # the insert references
    path = pc.lookup(a)
    assert [n.block for n in path] == [n.block for _, n in created]
    pc.acquire(path)
    # both blocks are on a referenced path: nothing to evict
    seen.append(pc.alloc())
    b = np.arange(100, 108, dtype=np.int32)
    seen.append(pc.insert(b))                       # degrades, no failure
    pc.release(path)
    # unreferenced now: eviction takes the leaf (the deeper chunk) first
    seen.append((pc.alloc(), path[1].block, pc.evictions))
    seen.append(len(pc.lookup(a)))                  # one chunk still hits
    seen.append((pc.alloc(), path[0].block, pc.evictions))
    seen.append(pc.lookup(a))
    # LRU: two sibling prefixes, the older one touched again: the other
    # goes
    pc2 = cls(2, 4)
    na = pc2.insert(np.arange(4, dtype=np.int32))
    nb = pc2.insert(np.arange(50, 54, dtype=np.int32))
    pc2.release([n for _, n in na] + [n for _, n in nb])
    pc2.lookup(np.arange(4, dtype=np.int32))
    seen.append((pc2.alloc(), nb[0][1].block))
    seen.append((pc.hits, pc.misses, pc.inserted_blocks, pc2.evictions))
    return seen


def test_prefix_cache_refcount_and_eviction_unit():
    """The host trie and allocator, no model: the budget holds, eviction
    is LRU over unreferenced leaves only, a referenced or interior node
    is never evicted, an insert that finds no block degrades to a shorter
    prefix; every step equals the JAX package's PrefixCache."""
    seen = _exercise_trie(S.PrefixCache)
    assert seen == _exercise_trie(JPrefixCache)
    assert seen[1] is None and seen[2] == []
    assert seen[3][0] == seen[3][1] and seen[3][2] == 1
    assert seen[4] == 1 and seen[5][0] == seen[5][1] and seen[6] == []
    assert seen[7][0] == seen[7][1]
    with pytest.raises(RuntimeError, match="underflow"):
        S.PrefixCache(2, 4).release([S._PrefixNode(None, b"", 0)])
    with pytest.raises(ValueError, match=">= 1 block"):
        S.PrefixCache(0, 4)
    # paged mode: the trie's blocks come from the pool's allocator
    alloc = S.BlockAllocator(3)
    paged = S.PrefixCache(2, 4, allocator=alloc)
    assert paged.alloc() == 0 and alloc.refs[0] == 1 and alloc.free_blocks == 2


def test_prefix_cache_eviction_stress_server(model):
    """A 2-block pool cycling through three 2-chunk prefixes: every
    admission evicts, the budget holds, and every completion equals solo
    generate."""
    _, cfg, _, params = model
    rng = np.random.default_rng(137)
    templates = [rng.integers(0, 256, 16, dtype=np.int32) for _ in range(3)]
    srv = S.SlotServer(params, cfg, device="cpu", prefix_cache_blocks=2,
                       **SERVER)
    for _ in range(3):
        for t in templates:
            prompt = np.concatenate([t, t[:3]])
            r = S.Request(prompt=prompt, max_new_tokens=4)
            srv.submit(r)
            assert srv.run_until_drained()[r.id].tokens == \
                _solo(model, prompt, 4)
            pc = srv._prefix_cache
            assert pc.blocks_used <= pc.n_blocks == 2
    assert srv.stats()["prefix_cache"]["evictions"] > 0


def test_cancel_releases_prefix_cache_refs(model):
    """A cancelled request unpins its matched path (else its blocks could
    never be evicted), and the freed slot's next prefixed request stays
    equal to solo generate through the cache."""
    _, cfg, _, params = model
    template = np.random.default_rng(227).integers(0, 256, 16,
                                                   dtype=np.int32)
    sfx = _prompts(3, 229, lo=2, hi=6)
    srv = S.SlotServer(params, cfg, device="cpu", prefix_cache_blocks=8,
                       **SERVER)
    srv.submit(S.Request(prompt=np.concatenate([template, sfx[0]]),
                         max_new_tokens=4))
    srv.run_until_drained()                     # the trie holds the template
    a = S.Request(prompt=np.concatenate([template, sfx[1]]),
                  max_new_tokens=30)
    srv.submit(a)
    srv.step()
    assert a.id in srv._prefix_refs
    assert srv.cancel(a.id) is True
    srv.run_until_drained()
    assert not srv._prefix_refs
    assert all(n.refs == 0 for n in srv._prefix_cache._owned)
    prompt_b = np.concatenate([template, sfx[2]])
    b = S.Request(prompt=prompt_b, max_new_tokens=5)
    srv.submit(b)
    assert srv.run_until_drained()[b.id].tokens == _solo(model, prompt_b, 5)


def test_cache_prompts_off_inserts_only_on_request(model):
    """cache_prompts=False serves from the cache but inserts a prompt
    only when its request sets cache_prompt=True; reset() re-creates the
    pool and an empty trie."""
    _, cfg, _, params = model
    srv = S.SlotServer(params, cfg, device="cpu", prefix_cache_blocks=8,
                       cache_prompts=False, **SERVER)
    p0, p1, p2 = _templated(3, 139)

    def run(prompt, **kw):
        r = S.Request(prompt=prompt, max_new_tokens=4, **kw)
        srv.submit(r)
        return srv.run_until_drained()[r.id].tokens

    assert run(p0) == _solo(model, p0, 4)
    assert srv.stats()["prefix_cache"]["inserted_blocks"] == 0
    assert run(p1, cache_prompt=True) == _solo(model, p1, 4)
    st = srv.stats()["prefix_cache"]
    assert st["inserted_blocks"] == 2 and st["hits"] == 0
    assert run(p2) == _solo(model, p2, 4)
    assert srv.stats()["prefix_cache"]["hits"] == 1
    pool = srv._pool
    assert srv.reset() == []
    assert srv._pool is not pool
    assert srv.stats()["prefix_cache"] == dict(
        hits=0, misses=0, evictions=0, inserted_blocks=0, blocks_used=0,
        blocks_total=8, copy_dispatches=1, insert_dispatches=1)
    assert run(p2) == _solo(model, p2, 4)
    assert srv.stats()["prefix_cache"]["misses"] == 1


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_copy_and_insert_programs_match_jax(model, kv):
    """_copy_prefix_blocks and _insert_prefix_blocks against the JAX
    programs on the same pool and ring contents, rows crossing the ring's
    end included: bit-exact (both only move bytes). The JAX side's
    padding rows (out-of-bounds writes it drops) have no counterpart:
    the port sends the real rows only."""
    jcfg, cfg, _, _ = model
    rng = np.random.default_rng(7)
    slots_n, m_cap, n_blocks, chunk = 3, 40, 5, 8
    shape = (cfg.n_layers, slots_n, cfg.n_kv_heads, m_cap, cfg.head_dim)
    pshape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, chunk, cfg.head_dim)
    if kv == "int8":
        def vals(s):
            return rng.integers(-127, 128, s).astype(np.int8)
    else:
        def vals(s):
            return rng.standard_normal(s).astype(np.float32)
    # bf16-representable scales, so both sides hold the same numbers
    scales = (lambda s: torch.from_numpy(rng.random(s, dtype=np.float32))
              .to(torch.bfloat16).float().numpy()) if kv == "int8" else None
    ck, cv, pk, pv = vals(shape), vals(shape), vals(pshape), vals(pshape)
    cks = cvs = pks = pvs = None
    if scales is not None:
        cks, cvs = scales(shape[:-1]), scales(shape[:-1])
        pks, pvs = scales(pshape[:-1]), scales(pshape[:-1])
    # (slot, block, chunk index, ring offset): slot 0's two chunks wrap
    # (offset 30: positions 30..45 -> 30..39, 0..5); slot 2 at offset 3
    rows = np.array([(0, 4, 0, 30), (0, 1, 1, 30), (2, 2, 1, 3)], np.int64)

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    def j(x):
        return None if x is None else jnp.asarray(x)

    def port_state():
        bf = torch.bfloat16
        cache = G.KVCache(t(ck), t(cv), 0,
                          None if cks is None else t(cks).to(bf),
                          None if cvs is None else t(cvs).to(bf))
        pool = G.PrefixPool(t(pk), t(pv),
                            None if pks is None else t(pks).to(bf),
                            None if pvs is None else t(pvs).to(bf))
        return cache, pool

    def jax_state():
        bf = jnp.bfloat16
        cache = jG.KVCache(j(ck), j(cv), jnp.int32(0),
                           None if cks is None else j(cks).astype(bf),
                           None if cvs is None else j(cvs).astype(bf))
        pool = jG.PrefixPool(j(pk), j(pv),
                             None if pks is None else j(pks).astype(bf),
                             None if pvs is None else j(pvs).astype(bf))
        return cache, pool

    def same(a, b):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))

    # the JAX side's rows padded to 4 as its _prefix_rows does
    jrows = [np.concatenate([rows[:, i], [pad]]).astype(np.int32)
             for i, pad in zip(range(4), (slots_n, 0, 0, 0))]
    cache, pool = port_state()
    S._copy_prefix_blocks(pool, cache, torch.from_numpy(rows.T.copy()))
    jcache, _ = j_copy(jax_state()[1], jax_state()[0],
                       *map(jnp.asarray, jrows))
    for a, b in ((cache.k, jcache.k), (cache.v, jcache.v),
                 (cache.k_scale, jcache.k_scale),
                 (cache.v_scale, jcache.v_scale)):
        if a is not None:
            same(a, b)
    jrows[0][-1], jrows[1][-1] = 0, n_blocks      # pad: a dropped block
    cache, pool = port_state()
    S._insert_prefix_blocks(pool, cache, torch.from_numpy(rows.T.copy()))
    jpool, _ = j_insert(jax_state()[1], jax_state()[0],
                        *map(jnp.asarray, jrows))
    for a, b in ((pool.k, jpool.k), (pool.v, jpool.v),
                 (pool.k_scale, jpool.k_scale),
                 (pool.v_scale, jpool.v_scale)):
        if a is not None:
            same(a, b)
    # the port's pool allocator mirrors init_cache's layout and dtypes
    p = G.init_prefix_pool(cfg, n_blocks, chunk, kv, "cpu")
    jp = jG.init_prefix_pool(jcfg, n_blocks, chunk, kv)
    assert tuple(p.k.shape) == jp.k.shape == pshape
    assert (p.k_scale is None) == (jp.k_scale is None) == (kv == "native")
