"""Tensor-parallel serving in the port (models/serving.py ``SlotServer`` on
a mesh, parallel/lockstep.py, ``serve --mesh``) on 2 and 4 gloo processes.

The engines on a ``data=2,tensor=2`` mesh (4 processes) are held against
the JAX package's on 4 forced host devices (tests/conftest.py), from the
same parameters (converted with from_jax_params), at float32, greedy,
token-identical: the counterparts of tests/test_serving.py:381 (the ring
engine, prepared and raw weights), :414 (EOS with per-slot admission),
:435 (the rejections) and :511 (the prefix cache), and of
tests/test_paged_kv.py:519 (the paged pool). Port-only, on 2 processes:
``serve --mesh tensor=2`` answers /generate (buffered and SSE) and
/v1/completions with a one-process serve's tokens and its follower binds
no port; a chaos crash on rank 1 mid-burst resets every rank and the
completions are the crashless run's; a tampered follower digest raises."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tony_tpu.models import transformer as jT
from tony_tpu.models.generate import generate as jax_generate
from tony_tpu.models.generate import prepare_decode as jax_prepare
from tony_tpu.models.serving import Request as JRequest
from tony_tpu.models.serving import SlotServer as JSlotServer
from tony_tpu.parallel import MeshSpec, build_mesh
from tony_tpu_torch.cli import serve
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from torch_dist_worker import (run_ranks, serve_and_ask,
                               shed_under_deadlines)

TINY = jT.TransformerConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=128, max_seq_len=128,
                            dtype=jnp.float32)
FIELDS = {**dataclasses.asdict(TINY), "dtype": "float32",
          "param_dtype": "float32"}
RING = dict(slots=4, max_len=64, block_size=4, prefill_chunk=8)


def _prompts(n, key=3, lo=2, hi=14):
    """The JAX package's test_serving.py prompts."""
    k = jax.random.PRNGKey(key)
    out = []
    for _ in range(n):
        k, a, b = jax.random.split(k, 3)
        lp = int(jax.random.randint(a, (), lo, hi))
        out.append(np.asarray(
            jax.random.randint(b, (lp,), 0, TINY.vocab_size), np.int32))
    return out


def _templated(n, key):
    """n prompts sharing a 16-token template (two chunks) + suffixes."""
    template = np.asarray(jax.random.randint(
        jax.random.PRNGKey(97), (16,), 0, TINY.vocab_size), np.int32)
    return [np.concatenate([template, s]) for s in _prompts(n, key, 2, 9)]


def _paged_prompt(n, seed):
    """The JAX package's test_paged_kv.py prompt."""
    return np.asarray(jax.random.randint(
        jax.random.PRNGKey(seed), (n,), 0, TINY.vocab_size), np.int32)


def _jax_serve(params, prompts, budgets, **kw):
    srv = JSlotServer(params, TINY, **{**RING, **kw})
    reqs = [JRequest(prompt=p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    for r in reqs:
        srv.submit(r)
    done = srv.run_until_drained()
    return [done[r.id].tokens for r in reqs]


def _solo(params, prompt, max_new, **kw):
    out = jax_generate(params, TINY, jnp.asarray(prompt)[None], max_new,
                       **kw)
    return [int(t) for t in np.asarray(out)[0]]


@pytest.fixture(scope="module")
def cases():
    """Each engine's requests (the reference tests'), the JAX package's
    parameters on one device and prepared on the data=2,tensor=2 mesh,
    and the converted parameters. The JAX completions are each test's."""
    params = jT.init(jax.random.PRNGKey(0), TINY)
    mesh = build_mesh(MeshSpec(data=2, fsdp=1, tensor=2),
                      devices=jax.devices()[:4])
    ring = _prompts(10, key=71)
    eos = _prompts(6, key=73)
    stop = _solo(params, eos[0], 8)[2]
    pre = _templated(6, key=107)
    runs = {
        "ring": dict(prompts=ring, budgets=[5 + (i % 4) for i in range(10)],
                     kw=RING),
        "eos": dict(prompts=eos, budgets=[8] * 6,
                    kw=dict(RING, slots=2, stop_tokens=(stop,), pad_id=255,
                            batched_admission=False)),
        "cold": dict(prompts=pre, budgets=[5 + (i % 3) for i in range(6)],
                     kw=RING),
        "paged": dict(prompts=[_paged_prompt(9, seed=11),
                               _paged_prompt(13, seed=12)],
                      budgets=[8, 8], kw=dict(RING, paged=True)),
    }
    runs["raw"] = dict(runs["ring"], raw=True)
    runs["warm"] = dict(runs["cold"], kw=dict(RING, prefix_cache_blocks=8))
    runs["paged_warm"] = dict(runs["cold"], kw=dict(RING, paged=True,
                                                    prefix_cache_blocks=8))
    tree = jax.device_get(params)
    return {"runs": runs, "params": params,
            "prep": jax_prepare(params, TINY, mesh=mesh),
            "port": from_jax_params(tree, config_from_fields(FIELDS), "cpu")}


def _want(cases, name, mesh=True, **kw):
    run = cases["runs"][name]
    return _jax_serve(cases["prep"] if mesh else cases["params"],
                      run["prompts"], run["budgets"], **{**run["kw"], **kw})


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Every engine on each of 4 ranks of the port's data=2,tensor=2
    mesh."""
    return run_ranks("tp_serve", 4, {
        "cfg": FIELDS, "mesh": "data=2,tensor=2", "params": cases["port"],
        "runs": cases["runs"]}, tmp_path_factory.mktemp("tp_serve"),
        timeout=150)


def test_slot_server_tp_mesh_parity(cases, ranks):
    """test_serving.py:381: the ring engine on the mesh (the ring cache
    over ("batch", "kv"), the per-slot state over the batch axes) gives
    the JAX package's mesh completions, its one-device ones and solo
    generate's, from prepared weights and from raw weights with
    ``mesh=``; every rank holds the same host state."""
    run = cases["runs"]["ring"]
    want = _want(cases, "ring")
    assert want == _want(cases, "ring", mesh=False)
    assert want == [_solo(cases["params"], p, b)
                    for p, b in zip(run["prompts"], run["budgets"])]
    for r in ranks:
        assert r["fused"] is None
        assert r["ring"]["tokens"] == want
        assert r["raw"]["tokens"] == want
        assert r["ring"]["stats"]["mesh"]["data"] == 2
    assert len({repr(r["ring"]["digest"]) for r in ranks}) == 1


def test_slot_server_tp_mesh_eos_and_per_slot(cases, ranks):
    """test_serving.py:414: EOS mode and per-slot admission on the
    mesh."""
    want = _want(cases, "eos")
    for r in ranks:
        assert r["eos"]["tokens"] == want


def test_slot_server_mesh_rejections(ranks):
    """test_serving.py:435 and the reference's other refusals on a mesh:
    slots not divisible by the batch axes, meshless prepared weights with
    a mesh, a draft, and int8 weights under a sharded tensor axis."""
    for r in ranks:
        errs = r["rejections"]
        assert "slots=3" in errs["slots"]
        assert "without a mesh" in errs["meshless"]
        assert "speculative serving is single-device" in errs["draft"]
        assert "int8" in errs["int8"]


def test_prefix_cache_tp_mesh_hit_identical(cases, ranks):
    """test_serving.py:511: the prefix pool's blocks split over the batch
    axes and its kv heads over ``tensor``; hits are token-identical to the
    cold path and to the JAX package's mesh server."""
    want = _want(cases, "warm")
    assert want == _want(cases, "cold")
    for r in ranks:
        assert r["cold"]["tokens"] == want
        assert r["warm"]["tokens"] == want
        assert r["warm"]["stats"]["prefill_tokens_reused"] > 0


def test_paged_mesh_byte_identity(cases, ranks):
    """test_paged_kv.py:519: the paged pool split over its block axis like
    the ring's slots gives the one-device paged engine's completions; the
    allocator's check holds on every rank (the task raises otherwise) and
    its free list is the same on every rank."""
    want = _want(cases, "paged", mesh=False, slots=2)
    for r in ranks:
        assert r["paged"]["tokens"] == want
    assert len({repr(r["paged"]["digest"]) for r in ranks}) == 1


def test_paged_prefix_mesh_in_shares(cases, ranks):
    """The paged pool with the prefix trie on the mesh: each rank's slots
    take blocks of its own share, and a hit stops at another share's
    block, so the paged gather and scatter stay on the rank. The
    completions are the JAX package's one-device ring engine's with its
    prefix cache (never the JAX paged engine's: with the prefix cache it
    once answered 233 at request 0's fifth token where its own model's
    logits put 9 ahead by 0.55, a fault of that engine, not a near tie);
    hits within a share reuse the trie's blocks; every rank's host state
    is the same."""
    want = _want(cases, "warm", mesh=False)
    for r in ranks:
        assert r["paged_warm"]["tokens"] == want
        assert r["paged_warm"]["stats"]["prefill_tokens_reused"] > 0
    assert len({repr(r["paged_warm"]["digest"]) for r in ranks}) == 1


def test_paged_allocator_shares():
    """BlockAllocator(shares=2): a free list a share, the pad block (the
    pool's last) in none; a share's blocks come from its own list, the
    check holds, and a trie lookup with a share stops at a block of
    another share."""
    from tony_tpu_torch.models.serving import BlockAllocator, PrefixCache

    alloc = BlockAllocator(7, shares=2)             # 8 blocks, pad 7
    assert alloc.per_share == 4
    assert (alloc.free_in(0), alloc.free_in(1)) == (4, 3)
    assert alloc.alloc_for("interactive", 2, 1) == [4, 5]
    assert alloc.alloc_for("interactive", 2, 1) is None
    mine = alloc.alloc_for("interactive", 3, 0)
    assert mine == [0, 1, 2] and alloc.free_blocks == 2
    alloc.check()
    pc = PrefixCache(8, 2, allocator=alloc)
    body = np.arange(6, dtype=np.int32)
    assert pc.adopt(body, {0: 0, 1: 4}) == 2    # chunk 1 in share 1
    assert [n.block for n in pc.lookup(body)] == [0, 4]
    assert [n.block for n in pc.lookup(body, 0)] == [0]
    assert pc.lookup(body, 1) == []
    for b in (0, 1, 2, 4, 5):
        alloc.unref(b)
    assert alloc.free_in(0) == 3 and alloc.free_in(1) == 2
    assert pc.reclaim(2, 1) == 1 and alloc.free_in(1) == 3
    alloc.check()


SERVE = ["--device", "cpu", "--d-model", "64", "--n-layers", "2",
         "--n-heads", "4", "--d-ff", "128", "--vocab", "256", "--dtype",
         "float32", "--slots", "2", "--max-len", "128", "--block-size", "2",
         "--prefill-chunk", "16"]


def _http_reqs():
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(6):
        p = [int(t) for t in rng.integers(0, 256, int(rng.integers(3, 20)))]
        kind = ("generate", "sse", "v1")[i % 3]
        reqs.append((kind, {"prompt": " ".join(map(str, p)),
                            "max_tokens": 10} if kind == "v1"
                     else {"prompt": p, "max_new_tokens": 10}))
    return reqs


@pytest.fixture(scope="module")
def one_process():
    """A one-process serve's answers to the HTTP requests."""
    return serve_and_ask(SERVE, _http_reqs())["answers"]


def test_serve_mesh_matches_one_process(one_process, tmp_path):
    """``serve --mesh tensor=2`` on two processes: rank 0's /generate
    (buffered and SSE) and /v1/completions answer with a one-process
    serve's tokens; the follower binds no port; /stats carries the mesh
    and the world."""
    got = run_ranks("serve_mesh", 2, {"argv": SERVE + ["--mesh", "tensor=2"],
                                      "reqs": _http_reqs()}, tmp_path)
    lead, follower = got
    assert all(isinstance(a, list) and len(a) == 10 for a in one_process)
    assert lead["answers"] == one_process
    assert lead["stats"]["world"] == 2
    assert lead["stats"]["mesh"]["tensor"] == 2
    assert lead["stats"]["lockstep"]["turns"] > 0
    assert lead["binds"] >= 1 and follower["binds"] == 0
    assert follower["reason"] == ""


def test_serve_mesh_crash_on_a_follower_replays(one_process, tmp_path):
    """A chaos crash on rank 1 mid-burst (its decode block 3): every rank
    resets, rank 0's journal replays the in-flight requests, and every
    completion equals the crashless run's."""
    got = run_ranks("serve_mesh", 2, {
        "argv": SERVE + ["--mesh", "tensor=2"], "reqs": _http_reqs(),
        "env": {1: {"TONY_TEST_SERVING_CRASH_AT_BLOCKS": "3"}}}, tmp_path)
    lead = got[0]
    assert lead["answers"] == one_process
    st = lead["stats"]
    assert st["loop"]["failures"] == 1 and st["resets"] == 1
    assert st["replays"] >= 1 and lead["status"] == "ok"


def test_serve_mesh_digest_mismatch_raises(tmp_path):
    """A follower whose host state differs from rank 0's raises, naming
    the first difference, and rank 0's serving goes down with it."""
    got = run_ranks("serve_mesh", 2, {
        "argv": SERVE + ["--mesh", "tensor=2"], "reqs": _http_reqs()[:1],
        "tamper": True}, tmp_path)
    lead, follower = got
    assert "LockstepMismatch" in follower["raised"]
    assert "'queued'" in follower["raised"]
    assert lead["status"] == "down" and "'queued'" in lead["error"]


def test_serve_mesh_sheds_in_step(tmp_path):
    """``serve --mesh tensor=2 --max-queue 4`` under overload with queue
    deadlines: a batch request's submit sweeps an expired request out of
    the full queue and is shed all the same (a 429). The followers replay
    the refused submit, so the ranks keep equal host state and go on
    serving, with a one-process serve's outcomes."""
    argv = SERVE + ["--max-queue", "4"]
    prompts = [[int(t) for t in p] for p in _prompts(5, key=11)]
    want = shed_under_deadlines(argv, prompts)
    assert want["outcomes"][:2] == ["QueueFullError", "TimeoutError"]
    assert all(len(t) == 6 for t in want["outcomes"][2:])
    got = run_ranks("serve_mesh_shed", 2, {
        "argv": argv + ["--mesh", "tensor=2"], "prompts": prompts},
        tmp_path)
    lead, follower = got
    assert lead["status"] == "ok", lead["error"]
    assert lead["outcomes"] == want["outcomes"]
    assert (lead["shed"], lead["expired"]) == (1, 1)
    assert follower["reason"] == ""
    assert follower["digest"] == lead["digest"] == want["digest"]


def test_serve_mesh_flag_rejections():
    """The reference's --mesh messages: a bad axis=size, a duplicate axis,
    too few processes."""
    for spec, msg in (("tensor", "axis=size"), ("tensor=0", "positive"),
                      ("tensor=2,tensor=2", "given twice"),
                      ("tensor=2", "needs 2 processes")):
        with pytest.raises(SystemExit, match=msg):
            serve.build_serving_mesh(spec, "cpu")
