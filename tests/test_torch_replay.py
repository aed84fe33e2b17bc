"""The port's request journal and replay (tony_tpu_torch.models.serving
``SlotServer(journal=, replay=)``, ``reset()``, ``recover_journal``,
``checkpoint_progress``, the chaos hooks) on the CPU, mirroring
tests/test_serving_robustness.py's replay tests.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``
(TINY widths, float32); prompts come from numpy. Where the reference has
the test, the same scenario runs on the port's and the JAX package's
SlotServer, and the completions must be token-identical to each other
and to the port's solo ``generate`` (greedy, float32; the numpy prompt
seeds below were chosen away from near-ties of the greedy logits, where
float32 summation order, which differs between the frameworks, may pick
the other token). int8 KV is held at the reference's carve-out: the
journaled prefix verbatim, the continuation agreeing with an
uninterrupted int8 run in at least half the streams."""

import dataclasses
import importlib
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.cli.serve import ServeApp as JServeApp
from tony_tpu.events import journal as jJ
from tony_tpu.models import transformer as jT
from tony_tpu.models.serving import Request as JRequest
from tony_tpu.models.serving import SlotServer as JSlotServer
from tony_tpu_torch.cli.serve import ServeApp, ServingLoopError
from tony_tpu_torch.events import journal as J
from tony_tpu_torch.models import generate as G
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params

jG = importlib.import_module("tony_tpu.models.generate")

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=jnp.float32)
SRV = dict(slots=2, max_len=64, block_size=4, prefill_chunk=8)


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


def _solo(model, prompt, max_new):
    _, cfg, _, params = model
    out = G.generate(params, cfg, torch.from_numpy(prompt).long()[None],
                     max_new)
    return out[0].tolist()


def _sides(model):
    """side -> (a server factory, its Request class): the port's engine
    and the JAX package's, on the same weights."""
    jcfg, cfg, tree, params = model
    return {
        "torch": (lambda **kw: S.SlotServer(params, cfg, device="cpu",
                                            **{**SRV, **kw}), S.Request),
        "jax": (lambda **kw: JSlotServer(tree, jcfg, **{**SRV, **kw}),
                JRequest),
    }


def test_reset_replays_inflight_keeps_queue(model):
    """reset() with the journal on (the default): the admitted requests
    are re-queued ahead of the never-started one, under their own ids,
    and every completion equals an uninterrupted run's, on both
    frameworks, with the same journaled prefixes at the crash."""
    pa, pc, pb = _prompts(3, seed=241)
    got, prefixes = {}, {}
    for side, (make, Req) in _sides(model).items():
        srv = make()
        a = Req(prompt=pa, max_new_tokens=20)
        c = Req(prompt=pc, max_new_tokens=20)
        srv.submit(a)
        srv.submit(c)
        for _ in range(2):
            srv.step()                          # both slots mid-decode
        b = Req(prompt=pb, max_new_tokens=6)
        srv.submit(b)                           # queued: slots full
        prefixes[side] = [list(srv._journal.get(r.id).emitted)
                          for r in (a, c)]
        assert srv.reset() == []
        assert srv.pending == 3 and srv.n_active == 0 and srv.resets == 1
        assert [r.id for r in srv._queue] == [a.id, c.id, b.id]
        done = srv.run_until_drained()
        assert set(done) == {a.id, b.id, c.id}
        got[side] = [done[r.id].tokens for r in (a, c, b)]
        assert srv.replays == 2 and srv.stats()["replays"] == 2
        srv.shutdown()
    assert prefixes["torch"] == prefixes["jax"]
    assert got["torch"] == got["jax"] == [
        _solo(model, pa, 20), _solo(model, pc, 20), _solo(model, pb, 6)]


def test_reset_replay_off_fails_inflight_keeps_queue(model):
    """replay=False: the admitted requests are returned as lost, the
    queued one survives and is served as a fresh server would."""
    pa, pc, pb = _prompts(3, seed=241)
    for side, (make, Req) in _sides(model).items():
        srv = make(replay=False)
        a = Req(prompt=pa, max_new_tokens=20)
        c = Req(prompt=pc, max_new_tokens=20)
        srv.submit(a)
        srv.submit(c)
        for _ in range(2):
            srv.step()
        b = Req(prompt=pb, max_new_tokens=6)
        srv.submit(b)
        assert sorted(srv.reset()) == sorted([a.id, c.id]), side
        assert srv.pending == 1 and srv.n_active == 0
        assert srv.resets == 1 and srv.replays == 0
        done = srv.run_until_drained()
        assert set(done) == {b.id}
        assert done[b.id].tokens == _solo(model, pb, 6)
        srv.shutdown()


def test_reset_replay_resumes_from_emitted_prefix(model):
    """A request interrupted with tokens already processed re-prefills
    prompt + prefix and decodes only the rest: the completion equals the
    uninterrupted stream on both frameworks, the prefix is counted in
    replayed_tokens, and the re-decode covers only the remaining budget
    (one block of slack)."""
    pa = _prompts(1, seed=311)[0]
    got = {}
    for side, (make, Req) in _sides(model).items():
        srv = make()
        a = Req(prompt=pa, max_new_tokens=20)
        srv.submit(a)
        for _ in range(3):
            srv.step()
        srv.drain_completed()       # processes the pipeline
        prefix = list(srv._journal.get(a.id).emitted)
        assert 0 < len(prefix) < 20, "setup: need a partial prefix"
        blocks_before = srv.blocks_dispatched
        assert srv.reset() == []
        done = srv.run_until_drained()
        got[side] = done[a.id].tokens
        assert got[side][:len(prefix)] == prefix
        assert srv.replays == 1 and srv.replayed_tokens == len(prefix)
        remaining = 20 - len(prefix)
        assert srv.blocks_dispatched - blocks_before <= \
            -(-remaining // srv.block_size) + 1, "the prefix was re-decoded"
        srv.shutdown()
    assert got["torch"] == got["jax"] == _solo(model, pa, 20)


def test_cancel_of_replayed_request_targets_new_slot(model):
    """After a reset a replayed id is cancellable while re-queued (its
    completion carries the journaled prefix) and while re-admitted (the
    cancel reaches its new slot; the partial tokens are a prefix of the
    solo stream), and a cancel seals the journal."""
    pa, pc = _prompts(2, seed=313)
    got = {}
    for side, (make, Req) in _sides(model).items():
        srv = make()
        a = Req(prompt=pa, max_new_tokens=30)
        c = Req(prompt=pc, max_new_tokens=30)
        srv.submit(a)
        srv.submit(c)
        for _ in range(2):
            srv.step()
        srv.drain_completed()
        pre_a = list(srv._journal.get(a.id).emitted)
        pre_c = list(srv._journal.get(c.id).emitted)
        assert pre_a and pre_c
        assert srv.reset() == []
        assert a.id not in srv._slot_of and c.id not in srv._slot_of
        assert srv.cancel(c.id) is True
        srv.step()                  # re-admits a into a fresh slot
        assert a.id in srv._slot_of
        assert srv.cancel(a.id) is True
        done = srv.run_until_drained()
        assert done[c.id].finish_reason == "cancelled"
        assert done[c.id].tokens == pre_c
        assert done[a.id].finish_reason == "cancelled"
        toks = done[a.id].tokens
        assert toks[:len(pre_a)] == pre_a
        assert toks == _solo(model, pa, 30)[:len(toks)]
        assert srv._journal.get(a.id) is None
        got[side] = (toks, done[c.id].tokens)
        srv.shutdown()
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("blocks", [0, 8])
def test_replay_byte_identical_prefix_cache_on_and_off(model, blocks):
    """The re-prefill rides the prefix cache when it is on (the replayed
    context's chunks are ordinary trie blocks) and recomputes when it is
    off: the completions equal the uninterrupted streams either way."""
    pa, pc = _prompts(2, seed=317, lo=10, hi=14)   # >= 1 full chunk each
    got = {}
    for side, (make, Req) in _sides(model).items():
        srv = make(prefix_cache_blocks=blocks)
        a = Req(prompt=pa, max_new_tokens=24)
        c = Req(prompt=pc, max_new_tokens=24)
        srv.submit(a)
        srv.submit(c)
        for _ in range(3):
            srv.step()
        srv.drain_completed()
        assert srv.reset() == []
        done = srv.run_until_drained()
        got[side] = [done[a.id].tokens, done[c.id].tokens]
        assert srv.replays == 2
        srv.shutdown()
    assert got["torch"] == got["jax"] == [_solo(model, pa, 24),
                                          _solo(model, pc, 24)]


def test_replay_int8_kv_tolerance(model):
    """Replay across int8 KV: the resume prefix is kept verbatim and the
    continuation agrees with an uninterrupted int8 run in at least half
    the streams (the re-prefill writes through the quantized cache where
    the uninterrupted run decode-wrote, so a near-tie can flip)."""
    prompts = _prompts(4, seed=331)
    make, Req = _sides(model)["torch"]
    ref_srv = make(kv_dtype="int8")
    ref_reqs = [Req(prompt=p, max_new_tokens=12) for p in prompts]
    for r in ref_reqs:
        ref_srv.submit(r)
    ref_done = ref_srv.run_until_drained()
    refs = [ref_done[r.id].tokens for r in ref_reqs]
    srv = make(kv_dtype="int8")
    reqs = [Req(prompt=p, max_new_tokens=12) for p in prompts]
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


def test_journal_recovery_across_server_instances(tmp_path, model):
    """A file-backed journal written by one server is recovered by a
    fresh one (fresh ids, in the entries' order), which finishes the
    abandoned requests with the uninterrupted streams, on both
    frameworks; recovery is exempt from max_queue and compacts the file
    once the resubmissions are journaled."""
    pa, pb = _prompts(2, seed=337)
    got = {}
    for side, (make, Req) in _sides(model).items():
        mod = J if side == "torch" else jJ
        path = tmp_path / side / J.JOURNAL_FILE
        srv1 = make(journal=mod.RequestJournal(path))
        a = Req(prompt=pa, max_new_tokens=20)
        b = Req(prompt=pb, max_new_tokens=18)
        srv1.submit(a)
        srv1.submit(b)
        for _ in range(2):
            srv1.step()
        srv1.drain_completed()      # prefixes are journaled to disk
        # simulated SIGKILL: srv1 is abandoned mid-flight
        j2, entries = mod.RequestJournal.recover(path)
        assert [e.id for e in entries] == sorted([a.id, b.id])
        assert all(e.emitted for e in entries)
        srv2 = make(journal=j2, max_queue=1)
        assert srv2.recover_journal(entries) == 2
        assert srv2.max_queue == 1, "the bound must be restored after"
        done = srv2.run_until_drained()
        got[side] = [done[rid].tokens for rid in sorted(done)]
        assert srv2.replays == 2 and srv2.replayed_tokens > 0
        assert len(j2) == 0
        srv1.shutdown()
        srv2.shutdown()
        assert mod.read_journal(path) == []
    assert got["torch"] == got["jax"] == [_solo(model, pa, 20),
                                          _solo(model, pb, 18)]


def test_jax_journal_recovers_in_the_port(tmp_path, model):
    """The same unfinished journal, written by the JAX SlotServer and
    abandoned, recovered by the JAX server and by the port's: the same
    completions, equal to the uninterrupted streams."""
    prompts = _prompts(3, seed=337)
    make_j, JReq = _sides(model)["jax"]
    path = tmp_path / "dead" / J.JOURNAL_FILE
    dead = make_j(journal=jJ.RequestJournal(path))
    for p, m in zip(prompts, (20, 18, 9)):
        dead.submit(JReq(prompt=p, max_new_tokens=m))
    for _ in range(2):
        dead.step()
    dead.drain_completed()
    dead.shutdown()
    got = {}
    for side, (make, _) in _sides(model).items():
        mod = J if side == "torch" else jJ
        copy = tmp_path / side / J.JOURNAL_FILE
        copy.parent.mkdir()
        shutil.copy(path, copy)
        journal, entries = mod.RequestJournal.recover(copy)
        assert len(entries) == 3 and any(e.emitted for e in entries)
        srv = make(journal=journal)
        assert srv.recover_journal(entries) == 3
        done = srv.run_until_drained()
        got[side] = [done[rid].tokens for rid in sorted(done)]
        srv.shutdown()
    assert got["torch"] == got["jax"] == [
        _solo(model, p, m) for p, m in zip(prompts, (20, 18, 9))]


def test_checkpoint_progress_advances_journal_without_stall(model):
    """A solo open-loop request processes nothing until it completes;
    checkpoint_progress() processes the pipeline down to pipeline_depth,
    so the journal and progress() advance mid-request, and the stream is
    untouched."""
    pa = _prompts(1, seed=347)[0]
    mids = {}
    for side, (make, Req) in _sides(model).items():
        srv = make()
        a = Req(prompt=pa, max_new_tokens=24)
        srv.submit(a)
        for _ in range(5):
            srv.step()              # open loop: blocks pile up
        assert srv._journal.get(a.id).emitted == []
        assert len(srv._pipeline) > srv.pipeline_depth
        srv.checkpoint_progress()
        mid = list(srv._journal.get(a.id).emitted)
        assert mid
        assert len(srv._pipeline) == srv.pipeline_depth
        assert srv.progress(a.id) == {"tokens": mid,
                                      "prompt_tokens": len(pa)}
        done = srv.run_until_drained()
        ref = _solo(model, pa, 24)
        assert done[a.id].tokens == ref and mid == ref[:len(mid)]
        assert srv.progress(a.id) is None
        mids[side] = mid
        srv.shutdown()
    assert mids["torch"] == mids["jax"]


def test_fail_pending_seals_journal_entries(model):
    """When ServeApp fails its waiters (restart budget spent, drain
    deadline), their journal entries are sealed: a later recovery must
    not decode requests whose clients were told they failed."""
    for side, (make, Req) in _sides(model).items():
        srv = make()
        app = (ServeApp if side == "torch" else JServeApp)(srv)
        a = Req(prompt=[3, 1, 4], max_new_tokens=6)
        app._events[a.id] = threading.Event()
        srv.submit(a)
        assert srv._journal.get(a.id) is not None
        app._fail_pending(RuntimeError("budget exhausted"))
        assert srv._journal.get(a.id) is None, side
        assert app._events == {} and a.id in app._results
        srv.shutdown()


def test_expired_queued_replay_keeps_emitted_prefix(model):
    """A queued replay whose deadline passes before re-admission keeps
    its emitted prefix in the expired completion."""
    for side, (make, Req) in _sides(model).items():
        srv = make()
        r = Req(prompt=[3, 1, 4], max_new_tokens=8, resume_tokens=[9, 2, 6],
                deadline=time.monotonic() - 1.0)
        srv.submit(r)
        done = srv.run_until_drained()
        assert done[r.id].finish_reason == "expired"
        assert done[r.id].tokens == [9, 2, 6], side
        assert srv._journal.get(r.id) is None
        srv.shutdown()


def test_resume_already_satisfied_completes_without_slot(model):
    """A resume prefix that already satisfies its request (budget
    reached, a stop token at its end, a stop sequence) completes at
    submit: no slot, no prefill, no decode."""
    got = {}
    for side, (make, Req) in _sides(model).items():
        srv = make(stop_tokens=(9,), pad_id=255)
        r1 = Req(prompt=[1, 2], max_new_tokens=3, resume_tokens=[4, 5, 6, 7])
        r2 = Req(prompt=[1, 2], max_new_tokens=8, resume_tokens=[4, 9])
        r3 = Req(prompt=[1, 2], max_new_tokens=8, resume_tokens=[4, 5, 3],
                 stop=[5, 3])
        for r in (r1, r2, r3):
            srv.submit(r)
        done = srv.drain_completed()
        got[side] = [(done[r.id].tokens, done[r.id].finish_reason)
                     for r in (r1, r2, r3)]
        assert srv.blocks_dispatched == 0 and srv.admission_dispatches == 0
        assert srv.replays == 3 and srv.idle
        assert len(srv._journal) == 0
        srv.shutdown()
    assert got["torch"] == got["jax"] == [
        ([4, 5, 6], "length"), ([4, 9], "stop"), ([4, 5, 3], "stop")]


def _run_app(app, prompts, budget, spread=0.0):
    """Post every prompt from its own thread -> (results in order, the
    threads still alive)."""
    results = {}

    def call(i):
        try:
            results[i] = app.generate(prompts[i], budget, timeout=90)
        except Exception as e:
            results[i] = e

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
        time.sleep(spread)
    for t in threads:
        t.join(timeout=120)
    return results, [t for t in threads if t.is_alive()]


def test_crash_at_blocks_chaos_zero_failed_requests(model, monkeypatch):
    """TONY_TEST_SERVING_CRASH_AT_BLOCKS through ServeApp's recovery: two
    injected loop crashes, and every request completes with the tokens of
    the port's solo generate and of the JAX SlotServer, none failed."""
    monkeypatch.setenv("TONY_TEST_SERVING_CRASH_AT_BLOCKS", "2, 5")
    prompts = _prompts(4, seed=341)
    make, _ = _sides(model)["torch"]
    srv = make(max_queue=8)
    app = ServeApp(srv, max_loop_restarts=10, loop_backoff_s=0.01)
    app.start()
    try:
        results, hung = _run_app(app, prompts, 10)
        assert not hung
        for i, r in results.items():
            assert isinstance(r, S.Completion), f"request {i} failed: {r!r}"
            assert r.tokens == _solo(model, prompts[i], 10)
        assert srv.chaos_faults_injected == 2
        assert app.loop_restarts == 2 and srv.replays >= 1
        assert app.status != "down"
    finally:
        app.shutdown()
    monkeypatch.delenv("TONY_TEST_SERVING_CRASH_AT_BLOCKS")
    make_j, JReq = _sides(model)["jax"]
    jsrv = make_j()
    jreqs = [JReq(prompt=p, max_new_tokens=10) for p in prompts]
    for r in jreqs:
        jsrv.submit(r)
    jdone = jsrv.run_until_drained()
    jsrv.shutdown()
    assert [results[i].tokens for i in range(4)] == \
        [jdone[r.id].tokens for r in jreqs]


def test_chaos_seeded_every_request_terminates(model, monkeypatch):
    """Seeded dispatch-failure injection at a heavy rate: the loop
    recovers every time, every request terminates (a completion, a shed
    or an explicit error; none hangs), and every completion equals the
    uninterrupted stream. The chaos generator is the engine's own: the
    sampling generator's state is untouched."""
    monkeypatch.setenv("TONY_TEST_SERVING_DISPATCH_FAIL_RATE", "0.3")
    monkeypatch.setenv("TONY_TEST_SERVING_CHAOS_SEED", "42")
    prompts = _prompts(10, seed=263)
    make, _ = _sides(model)["torch"]
    srv = make(max_queue=8)
    gen_state = srv._gen.get_state()
    app = ServeApp(srv, max_loop_restarts=50, loop_backoff_s=0.01)
    app.start()
    try:
        results, hung = _run_app(app, prompts, 6, spread=0.01)
        assert not hung, f"{len(hung)} waiters hung under chaos"
        assert len(results) == len(prompts)
        completions = 0
        for i, r in results.items():
            if isinstance(r, S.Completion):
                completions += 1
                assert r.finish_reason == "length"
                assert r.tokens == _solo(model, prompts[i], 6)
            else:
                assert isinstance(r, (ServingLoopError, S.QueueFullError,
                                      TimeoutError)), r
        assert completions > 0
        assert srv.chaos_faults_injected >= 1 and app.loop_restarts >= 1
        assert app.status != "down"
        st = app.stats()
        assert st["resets"] == app.loop_restarts
        assert st["loop"]["failures"] == srv.chaos_faults_injected
        assert st["chaos_faults_injected"] == srv.chaos_faults_injected
        assert torch.equal(srv._gen.get_state(), gen_state)
    finally:
        app.shutdown()


def test_chaos_step_delay_and_bad_values(model, monkeypatch):
    """The step delay slows every turn; a malformed knob degrades to off
    (the server still serves), never a crash at construction."""
    monkeypatch.setenv("TONY_TEST_SERVING_STEP_DELAY_MS", "30")
    monkeypatch.setenv("TONY_TEST_SERVING_CRASH_AT_BLOCKS", "1,x")
    monkeypatch.setenv("TONY_TEST_SERVING_DISPATCH_FAIL_RATE", "lots")
    make, Req = _sides(model)["torch"]
    srv = make()
    assert srv._chaos_crash_blocks == set() and srv._chaos_fail_rate == 0
    r = Req(prompt=[5, 6, 7], max_new_tokens=4)
    srv.submit(r)
    t0 = time.perf_counter()
    srv.step()
    assert time.perf_counter() - t0 >= 0.03
    done = srv.run_until_drained()
    assert done[r.id].tokens == _solo(model, np.asarray([5, 6, 7]), 4)
    assert srv.chaos_faults_injected == 0
