"""The port's ``serve`` front door (tony_tpu_torch.cli.serve) on the CPU:
ServeApp + make_handler on an ephemeral port, mirroring the JAX package's
HTTP tests (tests/test_serving.py, tests/test_serving_robustness.py).

Completions are held against the JAX package's SlotServer on the same
weights (converted with ``from_jax_params``) and prompts, float32 at TINY
widths: greedy tokens identical (near-tie-free seeds, as in
tests/test_torch_serving.py)."""

import dataclasses
import json
import re
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu.models.serving import Request as JRequest
from tony_tpu.models.serving import SlotServer as JSlotServer
from tony_tpu_torch.cli import serve
from tony_tpu_torch.cli.serve import ServeApp, ServingLoopError
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.models.serving import Completion, Request, SlotServer

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=jnp.float32)


@pytest.fixture(scope="module")
def model():
    jcfg = jT.TransformerConfig(**TINY)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


def _prompts(n, seed, lo=2, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.int32)
            for _ in range(n)]


def _server(model, **kw):
    _, cfg, _, params = model
    kw = {"slots": 2, "max_len": 64, "block_size": 4, "prefill_chunk": 8,
          **kw}
    return SlotServer(params, cfg, device="cpu", **kw)


class _Http:
    """A ServeApp's handler on an ephemeral port, in a thread."""

    def __init__(self, app):
        self.httpd = serve.make_httpd(app, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def get(self, path):
        try:
            with urllib.request.urlopen(self.url + path, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def post(self, payload, raw=None):
        data = raw if raw is not None else json.dumps(payload).encode()
        try:
            with urllib.request.urlopen(self.url + "/generate", data=data,
                                        timeout=120) as r:
                return r.status, json.loads(r.read()), r.headers
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), e.headers

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_serve_http_end_to_end_matches_jax(model):
    """Four concurrent POST /generate requests through the ServeApp loop
    return the JAX SlotServer's completions; /stats reports the pool; a
    malformed body gets 400 and the service stays up."""
    jcfg, _, tree, _ = model
    app = ServeApp(_server(model))
    app.start()
    http = _Http(app)
    try:
        prompts = _prompts(4, seed=31)
        results = {}

        def post(i, p):
            results[i] = http.post({"prompt": [int(x) for x in p],
                                    "max_new_tokens": 5})

        threads = [threading.Thread(target=post, args=(i, p))
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        jsrv = JSlotServer(tree, jcfg, slots=2, max_len=64, block_size=4,
                           prefill_chunk=8)
        jreqs = [JRequest(prompt=p, max_new_tokens=5) for p in prompts]
        for r in jreqs:
            jsrv.submit(r)
        jdone = jsrv.run_until_drained()
        for i, jr in enumerate(jreqs):
            code, body, _ = results[i]
            assert code == 200
            assert body["finish_reason"] == "length"
            assert body["tokens"] == jdone[jr.id].tokens

        code, stats = http.get("/stats")
        assert code == 200 and stats["slots"] == 2 and stats["active"] == 0
        assert stats["admission_dispatches"] >= 1
        # "device" is the dispatch tracker's snapshot, as in the JAX
        # package; the torch device's name is "torch_device"
        assert stats["loop"]["status"] == "ok"
        assert stats["torch_device"] == "cpu" and stats["role"] == "both"
        assert set(stats["device"]) == {"in_flight", "tracked", "dropped",
                                        "reap_errors", "dispatch_ready"}
        assert stats["device"]["tracked"] > 0
        assert http.get("/healthz") == (200, {
            "healthy": True, "status": "ok", "error": None,
            "loop_restarts": 0})
        assert http.get("/nope")[0] == 404
        for raw in (b'{"max_new_tokens": 5}', b"not json", b"[1, 2]",
                    b'{"prompt": "abc"}', b'{"prompt": [1], "stream": "yes"}',
                    b'{"prompt": [1], "timeout_s": "NaN"}',
                    b'{"prompt": [1], "priority": "x"}',
                    b'{"prompt": [1], "resume_tokens": 2}',
                    b'{"prompt": [1], "resume_tokens": ["a"]}',
                    b'{"prompt": [1, 999], "max_new_tokens": 2}',
                    b'{"prompt": [1], "logprobs": false}',
                    b'{"prompt": [1], "logprobs": 0.0}',
                    b'{"prompt": [1], "cache_prompt": "false"}',
                    b'{"prompt": [1], "progress_key": 5}'):
            code, body, _ = http.post(None, raw=raw)
            assert code == 400, raw
            assert "error" in body
        # the JAX package's messages for the bodies it rejects
        for raw, msg in (
                (b'{"prompt": [1], "logprobs": false}',
                 "logprobs must be an integer"),
                (b'{"prompt": [1], "cache_prompt": "false"}',
                 "cache_prompt must be a JSON boolean"),
                (b'{"prompt": [1], "progress_key": 5}',
                 "progress_key must be a string"),
                (b'{"prompt": [1], "resume_tokens": 2}',
                 "resume_tokens must be a JSON list of ints")):
            code, body, _ = http.post(None, raw=raw)
            assert code == 400 and re.search(msg, body["error"]), raw
        assert http.post({"prompt": [3], "max_new_tokens": 2,
                          "logprobs": None, "cache_prompt": True})[0] == 200
        # a resume prefix is part of the completion; a string progress
        # key is accepted (GET /progress has it only while it runs)
        code, body, _ = http.post({"prompt": [3], "max_new_tokens": 3,
                                   "resume_tokens": [2],
                                   "progress_key": "k"})
        assert code == 200 and body["tokens"][0] == 2
        assert len(body["tokens"]) == 3
        assert http.get("/progress?key=k") == (200, {})
        code, body, _ = http.post({"prompt": [3, 4], "max_new_tokens": 2})
        assert code == 200 and len(body["tokens"]) == 2
    finally:
        http.close()
        app.shutdown()


def test_serve_http_429_when_the_queue_is_full(model):
    """With the wait queue at max_queue, the next POST is shed with 429 +
    Retry-After, while the queued request is served once admission runs."""
    srv = _server(model, max_queue=1)
    srv.pause_admission = True      # hold the queue seat for the probe
    app = ServeApp(srv)
    app.start()
    http = _Http(app)
    try:
        res = {}
        t = threading.Thread(target=lambda: res.update(first=http.post(
            {"prompt": [1, 2, 3], "max_new_tokens": 3})))
        t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and srv.pending < 1:
            time.sleep(0.002)
        assert srv.pending == 1
        code, body, headers = http.post({"prompt": [1], "max_new_tokens": 2})
        assert code == 429 and "queue full" in body["error"]
        assert int(headers["Retry-After"]) >= 1
        srv.pause_admission = False
        t.join(timeout=60)
        assert not t.is_alive() and res["first"][0] == 200
        assert app.stats()["shed"] == 1
    finally:
        http.close()
        app.shutdown()


class _ExplodingServer:
    """SlotServer stand-in whose step() dies once a request is in."""
    slots, max_len, block_size = 1, 32, 4
    n_active, pending = 0, 0
    admission_dispatches = blocks_dispatched = 0
    pause_admission = False

    def __init__(self):
        self.idle = True

    def submit(self, req):
        self.idle = False
        return req.id

    def step(self):
        raise RuntimeError("CUDA error: device lost")

    def stats(self):
        return {"slots": self.slots}

    def fail_queued(self):
        return []

    def shutdown(self):
        pass


def test_serve_loop_failure_fails_pending_and_healthz():
    """A failing engine with no reset(): waiters get 503 at once (not at
    their timeouts), /healthz answers 503 with the cause, and new
    submissions raise ServingLoopError."""
    app = ServeApp(_ExplodingServer())
    app.start()
    http = _Http(app)
    try:
        assert http.get("/healthz")[0] == 200
        code, body, _ = http.post({"prompt": [1], "max_new_tokens": 4})
        assert code == 503 and "device lost" in body["error"]
        code, body = http.get("/healthz")
        assert code == 503 and body["status"] == "down"
        assert "device lost" in body["error"]
        with pytest.raises(ServingLoopError):
            app.generate([1], 4, timeout=5)
        code, body, _ = http.post({"prompt": [1], "max_new_tokens": 4})
        assert code == 503
    finally:
        http.close()
        app.shutdown()


def test_loop_failure_resets_the_engine_and_recovers(model):
    """A step failure on a real engine: reset() replays the in-flight
    request (it completes with an undisturbed run's tokens), the loop
    restarts, and the next request is served. Under replay=False the
    in-flight request fails instead."""
    ref = _server(model)
    rid = ref.submit(Request(prompt=[5, 6, 7], max_new_tokens=40))
    want = ref.run_until_drained()[rid].tokens
    for replay in (True, False):
        srv = _server(model, replay=replay)
        real_step = srv.step
        calls = {"n": 0}

        def flaky_step():
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected step failure")
            real_step()

        srv.step = flaky_step
        app = ServeApp(srv, loop_backoff_s=0.01)
        app.start()
        try:
            if replay:
                comp = app.generate([5, 6, 7], 40, timeout=60)
                assert comp.tokens == want and srv.replays == 1
            else:
                with pytest.raises(ServingLoopError, match="injected"):
                    app.generate([5, 6, 7], 40, timeout=60)
            comp = app.generate([5, 6, 7], 3, timeout=60)
            assert comp.finish_reason == "length" and comp.tokens == want[:3]
            h = app.health()
            assert h["status"] == "ok" and h["loop_restarts"] == 1
            assert srv.resets == 1
        finally:
            app.shutdown()


def test_busy_loop_hands_the_lock_over(model):
    """While the engine is busy, each turn's end hands the lock to the
    threads waiting for it: a submission and /stats are served between
    two turns, not once the engine goes idle."""
    srv = _server(model, max_len=64)
    real_step = srv.step

    def slow_step():
        # a turn that holds the interpreter, as an eager dispatch does
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.05:
            pass
        real_step()

    srv.step = slow_step
    app = ServeApp(srv)
    app.start()
    try:
        rid, ev = app.submit_async([1, 2, 3], 40)   # 10 blocks: >= 0.5 s
        assert _wait(lambda: srv.blocks_dispatched >= 1)
        waits = []
        for _ in range(3):
            t0 = time.perf_counter()
            app.stats()
            rid2, _ = app.submit_async([4, 5], 2)
            waits.append(time.perf_counter() - t0)
        assert not ev.is_set(), "the probe ran after the request finished"
        assert max(waits) < 0.3, waits
        assert ev.wait(60) and app.take_result(rid).tokens
    finally:
        app.shutdown()


def test_drain_shutdown_finishes_inflight_fails_queued(model):
    """shutdown(drain=True): the in-flight requests finish token-identical
    to an undisturbed server, the queued one fails with a clear error, and
    new submissions are rejected while draining."""
    pa, pc, pb = _prompts(3, seed=251)
    srv = _server(model)
    app = ServeApp(srv)            # loop NOT started yet
    res = {}

    def call(name, prompt, budget):
        try:
            res[name] = app.generate(prompt, budget, timeout=60)
        except Exception as e:
            res[name] = e

    t_a = threading.Thread(target=call, args=("a", pa, 24))
    t_c = threading.Thread(target=call, args=("c", pc, 24))
    t_a.start()
    t_c.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and srv.pending < 2:
        time.sleep(0.002)
    assert srv.pending == 2
    srv.step()                     # admit both into the 2 slots, block 1
    assert srv.n_active == 2
    srv.pause_admission = True
    t_b = threading.Thread(target=call, args=("b", pb, 4))
    t_b.start()
    while time.monotonic() < deadline and srv.pending < 1:
        time.sleep(0.002)
    assert srv.pending == 1
    app.start()
    app.shutdown(drain=True, drain_timeout_s=60)
    for t in (t_a, t_c, t_b):
        t.join(timeout=30)
        assert not t.is_alive(), "drain left a hung waiter"
    ref = _server(model)
    want = {}
    for name, p in (("a", pa), ("c", pc)):
        want[name] = ref.submit(Request(prompt=p, max_new_tokens=24))
    done = ref.run_until_drained()
    for name in ("a", "c"):
        assert isinstance(res[name], Completion)
        assert res[name].tokens == done[want[name]].tokens
    assert isinstance(res["b"], ServingLoopError)
    assert "shutting down" in str(res["b"])
    with pytest.raises(ServingLoopError, match="draining"):
        app.generate(pb, 4, timeout=5)
    h = app.health()
    assert h["healthy"] is False and h["status"] == "draining"


TINY_FLAGS = ["--device", "cpu", "--d-model", "32", "--n-layers", "1",
              "--n-heads", "2", "--d-ff", "64", "--vocab", "64",
              "--dtype", "float32", "--slots", "2", "--max-len", "32",
              "--block-size", "4", "--prefill-chunk", "8"]


def test_cli_builds_the_app_from_its_flags():
    args = serve.build_argparser().parse_args(
        TINY_FLAGS + ["--max-queue", "3", "--per-slot-admission",
                      "--stop-tokens", "5 9", "--loop-max-restarts", "2"])
    app = serve.build_app(args)
    srv = app.server
    assert (srv.slots, srv.max_len, srv.block_size, srv.prefill_chunk) == \
        (2, 32, 4, 8)
    assert srv.max_queue == 3 and not srv.batched_admission
    assert srv.stop_tokens == (5, 9) and app.max_loop_restarts == 2
    assert srv.device == torch.device("cpu")
    app.start()
    try:
        comp = app.generate([1, 2, 3], 4, timeout=60)
        assert 1 <= len(comp.tokens) <= 4
        assert all(0 <= t < 64 for t in comp.tokens)
    finally:
        app.shutdown()
    # the same seed gives the same weights
    a = serve.load_model(args)[0]["embed"]
    assert torch.equal(a, serve.load_model(args)[0]["embed"])


def test_serve_prefix_cache_flags_and_stats():
    """--prefix-cache-blocks: a shared prefix hits on the second request
    and /stats reports the prefix cache; with --no-cache-prompts a prompt
    goes into the cache only when its body sets "cache_prompt": true."""
    prefix = list(range(1, 17))             # two chunks of 8
    for extra, cache_first in (([], None), (["--no-cache-prompts"], True)):
        args = serve.build_argparser().parse_args(
            TINY_FLAGS + ["--prefix-cache-blocks", "4"] + extra)
        app = serve.build_app(args)
        assert app.server.cache_prompts is not bool(extra)
        app.start()
        http = _Http(app)
        try:
            if extra:       # not inserted: the next request misses
                assert http.post({"prompt": prefix + [20],
                                  "max_new_tokens": 3})[0] == 200
                assert http.get("/stats")[1]["prefix_cache"][
                    "inserted_blocks"] == 0
            first = {"prompt": prefix + [21], "max_new_tokens": 3}
            if cache_first is not None:
                first["cache_prompt"] = cache_first
            assert http.post(first)[0] == 200
            code, body, _ = http.post({"prompt": prefix + [22],
                                       "max_new_tokens": 3})
            assert code == 200 and len(body["tokens"]) == 3
            code, stats = http.get("/stats")
            pc = stats["prefix_cache"]
            assert code == 200 and pc["hits"] == 1 and pc["blocks_total"] == 4
            assert pc["inserted_blocks"] == 2
            assert stats["prefill_tokens_reused"] == 16
        finally:
            http.close()
            app.shutdown()


@pytest.mark.parametrize("flags,what", [
    (["--mesh", "tensor=2"], "TP decode and serving"),
])
def test_cli_flags_not_yet_ported(flags, what):
    """Flags whose ROADMAP.md queue-1 item (``what``) is ported now raise
    the JAX package's refusals: ``--mesh`` serves one model without a
    draft."""
    for extra in (["--model", "a=random:1", "--model", "b=random:2"],
                  ["--draft-model", "random:5"]):
        with pytest.raises(SystemExit,
                           match="--mesh serves a single model without"):
            serve.main(TINY_FLAGS + flags + extra)


def _wait(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("flag", ["--trace-dir", "--no-replay",
                                  "--journal-checkpoint-s"])
def test_cli_journal_flags(flag, tmp_path, monkeypatch):
    """The journal flags as the JAX package's serve has them:
    --trace-dir puts the journal in <dir>/requests.journal.jsonl and a
    new app recovers and finishes what an abandoned one left there;
    --no-replay runs without a journal (a loop crash fails the in-flight
    request; the checkpoint cadence is forced to 0); and
    --journal-checkpoint-s sets the cadence at which /progress advances
    while a request decodes."""
    from tony_tpu_torch.events import JOURNAL_FILE, read_journal

    extra = {"--trace-dir": ["--trace-dir", str(tmp_path)],
             "--no-replay": ["--no-replay", "--journal-checkpoint-s", "0.5"],
             "--journal-checkpoint-s": ["--journal-checkpoint-s", "0.01"]}
    args = serve.build_argparser().parse_args(TINY_FLAGS + extra[flag])
    if flag == "--journal-checkpoint-s":
        # slow turns, so the request is still decoding between polls
        monkeypatch.setenv("TONY_TEST_SERVING_STEP_DELAY_MS", "100")
    app = serve.build_app(args)
    srv = app.server
    if flag == "--trace-dir":
        path = tmp_path / JOURNAL_FILE
        assert srv._journal.path == path
        # an abandoned request: journaled, never served
        srv.submit(Request(prompt=[1, 2, 3], max_new_tokens=6))
        srv.step()
        srv.checkpoint_progress()
        left = read_journal(path)
        assert len(left) == 1
        app2 = serve.build_app(args)
        assert app2.server.pending == 1
        assert [e.id for e in read_journal(path)] != [left[0].id]
        app2.start()
        try:
            assert _wait(lambda: app2.stats()["replays"] == 1
                         and app2.server.idle)
            st = app2.stats()
            assert st["journal"] == {"entries": 0, "durable": True,
                                     "write_errors": 0, "compactions": 1,
                                     "replay": True}
        finally:
            app2.shutdown()
        assert read_journal(path) == []
        return
    app.start()
    http = _Http(app)
    try:
        if flag == "--no-replay":
            assert not srv.replay and app.journal_checkpoint_s == 0.0
            assert "journal" not in app.stats()
            real_step, crashed = srv.step, []

            def step_then_crash_once():
                real_step()         # the request is admitted: in flight
                if not crashed:
                    crashed.append(1)
                    raise RuntimeError("boom")

            srv.step = step_then_crash_once
            code, body, _ = http.post({"prompt": [1, 2], "max_new_tokens": 4})
            assert code == 503 and "lost" in body["error"]
            code, body, _ = http.post({"prompt": [1, 2], "max_new_tokens": 4})
            assert code == 200 and len(body["tokens"]) == 4
            assert app.health()["loop_restarts"] == 1 and srv.replays == 0
            return
        assert app.journal_checkpoint_s == 0.01
        res = {}
        t = threading.Thread(target=lambda: res.update(r=http.post(
            {"prompt": [4, 5, 6], "max_new_tokens": 24,
             "progress_key": "p1"})))
        t.start()
        seen = []
        while t.is_alive():
            got = http.get("/progress?keys=p1,nope")[1].get("p1")
            if got:
                seen.append(got["tokens"])
            time.sleep(0.01)
        t.join()
        code, body, _ = res["r"]
        assert code == 200 and len(body["tokens"]) == 24
        mid = [s for s in seen if 0 < len(s) < 24]
        assert mid, "the journal never advanced mid-request"
        assert all(body["tokens"][:len(s)] == s for s in seen)
        assert http.get("/progress?key=p1") == (200, {})
    finally:
        http.close()
        app.shutdown()


def test_progress_keys_evict_finished_requests_first(model):
    """The key registry is capped: finished requests' keys go first, the
    oldest first, so a long-running request keeps its key."""
    srv = _server(model)
    app = ServeApp(srv)
    app._progress_keys_cap = 3
    live, _ = app.submit_async([1, 2, 3], 8, progress_key="live")
    for k in ("a", "b"):
        rid, _ = app.submit_async([4, 5], 2, progress_key=k)
        srv.cancel(rid)             # finished: its journal entry sealed
    app.submit_async([6], 2, progress_key="c")
    assert list(app._progress_keys) == ["live", "b", "c"]
    assert set(app.progress(["live", "b", "c", "x"])) == {"live", "c"}
    app.submit_async([7], 2, progress_key="d")
    assert list(app._progress_keys) == ["live", "c", "d"]
    assert app.progress(["live"]) == {
        "live": {"tokens": [], "prompt_tokens": 3}}
    srv.shutdown()


def test_serve_cli_sigkill_restart_recovers_journal(tmp_path):
    """A serve process on the CPU with --trace-dir SIGKILLs itself at a
    decode block (TONY_TEST_SERVING_SIGKILL_AT_BLOCK); the same command
    run again prints how many requests it resumed from the journal,
    finishes them (/stats: replays, an empty journal) and compacts the
    file to no live entry."""
    import os
    import re
    import signal
    import subprocess
    import sys

    from tony_tpu_torch.events import JOURNAL_FILE, read_journal

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = [sys.executable, "-m", "tony_tpu_torch.cli.serve", "--port", "0",
            "--device", "cpu", "--vocab", "256", "--d-model", "64",
            "--n-layers", "2", "--n-heads", "4", "--d-ff", "128",
            "--dtype", "float32", "--slots", "2", "--max-len", "64",
            "--block-size", "4", "--prefill-chunk", "8",
            "--journal-checkpoint-s", "0", "--trace-dir", str(tmp_path)]

    def spawn(extra_env):
        return subprocess.Popen(argv, cwd=repo, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env={**os.environ, **extra_env})

    def await_port(proc, lines):
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            m = re.search(r"http://[\d.]+:(\d+)", line or "")
            if m:
                threading.Thread(target=proc.stdout.read,
                                 daemon=True).start()
                return int(m.group(1))
            if not line and proc.poll() is not None:
                break
        raise AssertionError(f"serve never printed its port: {lines}")

    lines = []
    # slow turns, so both requests are in before block 3
    proc = spawn({"TONY_TEST_SERVING_SIGKILL_AT_BLOCK": "3",
                  "TONY_TEST_SERVING_STEP_DELAY_MS": "50"})
    try:
        port = await_port(proc, lines)
        errors = []

        def post(p):
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/generate",
                    data=json.dumps({"prompt": p, "max_new_tokens": 20})
                    .encode(), timeout=60).read()
            except Exception as e:  # the process dies under the request
                errors.append(e)

        posts = [threading.Thread(target=post, args=(p,))
                 for p in ([3, 1, 4, 1, 5], [2, 7, 1, 8])]
        for t in posts:
            t.start()
        assert proc.wait(timeout=60) == -signal.SIGKILL
        for t in posts:
            t.join(timeout=30)
        assert len(errors) == 2
    finally:
        if proc.poll() is None:
            proc.kill()
    left = read_journal(tmp_path / JOURNAL_FILE)
    assert 1 <= len(left) <= 2
    lines = []
    proc2 = spawn({})
    try:
        port2 = await_port(proc2, lines)
        assert any(f"journal recovery: resumed {len(left)} unfinished "
                   "request(s)" in x for x in lines), lines
        st = None

        def finished():
            nonlocal st
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port2}/stats", timeout=10) as r:
                st = json.loads(r.read())
            return (st["replays"] >= len(left)
                    and st["journal"]["entries"] == 0
                    and st["active"] == 0 and st["queued"] == 0)

        assert _wait(finished, timeout=60), st
        assert st["journal"]["durable"] and st["replayed_tokens"] == sum(
            len(e.emitted) for e in left)
    finally:
        proc2.send_signal(signal.SIGTERM)
        try:
            proc2.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc2.kill()
    assert read_journal(tmp_path / JOURNAL_FILE) == []


def test_serving_needs_a_card_unless_told_otherwise(model, monkeypatch):
    _, cfg, _, params = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotServer(params, cfg)
    args = serve.build_argparser().parse_args(
        [f for f in TINY_FLAGS if f not in ("--device", "cpu")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_app(args)
