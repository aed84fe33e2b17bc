"""The port's device-time layer on the CPU, against the JAX package's:
``tony_tpu_torch.observability.DispatchTracker``, the serving engine's
fences and device lag, and serve's GET /debug/profile.

- The tracker cases of tests/test_device_time.py:66-198 run the same stub
  sequences through both packages' trackers: the reference's assertions
  hold on the port's, and the two snapshots (counters, each kind's count)
  are equal. The stub fences are the reference's (a ``threading.Event``
  behind ``block_until_ready``); on the card the engine's fences wait on
  CUDA events, which chip_smoke.py checks.
- /debug/profile: tests/test_device_time.py:429 with ``torch.profiler``
  stubbed, and one real CPU capture whose Chrome-trace JSON parses.
- The engine: each dispatch site registers its kind as the JAX engine's
  does, for the same requests, the counts are the engine's dispatch
  counters, every processed block feeds ``device_lag_s`` and the traces
  carry it; ``reset()`` re-arms the same thread and ``shutdown()`` stops
  it."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from tony_tpu.models import serving as jS
from tony_tpu.models import transformer as jT
from tony_tpu.observability import DispatchTracker as JTracker
from tony_tpu_torch import constants as c
from tony_tpu_torch.cli import serve
from tony_tpu_torch.cli.serve import ServeApp
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.observability import DispatchTracker

TRACKERS = {"port": DispatchTracker, "jax": JTracker}
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=jax.numpy.float32)
SRV = dict(slots=2, max_len=64, block_size=4, prefill_chunk=8)


class _Buf:
    """Stub fence: block_until_ready() waits on an Event (or raises, as a
    failed dispatch's would)."""

    def __init__(self, ready: bool = True, raises: bool = False):
        self.ev = threading.Event()
        if ready:
            self.ev.set()
        self.raises = raises

    def block_until_ready(self):
        if self.raises:
            raise RuntimeError("fence of a failed dispatch")
        assert self.ev.wait(10), "stub fence never released"


def _reaper_count():
    return sum(1 for t in threading.enumerate()
               if t.name == "dispatch-reaper" and t.is_alive())


def _summary(tr) -> dict:
    snap = tr.snapshot()
    return {"in_flight": snap["in_flight"], "tracked": snap["tracked"],
            "dropped": snap["dropped"], "reap_errors": snap["reap_errors"],
            "counts": {k: h["count"]
                       for k, h in snap["dispatch_ready"].items()}}


def _both(scenario) -> dict:
    """Run ``scenario(tracker_class)`` on both packages' trackers -> the
    port's result, after checking it equals the JAX package's."""
    got = {name: scenario(cls) for name, cls in TRACKERS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


def _wait_busy(tr):
    """Until the reaper waits on an entry and the queue is empty, so an
    overflow count does not depend on the reaper's timing."""
    deadline = time.monotonic() + 10
    while not (tr._busy and not tr._queue):
        assert time.monotonic() < deadline, "the reaper never took the gate"
        time.sleep(0.001)


# --------------------------------------------------------------------------
# DispatchTracker (tests/test_device_time.py:66-198)
# --------------------------------------------------------------------------

def test_dispatch_tracker_orders_and_histograms_per_kind():
    def scenario(cls):
        tr = cls()
        try:
            bufs = [_Buf(ready=False) for _ in range(3)]
            seqs = [tr.track("prefill", bufs[0]),
                    tr.track("decode_block", bufs[1]),
                    tr.track("decode_block", bufs[2])]
            assert seqs == sorted(seqs), "sequence numbers must be monotone"
            assert tr.in_flight == 3
            for b in bufs:          # released in dispatch order
                b.ev.set()
            assert tr.drain(timeout=10)
            assert tr.in_flight == 0
            assert tr.tracked_total == 3 and tr.dropped == 0
            times = [tr.ready_time(s) for s in seqs]
            assert all(t is not None for t in times)
            assert times == sorted(times)
            assert tr.histograms()["decode_block"].count == 2
            return _summary(tr)
        finally:
            tr.shutdown()

    assert _both(scenario)["counts"] == {"prefill": 1, "decode_block": 2}


def test_dispatch_tracker_ready_time_lookup_rules():
    def scenario(cls):
        tr = cls()
        try:
            seq = tr.track("decode_block", _Buf())
            assert tr.drain(timeout=10)
            t0 = tr.ready_time(seq)
            assert t0 is not None and t0 <= time.monotonic()
            assert tr.ready_time(seq + 1000) is None     # never tracked
            tr.READY_KEEP = 4                            # eviction
            seqs = [tr.track("decode_block", _Buf()) for _ in range(8)]
            assert tr.drain(timeout=10)
            assert tr.ready_time(seqs[0]) is None, "evicted entry"
            assert tr.ready_time(seqs[-1]) is not None
            slow = _Buf(ready=False)                     # the timeout path
            seq2 = tr.track("decode_block", slow)
            threading.Timer(0.05, slow.ev.set).start()
            assert tr.ready_time(seq2, timeout=5.0) is not None
            assert tr.drain(timeout=10)
            return _summary(tr)
        finally:
            tr.shutdown()

    assert _both(scenario)["tracked"] == 10


def test_dispatch_tracker_overflow_drops_telemetry_only():
    def scenario(cls):
        tr = cls(max_pending=2)
        try:
            gate = _Buf(ready=False)                     # wedges the reaper
            tr.track("prefill", gate)
            _wait_busy(tr)
            for _ in range(4):
                tr.track("prefill", _Buf())
            assert tr.dropped >= 2, "overflow must drop, not grow"
            assert tr.in_flight <= tr.max_pending + 1
            gate.ev.set()
            assert tr.drain(timeout=10)
            assert tr.tracked_total + tr.dropped == 5
            return _summary(tr)
        finally:
            tr.shutdown()

    assert _both(scenario)["dropped"] == 2


def test_dispatch_tracker_tolerates_dead_buffers():
    def scenario(cls):
        tr = cls()
        try:
            tr.track("prefill", _Buf(raises=True))
            tr.track("decode_block", _Buf())
            tr.track("paged_scatter", object())          # no method at all
            assert tr.drain(timeout=10)
            assert tr.alive, "a dead fence must not kill the reaper"
            assert "prefill" not in tr.snapshot()["dispatch_ready"]
            return _summary(tr)
        finally:
            tr.shutdown()

    got = _both(scenario)
    assert got["reap_errors"] == 2 and got["counts"] == {"decode_block": 1}


def test_dispatch_tracker_reset_rearms_without_blocking_or_leaking():
    def scenario(cls):
        n0 = _reaper_count()
        tr = cls()
        assert _reaper_count() == n0 + 1
        thread = tr._thread
        done = tr.track("decode_block", _Buf())
        assert tr.drain(timeout=10)
        assert tr.ready_time(done) is not None
        stale = _Buf(ready=False)                       # pending at reset
        stale_seq = tr.track("decode_block", stale)
        t0 = time.monotonic()
        tr.reset()                      # must not wait on the pending one
        assert time.monotonic() - t0 < 1.0
        assert tr._thread is thread and tr.alive
        assert _reaper_count() == n0 + 1
        assert tr.ready_time(done) is None, "a ready instant crossed reset"
        before = tr.snapshot()["dispatch_ready"]["decode_block"]["count"]
        stale.ev.set()                  # the pre-reset dispatch ends late
        fresh = tr.track("decode_block", _Buf())
        assert tr.drain(timeout=10)
        assert tr.ready_time(fresh) is not None
        assert tr.ready_time(stale_seq) is None
        after = tr.snapshot()["dispatch_ready"]["decode_block"]["count"]
        assert after == before + 1, "only the post-reset dispatch counts"
        out = _summary(tr)
        tr.shutdown()
        assert _reaper_count() == n0 and not tr.alive
        return out

    assert _both(scenario)["counts"] == {"decode_block": 2}


def test_dispatch_tracker_shutdown_idempotent():
    def scenario(cls):
        tr = cls()
        pending = _Buf(ready=False)
        tr.track("prefill", pending)
        tr.shutdown()                   # must not wait on the wedge
        assert not tr.alive
        tr.shutdown()
        before = tr.tracked_total
        tr.track("prefill", _Buf())     # after shutdown: a seq, no entry
        assert tr.tracked_total == before
        pending.ev.set()
        return tr.tracked_total, tr.dropped

    assert _both(scenario) == (1, 0)


def test_fence_off_the_card_is_complete():
    """On the CPU a dispatch has run when its call returns: no event, and
    the fence's wait returns at once."""
    import torch

    assert S._event(torch.device("cpu")) is None
    f = S._Fence(S._event(torch.device("cpu")))
    t0 = time.monotonic()
    f.block_until_ready()
    assert time.monotonic() - t0 < 0.1


# --------------------------------------------------------------------------
# serve's /debug/profile (tests/test_device_time.py:429)
# --------------------------------------------------------------------------

class _StubEngine:
    """Enough of an engine for ServeApp's construction; the loop never
    starts, only the profile surface runs."""
    trace_sink = None

    def shutdown(self):
        pass


class _StubProfile:
    """torch.profiler.profile's surface as serve's capture uses it."""

    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


def test_debug_profile_http_smoke(tmp_path, monkeypatch):
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", _StubProfile)
    app = ServeApp(_StubEngine(), trace_dir=str(tmp_path))
    httpd = serve.make_httpd(app, "127.0.0.1", 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/profile?seconds=0.01",
                timeout=10) as r:
            out = json.loads(r.read())
        assert out["seconds"] == 0.01
        assert out["files"], "a capture lists its files"
        assert all(f.endswith(".json") for f in out["files"])
        assert out["dir"].startswith(str(tmp_path))
        assert f"/{c.PROFILE_DIR_NAME}/" in out["dir"] + "/"
        for bad in ("9999", "0", "-1", "nan"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/debug/profile?seconds={bad}",
                    timeout=10)
            assert e.value.code == 400, bad
        assert app._profile_lock.acquire(blocking=False)
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/debug/profile?seconds=0.01",
                    timeout=10)
            assert e.value.code == 409
        finally:
            app._profile_lock.release()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert c.PROFILE_DIR_NAME == "profiles"
    bare = ServeApp(_StubEngine())
    with pytest.raises(RuntimeError, match="trace-dir"):
        bare.capture_profile(1.0)


# --------------------------------------------------------------------------
# the engine's fences and device lag
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jT.TransformerConfig(**TINY)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


def _prompts(n, seed, tmpl=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 256, tmpl, dtype=np.int32)
    return [np.concatenate([head, rng.integers(0, 256, int(k),
                                               dtype=np.int32)])
            for k in rng.integers(2, 14, n)]


MODES = {
    "ring": {},
    "eos": {"stop_tokens": (7,)},
    "prefix": {"prefix_cache_blocks": 8},
    "paged": {"paged": True},
    "paged_interleaved": {"paged": True, "prefill_interleave": 8},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_tracks_every_dispatch_like_jax(model, mode):
    """The same requests through the port's engine and the JAX package's:
    the tracked kinds and their counts are equal, each count is the port
    engine's own dispatch counter, nothing dropped, no reap error,
    nothing in flight after the drain; every processed block fed
    ``device_lag_s``, and each completion's trace carries its lag."""
    jcfg, cfg, tree, params = model
    kw = {**SRV, **MODES[mode]}
    prompts = _prompts(5, seed=3, tmpl=16 if mode == "prefix" else 0)
    srv = S.SlotServer(params, cfg, device="cpu", **kw)
    jsrv = jS.SlotServer(tree, jcfg, **kw)
    try:
        for eng, Req in ((srv, S.Request), (jsrv, jS.Request)):
            for p in prompts:
                eng.submit(Req(prompt=p, max_new_tokens=9))
            done = eng.run_until_drained()
            assert len(done) == len(prompts)
            assert eng.dispatch_tracker.drain(timeout=10)
            if eng is srv:
                comps = done
        ours, ref = _summary(srv.dispatch_tracker), \
            _summary(jsrv.dispatch_tracker)
    finally:
        srv.shutdown()
        jsrv.shutdown()
    assert ours == ref
    counts = ours["counts"]
    want = {"prefill": srv.admission_dispatches,
            "decode_block": srv.blocks_dispatched,
            "paged_scatter": srv.paged_scatter_dispatches,
            "prefix_copy": srv.prefix_copy_dispatches,
            "prefix_insert": srv.prefix_insert_dispatches}
    assert counts == {k: n for k, n in want.items() if n}
    if mode == "prefix":
        assert counts["prefix_copy"] and counts["prefix_insert"]
    assert ours["tracked"] == sum(counts.values())
    assert (ours["in_flight"], ours["dropped"], ours["reap_errors"]) == \
        (0, 0, 0)
    lag = srv.telemetry.hist["device_lag_s"]
    assert lag.count == srv.blocks_dispatched
    for comp in comps.values():
        attrs = comp.trace["attrs"]
        assert attrs["device_lag_s"] >= 0
        assert attrs["device_lag_first_token_s"] >= 0


def test_engine_reset_keeps_one_reaper_and_shutdown_stops_it(model):
    """reset() (the loop's recovery) re-arms the engine's tracker on the
    same thread and keeps its histograms; shutdown() stops the thread, so
    servers built and shut down leak none."""
    _, cfg, _, params = model
    n0 = _reaper_count()
    srv = S.SlotServer(params, cfg, device="cpu", **SRV)
    thread = srv.dispatch_tracker._thread
    for p in _prompts(3, seed=5):
        srv.submit(S.Request(prompt=p, max_new_tokens=6))
    srv.run_until_drained()
    assert srv.dispatch_tracker.drain(timeout=10)
    before = srv.stats()["device"]["dispatch_ready"]["decode_block"]["count"]
    srv.reset()
    assert srv.dispatch_tracker._thread is thread
    assert srv.dispatch_tracker.alive and _reaper_count() == n0 + 1
    assert srv.stats()["device"]["dispatch_ready"]["decode_block"][
        "count"] == before
    srv.submit(S.Request(prompt=_prompts(1, seed=6)[0], max_new_tokens=6))
    srv.run_until_drained()
    assert srv.dispatch_tracker.drain(timeout=10)
    assert srv.stats()["device"]["dispatch_ready"]["decode_block"][
        "count"] > before
    srv.shutdown()
    srv.shutdown()
    assert not srv.dispatch_tracker.alive and _reaper_count() == n0


def test_debug_profile_captures_live_serving_on_the_cpu(model, tmp_path):
    """A real capture (torch.profiler, host activity on the CPU) while the
    loop serves: the file is Chrome-trace JSON with events, and the
    requests all finish."""
    _, cfg, _, params = model
    app = ServeApp(S.SlotServer(params, cfg, device="cpu", **SRV),
                   trace_dir=str(tmp_path))
    app.start()
    try:
        results = []
        worker = threading.Thread(target=lambda: results.extend(
            app.generate(p, 12, timeout=60) for p in _prompts(3, seed=8)))
        worker.start()
        out = app.capture_profile(0.3)
        worker.join(timeout=60)
        assert not worker.is_alive() and len(results) == 3
    finally:
        app.shutdown()
    (name,) = out["files"]
    with open(f"{out['dir']}/{name}") as f:
        events = json.load(f)["traceEvents"]
    assert events
