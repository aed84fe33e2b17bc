"""The port's serving telemetry on a live engine (tony_tpu_torch.models.
serving traces, histograms and Retry-After; tony_tpu_torch.cli.serve's
/metrics, /autoscale/hint and --trace-dir) on the CPU, against the JAX
package.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``
(TINY widths, float32, as tests/test_torch_serving.py); prompts come from
numpy. Each serving case of tests/test_observability.py has its
counterpart here, with those of tests/test_tracing.py:303,
tests/test_streaming.py:803, tests/test_serving_robustness.py:917 and
tests/test_paged_kv.py:269. Against the JAX package: the same scenario
leaves the same span chains in both engines; the port's /metrics text,
ring and paged, parses under the JAX package's strict parser and carries
the JAX serve's families for the same mode, less the families the port
leaves out (tests/test_torch_observability.py's ``LEFT_OUT_FAMILIES``);
a JAX ``telemetry.state.json`` resumes in a port ``serve``."""

import dataclasses
import json
import re
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from test_torch_observability import (_PROM_LINE, LEFT_OUT_FAMILIES,
                                      RENAMED_FAMILIES)
from tony_tpu import observability as jobs
from tony_tpu.cli.serve import ServeApp as JServeApp
from tony_tpu.models import serving as jS
from tony_tpu.models import transformer as jT
from tony_tpu_torch.api.stream import TokenStream
from tony_tpu_torch.cli import serve
from tony_tpu_torch.cli.serve import TELEMETRY_STATE_FILE, ServeApp
from tony_tpu_torch.events.trace import TRACE_FILE, read_traces
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.observability import (
    TRACE_HEADER,
    TRACE_ID_RESPONSE_HEADER,
    TraceContext,
)

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=jax.numpy.float32)
SRV = dict(slots=2, max_len=64, block_size=4, prefill_chunk=8)
TINY_FLAGS = ["--device", "cpu", "--d-model", "32", "--n-layers", "1",
              "--n-heads", "2", "--d-ff", "64", "--vocab", "64",
              "--dtype", "float32", "--slots", "2", "--max-len", "32",
              "--block-size", "4", "--prefill-chunk", "8"]


@pytest.fixture(scope="module")
def model():
    jcfg = jT.TransformerConfig(**TINY)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


def _srv(model, **kw):
    _, cfg, _, params = model
    return S.SlotServer(params, cfg, device="cpu", **{**SRV, **kw})


def _jsrv(model, **kw):
    jcfg, _, tree, _ = model
    return jS.SlotServer(tree, jcfg, **{**SRV, **kw})


def _prompt(n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, TINY["vocab_size"], size=n, dtype=np.int32)


def _span_names(comp):
    assert comp.trace is not None, "terminated request lost its trace"
    return [n for n, _ in comp.trace["spans"]]


def _assert_ordered(comp):
    ts = [t for _, t in comp.trace["spans"]]
    assert ts == sorted(ts), f"spans out of order: {comp.trace['spans']}"


class _Http:
    """A ServeApp's handler on an ephemeral port, in a thread."""

    def __init__(self, app):
        self.httpd = serve.make_httpd(app, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=30) as r:
            return r.status, r.headers, r.read().decode()

    def post(self, path, payload, headers=None):
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.headers, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.headers, e.read().decode()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _samples(text):
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name_labels, value = line.rsplit(" ", 1)
            out[name_labels] = float(value)
    return out


# --------------------------------------------------------------------------
# Retry-After (tests/test_observability.py:189)
# --------------------------------------------------------------------------

def test_retry_after_monotone_under_saturated_queue(model):
    """With a fixed observed service rate every added waiter advances
    (never shrinks) the advertised retry, as the JAX engine's does, value
    for value. Submission only: no step runs."""
    srv, jsrv = _srv(model), _jsrv(model)
    for s in (srv, jsrv):
        s._rate.observe(4.0)
    seen, jseen = [], []
    for i in range(12):
        srv.submit(S.Request(prompt=_prompt(3, seed=i), max_new_tokens=4))
        jsrv.submit(jS.Request(prompt=_prompt(3, seed=i), max_new_tokens=4))
        seen.append(srv.estimate_retry_after())
        jseen.append(jsrv.estimate_retry_after())
    assert seen == sorted(seen) and seen[-1] > seen[0]
    assert all(isinstance(v, int) and 1 <= v <= 60 for v in seen)
    assert seen == jseen
    assert srv.stats()["retry_after_s"] == seen[-1]


# --------------------------------------------------------------------------
# trace spans (tests/test_observability.py:218, :275, :331, :350)
# --------------------------------------------------------------------------

def _four_fates(Req, srv):
    a = Req(prompt=_prompt(5), max_new_tokens=6)
    b = Req(prompt=_prompt(4, seed=6), max_new_tokens=4)
    srv.submit(a)
    srv.submit(b)                   # the queue is now at max_queue=2
    shed_req = Req(prompt=_prompt(3, seed=7), max_new_tokens=4)
    with pytest.raises(Exception) as shed_exc:
        srv.submit(shed_req)
    assert type(shed_exc.value).__name__ == "QueueFullError"
    assert srv.cancel(b.id) is True
    expired = Req(prompt=_prompt(4, seed=8), max_new_tokens=4, deadline=-1.0)
    srv.submit(expired)
    done = srv.run_until_drained()
    return a, b, shed_req, expired, shed_exc.value, done


def test_trace_lifecycle_every_terminal(model):
    """One server, four fates, as the JAX engine's: a served request's
    full chain, a cancelled-in-queue, an expired and a shed request's
    two-span traces; every terminated request reaches the sink, and the
    histograms count what each trace recorded."""
    sink = []
    srv = _srv(model, max_queue=2, trace_sink=sink.append)
    a, b, shed_req, expired, err, done = _four_fates(S.Request, srv)
    assert 1 <= err.retry_after_s <= 60 and err.priority == "interactive"
    comp = done[a.id]
    assert comp.finish_reason == "length"
    assert _span_names(comp) == ["submitted", "admitted", "prefill_done",
                                 "first_token", "finished"]
    _assert_ordered(comp)
    assert comp.trace["attrs"]["n_tokens"] == len(comp.tokens) == 6
    assert comp.trace["attrs"]["finish_reason"] == "length"
    assert comp.trace["attrs"]["prefix_hit_blocks"] == 0
    assert comp.trace["attrs"]["prompt_tokens"] == 5
    assert _span_names(done[b.id]) == ["submitted", "cancelled"]
    assert _span_names(done[expired.id]) == ["submitted", "expired"]
    for rid in (b.id, expired.id):
        _assert_ordered(done[rid])
    by_id = {r["id"]: r for r in sink}
    assert [n for n, _ in by_id[shed_req.id]["spans"]] == ["submitted",
                                                           "shed"]
    assert set(by_id) == {a.id, b.id, expired.id, shed_req.id}
    tel = srv.telemetry
    assert tel.hist["ttft_s"].count == 1
    assert tel.hist["queue_wait_s"].count == 1
    assert tel.hist["tpot_s"].count == 1
    assert tel.hist["e2e_s"].count == 4
    assert tel.hist["decode_block_s"].count == srv.blocks_dispatched > 0
    assert not srv._traces, "the trace registry drains with the requests"
    # the JAX engine: the same chains, tokens and attributes but the
    # device-lag ones, which come with device time (ROADMAP.md 1.2b)
    jsink = []
    jsrv = _jsrv(model, max_queue=2, trace_sink=jsink.append)
    ja, jb, jshed, jexp, _, jdone = _four_fates(jS.Request, jsrv)
    skip = {"submitted_unix", "device_lag_s", "device_lag_first_token_s"}
    for ours, ref in ((a, ja), (b, jb), (expired, jexp)):
        assert _span_names(done[ours.id]) == _span_names(jdone[ref.id])
        assert done[ours.id].tokens == jdone[ref.id].tokens
        got, want = done[ours.id].trace["attrs"], jdone[ref.id].trace["attrs"]
        assert "submitted_unix" in got
        assert {k: got[k] for k in got if k not in skip} == \
            {k: want[k] for k in want if k not in skip}
    assert len(jsink) == len(sink)


def test_trace_mid_decode_cancel(model):
    srv = _srv(model)
    a = S.Request(prompt=_prompt(4, seed=9), max_new_tokens=24)
    c = S.Request(prompt=_prompt(4, seed=10), max_new_tokens=24)
    srv.submit(a)
    srv.submit(c)
    for _ in range(3):
        srv.step()
    assert srv.cancel(a.id) is True
    done = srv.run_until_drained()
    comp = done[a.id]
    assert comp.finish_reason == "cancelled"
    names = _span_names(comp)
    assert names[0] == "submitted" and names[-1] == "cancelled"
    assert "admitted" in names and "prefill_done" in names
    _assert_ordered(comp)
    assert comp.trace["attrs"]["n_tokens"] == len(comp.tokens) > 0
    assert _span_names(done[c.id])[-1] == "finished"
    assert not srv._traces


def test_reset_seals_inflight_traces(model):
    """reset() with replay off: the in-flight request's trace ends
    ``failed``, the queued one's survives and ends ``finished``."""
    sink = []
    srv = _srv(model, trace_sink=sink.append, replay=False)
    a = S.Request(prompt=_prompt(4, seed=11), max_new_tokens=16)
    srv.submit(a)
    srv.step()                          # admit + first block
    queued = S.Request(prompt=_prompt(4, seed=12), max_new_tokens=4)
    srv.submit(queued)
    assert srv.reset() == [a.id]
    by_id = {r["id"]: r for r in sink}
    assert [n for n, _ in by_id[a.id]["spans"]][-1] == "failed"
    assert queued.id in srv._traces, "a queued request's trace survives"
    done = srv.run_until_drained()
    assert _span_names(done[queued.id])[-1] == "finished"


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_reset_replay_trace_continuity(model, paged):
    """reset() with replay on: the trace is not sealed; it gains a
    ``replayed`` mark, repeats the admission chain, ends once and feeds
    replay_catchup_s. The paged engine's slot-by-slot admission marks
    the same chain."""
    sink = []
    srv = _srv(model, trace_sink=sink.append, paged=paged)
    a = S.Request(prompt=_prompt(4, seed=13), max_new_tokens=16)
    srv.submit(a)
    srv.step()                          # admit + first block
    assert srv.reset() == []
    assert not sink, "a replayed request's trace must not be sealed"
    done = srv.run_until_drained()
    names = _span_names(done[a.id])
    assert "replayed" in names and names[-1] == "finished"
    assert names.count("admitted") == 2 and names.count("prefill_done") == 2
    assert names.count("finished") == 1
    assert done[a.id].trace["attrs"]["replays"] == 1
    assert len(sink) == 1, "exactly one sealed record per request"
    assert srv.telemetry.hist["replay_catchup_s"].count == 1


@pytest.mark.parametrize("interleave", [0, 4])
def test_paged_admission_marks(model, interleave):
    """The paged engine marks ``admitted`` when a slot takes its blocks
    and ``prefill_done`` at the final chunk's dispatch: with interleaved
    prefill the chunks straddle decode blocks, so the two marks part."""
    srv = _srv(model, paged=True, prefill_interleave=interleave)
    reqs = [S.Request(prompt=_prompt(n, seed=40 + n), max_new_tokens=6)
            for n in (20, 9, 30)]
    for r in reqs:
        srv.submit(r)
    done = srv.run_until_drained()
    for r in reqs:
        comp = done[r.id]
        assert _span_names(comp) == ["submitted", "admitted",
                                     "prefill_done", "first_token",
                                     "finished"]
        _assert_ordered(comp)
        assert comp.trace["attrs"]["prompt_tokens"] == len(r.prompt)
    tel = srv.telemetry
    assert tel.hist["prefill_s"].count == tel.hist["ttft_s"].count == 3
    srv._allocator.check()


# --------------------------------------------------------------------------
# GET /metrics (tests/test_observability.py:385) and the JAX serve's families
# --------------------------------------------------------------------------

def test_metrics_endpoint_matches_stats(model):
    """GET /metrics on a running serve: every line parseable, the strict
    parser of the JAX package accepts it, the TTFT/TPOT/queue/e2e
    histograms and every SERVING_* series but the paged and left-out ones
    are there, buckets are cumulative with +Inf == _count, the gauges
    agree with GET /stats and no left-out family appears. Device time
    (the device assertions of tests/test_observability.py:427-456): the
    dispatch families render per kind, the tracker counted dispatches,
    dropped none and raised no reap error, nothing is in flight once it
    drained, and device_lag's count is the same on /metrics and /stats."""
    from tony_tpu_torch import metrics as pmetrics

    srv = _srv(model)
    app = ServeApp(srv)
    app.start()
    http = _Http(app)
    try:
        comp = app.generate(_prompt(5, seed=13), 5, timeout=120)
        assert len(comp.tokens) == 5
        # the reaper catches up, so both scrapes see the same device time
        assert srv.dispatch_tracker.drain(timeout=10)
        code, headers, text = http.get("/metrics")
        assert code == 200
        assert headers["Content-Type"].startswith("text/plain")
        stats = json.loads(http.get("/stats")[2])
    finally:
        http.close()
        app.shutdown()
    for line in text.strip().splitlines():
        assert _PROM_LINE.match(line), f"unparseable line: {line!r}"
    fams = jobs.parse_prom_text(text, strict=True)
    assert not set(fams) & LEFT_OUT_FAMILIES
    # the speculative families are an engine with a draft's (as in the
    # JAX package): a self-draft serve renders them, each model-labeled
    spec_app = ServeApp(_srv(model, draft=model[3], draft_cfg=model[1],
                             spec_gamma=2))
    spec_text, spec_fams = _family_set(spec_app, _prompt(5, seed=13))
    for attr in dir(pmetrics):
        if attr.startswith("SERVING_") and not attr.startswith("SERVING_KV_"):
            name = getattr(pmetrics, attr)
            if attr.startswith("SERVING_SPEC_"):
                assert name not in text and name in spec_fams, attr
                assert any(line.startswith(name) and 'model="default"'
                           in line for line in spec_text.splitlines())
            else:
                assert name in text, attr
    for fam in ("serving_ttft_seconds", "serving_tpot_seconds",
                "serving_queue_wait_seconds", "serving_e2e_seconds",
                "serving_device_lag_seconds", "serving_stream_itl_seconds",
                "serving_loop_turn_seconds"):
        assert f"# TYPE {fam} histogram" in text
    s = _samples(text)
    counts = [v for nl, v in s.items()
              if nl.startswith('serving_ttft_seconds_bucket{le=')]
    assert counts and counts == sorted(counts)
    assert counts[-1] == s["serving_ttft_seconds_count"] == 1
    assert 'serving_dispatch_ready_seconds_bucket{kind="decode_block"' in text
    assert 'serving_dispatch_ready_seconds_count{kind="prefill"}' in text
    assert "# TYPE serving_inflight_dispatches gauge" in text
    assert s["serving_inflight_dispatches"] == 0
    assert s["serving_dispatches_tracked_total"] == \
        stats["device"]["tracked"] > 0
    assert s["serving_dispatch_track_dropped_total"] == 0
    assert s["serving_dispatch_reap_errors_total"] == 0
    assert s["serving_device_lag_seconds_count"] == \
        stats["latency"]["device_lag_s"]["count"] > 0
    assert s["serving_queue_depth"] == stats["queued"]
    assert s["serving_active_slots"] == stats["active"]
    assert s["serving_shed_total"] == stats["shed"]
    assert s["serving_retry_after_s"] == stats["retry_after_s"]
    assert s["serving_blocks_dispatched_total"] == stats["blocks_dispatched"]
    assert stats["latency"]["ttft_s"]["count"] == 1
    assert s["serving_loop_turn_seconds_count"] >= 1
    assert {e["name"] for e in stats["metrics"]} >= {
        "max_serving_active_slots", "avg_serving_queue_depth",
        "max_serving_ttft_p50_s", "max_serving_retry_after_s"}


def _family_set(app, prompt):
    app.start()
    try:
        comp = app.generate(prompt, 5, timeout=120)
        assert len(comp.tokens) == 5
        text = app.prometheus_metrics()
    finally:
        app.shutdown()
    return text, set(jobs.parse_prom_text(text, strict=True))


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_metrics_families_equal_jax_serve(model, paged):
    """One request through the port's ServeApp and through the JAX
    package's, for the same engine mode: the port's exposition parses
    strictly, and its family set is the JAX serve's with exactly the
    left-out families renamed (the XLA compile counters as kernel-library
    builds). Paged: the pool's families equal /stats' ``paged_kv``."""
    kw = dict(paged=True, kv_block=4) if paged else {}
    prompt = _prompt(7, seed=17)
    app = ServeApp(_srv(model, **kw))
    text, ours = _family_set(app, prompt)
    _, ref = _family_set(JServeApp(_jsrv(model, **kw)), prompt)
    assert ours == (ref - LEFT_OUT_FAMILIES) | {
        RENAMED_FAMILIES[f] for f in ref & LEFT_OUT_FAMILIES}
    assert ref & LEFT_OUT_FAMILIES, "the JAX serve renders them"
    assert any(f.startswith("serving_kv_pool") for f in ours) is paged
    if paged:
        pk = app.stats()["paged_kv"]
        s = _samples(text)
        for key in ("total", "free", "used", "peak"):
            assert s[f"serving_kv_pool_blocks_{key}"] == \
                pk[f"pool_blocks_{key}"]
        for state, n in pk["pool_state"].items():
            assert s[f'serving_kv_pool_blocks{{state="{state}"}}'] == n
        assert s["serving_kv_admission_defers_total"] == \
            pk["admission_defers"]


# /stats keys of one side only, each with why (a dotted path names a
# nested key); every other key is on both sides with the same JSON type
PORT_ONLY_STATS = {
    "torch_device",         # the torch device's name ("device" is the
    #                         tracker's snapshot, as in the JAX package)
    "replay",               # replay on or off, also under "journal"
    "decode_block_dispatch_ms_p50",     # a block's host dispatch
    "journal.compactions",  # the journal file's rewrites
    # the kernel-library builds, and of them nvcc's ...
    "compile.kernel_builds", "compile.kernel_nvcc_builds",
    "compile.kernel_build_time_s", "compile.kernel_builds_post_warm",
}
JAX_ONLY_STATS = {
    # ... where the JAX serve counts XLA compiles
    "compile.compiles", "compile.compile_time_s",
    "compile.recompiles_post_warm",
}


def _stats_shape(v, path="", out=None):
    """{dotted key: JSON type} of a /stats payload; a list is typed by
    its first element, the histogram snapshots under ``latency`` and
    ``device.dispatch_ready`` by their shared shape."""
    out = {} if out is None else out
    if isinstance(v, dict):
        for k, x in v.items():
            key = f"{path}.{k}" if path else k
            if path in ("latency", "device.dispatch_ready"):
                key = f"{path}.*"
            _stats_shape(x, key, out)
    elif isinstance(v, list):
        out[path] = "list"
        if v:
            _stats_shape(v[0], path + "[]", out)
    else:
        out[path] = type(v).__name__
    return out


def _stats_after_one_request(app, prompt):
    app.start()
    try:
        comp = app.generate(prompt, 5, timeout=120)
        assert len(comp.tokens) == 5
        tracker = getattr(app.server, "dispatch_tracker", None)
        assert tracker is None or tracker.drain(timeout=10)
        return json.loads(json.dumps(app.stats()))
    finally:
        app.shutdown()


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_stats_keys_and_types_equal_jax_serve(model, paged):
    """One request through the port's ServeApp and through the JAX
    package's, for the same engine mode: /stats has the same keys, nested
    ones included, with the same JSON types, less exactly the keys one
    side alone has. ``device`` is the dispatch tracker's snapshot on both
    and ``role`` is ``"both"``."""
    kw = dict(paged=True, kv_block=4) if paged else {}
    prompt = _prompt(7, seed=17)
    ours = _stats_after_one_request(ServeApp(_srv(model, **kw)), prompt)
    ref = _stats_after_one_request(JServeApp(_jsrv(model, **kw)), prompt)
    assert ours["role"] == ref["role"] == "both"
    assert set(ours["device"]) == set(ref["device"]) == {
        "in_flight", "tracked", "dropped", "reap_errors", "dispatch_ready"}
    assert set(ours["device"]["dispatch_ready"]) == \
        set(ref["device"]["dispatch_ready"])
    a, b = _stats_shape(ours), _stats_shape(ref)

    def roots(keys, declared):
        """Each key as the declared key it lies under, else itself; a key
        of an engine's own payload under ``models.<name>`` counts as the
        top-level key it repeats."""
        keys = {re.sub(r"^models\.[^.]+\.", "", k) for k in keys}
        return {next((r for r in declared if k == r or k.startswith(
            (r + ".", r + "["))), k) for k in keys}

    assert roots(set(a) - set(b), PORT_ONLY_STATS) == PORT_ONLY_STATS
    assert roots(set(b) - set(a), JAX_ONLY_STATS) == JAX_ONLY_STATS
    wrong = {k: (a[k], b[k]) for k in set(a) & set(b) if a[k] != b[k]}
    assert not wrong, f"/stats types differ from the JAX serve's: {wrong}"


def test_metrics_scrapes_keep_the_lock_handoff(model):
    """Scrapes take the serving lock: with /metrics scraped by four
    threads while requests run (and the interpreter switching threads
    every 10 us), every scrape parses strictly (no histogram caught
    mid-observe), the requests all finish and a submit still gets the
    lock while the loop is busy."""
    import sys

    srv = _srv(model, slots=2)
    app = ServeApp(srv)
    app.start()
    http = _Http(app)
    stop, scrapes, errors = threading.Event(), [], []

    def scrape():
        while not stop.is_set():
            try:
                text = http.get("/metrics")[2]
                jobs.parse_prom_text(text, strict=True)
                scrapes.append(text)
            except Exception as e:          # pragma: no cover - reported
                errors.append(repr(e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=scrape, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    try:
        evs = [app.submit_async(_prompt(6, seed=70 + i), 24)
               for i in range(6)]
        t0 = time.monotonic()
        late = app.submit_async(_prompt(3, seed=99), 2)
        assert time.monotonic() - t0 < 5.0, "submit starved by the loop"
        for rid, ev in evs + [late]:
            assert ev.wait(120)
            assert app.take_result(rid).finish_reason == "length"
    finally:
        sys.setswitchinterval(switch)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        http.close()
        app.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(scrapes) >= 2
    last = _samples(scrapes[-1])
    assert last["serving_e2e_seconds_count"] <= 7


# --------------------------------------------------------------------------
# persistence (tests/test_observability.py:518) and --trace-dir
# --------------------------------------------------------------------------

def test_telemetry_persists_across_reset_and_restart(model):
    srv = _srv(model)
    srv.submit(S.Request(prompt=_prompt(4, seed=20), max_new_tokens=4))
    srv.run_until_drained()
    assert srv.telemetry.hist["e2e_s"].count == 1
    ttft_sum = srv.telemetry.hist["ttft_s"].sum
    assert srv.reset() == []
    assert srv.telemetry.hist["e2e_s"].count == 1, (
        "reset() keeps the cumulative buckets")
    state = json.loads(json.dumps(srv.telemetry.state()))
    srv2 = _srv(model)
    srv2.telemetry.restore(state)
    assert srv2.telemetry.hist["ttft_s"].sum == pytest.approx(ttft_sum)
    srv2.submit(S.Request(prompt=_prompt(4, seed=21), max_new_tokens=4))
    srv2.run_until_drained()
    assert srv2.telemetry.hist["e2e_s"].count == 2
    srv2.telemetry.restore({"no_such_hist_s": {"bounds": [], "counts": [],
                                               "count": 0, "sum": 0.0}})


def test_trace_dir_writes_traces_and_resumes_telemetry(tmp_path, capsys):
    """serve --trace-dir: requests.trace.jsonl holds one record a request
    in the JAX package's shape, read by its reader; telemetry.state.json
    is written at shutdown and a restart on the directory resumes the
    counts; a JAX serve's dump resumes in the port's; a damaged or
    wrong-shaped dump is reported and ignored."""
    trace_dir = tmp_path / "t"
    args = serve.build_argparser().parse_args(
        TINY_FLAGS + ["--trace-dir", str(trace_dir)])

    def run(n):
        app = serve.build_app(args)
        app.start()
        try:
            for i in range(n):
                app.generate([1, 2, 3 + i], 4, timeout=60)
            return app.server.telemetry.hist["e2e_s"].count
        finally:
            app.shutdown()

    assert run(2) == 2
    recs = read_traces(trace_dir / TRACE_FILE)
    from tony_tpu.events.trace import read_traces as jread

    assert jread(trace_dir / TRACE_FILE) == recs
    assert len(recs) == 2
    for rec in recs:
        assert set(rec) == {"id", "spans", "attrs"}
        assert [n for n, _ in rec["spans"]][-1] == "finished"
        assert rec["attrs"]["finish_reason"] == "length"
        assert rec["attrs"]["n_tokens"] == 4
    state = json.loads((trace_dir / TELEMETRY_STATE_FILE).read_text())
    assert state["e2e_s"]["count"] == 2
    assert run(1) == 3, "the restart resumes the dump"
    assert len(read_traces(trace_dir / TRACE_FILE)) == 3
    # a JAX serve's dump (its own ServingTelemetry) resumes in the port's
    jtel = jobs.ServingTelemetry()
    for x in (0.01, 0.2, 3.0):
        jtel.observe("e2e_s", x)
        jtel.observe("ttft_s", x / 2)
    (trace_dir / TELEMETRY_STATE_FILE).write_text(json.dumps(jtel.state()))
    app = serve.build_app(args)
    assert app.server.telemetry.state() == jtel.state()
    app.start()
    app.shutdown()
    capsys.readouterr()
    for bad in ("{not json", "[1, 2]", '{"e2e_s": {"bounds": [1]}}'):
        (trace_dir / TELEMETRY_STATE_FILE).write_text(bad)
        app = serve.build_app(args)
        assert "telemetry state not restored" in capsys.readouterr().out
        assert app.server.telemetry.hist["e2e_s"].count == 0
        app.start()
        app.shutdown()


def test_trace_sink_failure_never_takes_down_the_loop(model):
    def broken(record):
        raise OSError("disk full")

    srv = _srv(model, trace_sink=broken)
    srv.submit(S.Request(prompt=_prompt(4, seed=22), max_new_tokens=4))
    done = srv.run_until_drained()
    (comp,) = done.values()
    assert comp.finish_reason == "length" and comp.trace is not None


def test_recovered_request_keeps_its_trace_and_lineage(model, tmp_path):
    """A file journal's entry recovered by a new engine: its trace binds
    the dead attempt's exact identity and records ``recovered_from``."""
    from tony_tpu_torch.events.journal import JOURNAL_FILE, RequestJournal

    ctx = TraceContext.from_header(TraceContext.mint().to_header())
    path = tmp_path / JOURNAL_FILE
    srv1 = _srv(model, journal=RequestJournal(path))
    req = S.Request(prompt=_prompt(4, seed=21), max_new_tokens=20, trace=ctx)
    srv1.submit(req)
    srv1.step()
    srv1.shutdown()                     # as if SIGKILLed
    journal, entries = RequestJournal.recover(path)
    sink = []
    srv2 = _srv(model, journal=journal, trace_sink=sink.append)
    assert srv2.recover_journal(entries) == 1
    done = srv2.run_until_drained()
    (comp,) = done.values()
    attrs = comp.trace["attrs"]
    assert attrs["recovered_from"] == req.id
    assert (attrs["trace_id"], attrs["span_id"], attrs["parent_span_id"]) \
        == (ctx.trace_id, ctx.span_id, ctx.parent_span_id)
    assert sink == [comp.trace]


# --------------------------------------------------------------------------
# the front door (tests/test_tracing.py:303, tests/test_streaming.py:803,
# tests/test_serving_robustness.py:917)
# --------------------------------------------------------------------------

def test_serve_front_door_trace_contract(model):
    """An inbound X-Tony-Trace is adopted (the sender's span becomes the
    parent, a fresh span is minted), echoed as X-Tony-Trace-Id, and the
    sealed trace record carries the full identity and service=serve."""
    records = []
    app = ServeApp(_srv(model, trace_sink=records.append))
    app.start()
    http = _Http(app)
    try:
        sender = TraceContext.mint()
        prompt = [int(t) for t in _prompt(5, seed=11)]
        code, headers, _ = http.post(
            "/generate", {"prompt": prompt, "max_new_tokens": 4},
            headers={TRACE_HEADER: sender.to_header()})
        assert code == 200
        assert headers[TRACE_ID_RESPONSE_HEADER] == sender.trace_id
        deadline = time.monotonic() + 30
        while not records and time.monotonic() < deadline:
            time.sleep(0.02)
        attrs = records[-1]["attrs"]
        assert attrs["trace_id"] == sender.trace_id
        assert attrs["parent_span_id"] == sender.span_id
        assert attrs["span_id"] != sender.span_id
        assert attrs["service"] == "serve"
        # a malformed header: a fresh root, in the record and the frame
        code, _, body = http.post(
            "/generate?stream=true", {"prompt": prompt, "max_new_tokens": 4},
            headers={TRACE_HEADER: "NOT A:HEADER"})
        frames = [json.loads(ln[len("data: "):]) for ln in body.splitlines()
                  if ln.startswith("data: ")]
        final = frames[-1]
        assert final["finish_reason"] == "length"
        assert final["trace_id"] not in ("", None, sender.trace_id)
        deadline = time.monotonic() + 30
        while len(records) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert records[-1]["attrs"]["trace_id"] == final["trace_id"]
        assert records[-1]["attrs"]["parent_span_id"] is None
    finally:
        http.close()
        app.shutdown()


def test_retry_after_folds_engine_estimate_and_autoscale_hint(model):
    """The 429 Retry-After is the larger of the engine's estimate and the
    autoscaler's pushed cooldown (POST /autoscale/hint), in [1, 60], and
    the hint decays; a bad hint is a 400."""
    srv = _srv(model, max_queue=1)
    app = ServeApp(srv)
    app.start()
    http = _Http(app)
    try:
        assert app.retry_after_s(engine_estimate=7.4) == 8
        assert app.retry_after_s(engine_estimate=10_000) == 60
        app.set_autoscale_hint(23.0)
        assert app.retry_after_s(engine_estimate=2.0) == 23
        app.set_autoscale_hint(0.0)
        assert app.retry_after_s(engine_estimate=2.0) == 2
        assert app.retry_after_s() == 1         # no service history yet
        assert http.post("/autoscale/hint", {"cooldown_s": 17.0})[0] == 200
        hits = []

        def occupy(s):
            code, headers, _ = http.post(
                "/generate", {"prompt": _prompt(6, seed=s).tolist(),
                              "max_new_tokens": 10})
            if code == 429:
                hits.append(int(headers["Retry-After"]))

        threads = [threading.Thread(target=occupy, args=(50 + i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert hits, "6 concurrent posts never saturated the 1-deep queue"
        assert all(10 <= ra <= 60 for ra in hits), hits
        for bad in ({"cooldown_s": -3}, {"cooldown_s": "x"}):
            assert http.post("/autoscale/hint", bad)[0] == 400
        # the /v1 route's 429 carries the same header
        srv.pause_admission = True
        try:
            app.submit_async([1, 2], 4)
            code, headers, body = http.post(
                "/v1/completions", {"prompt": "1 2 3", "max_tokens": 2})
            assert code == 429 and int(headers["Retry-After"]) >= 10
            assert json.loads(body)["error"]["type"] == "rate_limit_error"
        finally:
            srv.pause_admission = False
    finally:
        http.close()
        app.shutdown()


def test_http_overload_sheds_429_with_retry_after(model):
    """With the wait queue at max_queue the next POST /generate is shed
    with 429 and a rate-derived Retry-After (1: nothing served yet),
    while the queued request is served once admission runs; once
    requests have been served the header follows the estimate."""
    srv = _srv(model, max_queue=1)
    srv.pause_admission = True          # hold the queue seat for the probe
    app = ServeApp(srv)
    app.start()
    http = _Http(app)
    try:
        results = {}
        prompt = [int(x) for x in _prompt(5, seed=257)]

        def post():
            results[0] = http.post("/generate", {"prompt": prompt,
                                                 "max_new_tokens": 5})

        t1 = threading.Thread(target=post)
        t1.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and srv.pending < 1:
            time.sleep(0.002)
        assert srv.pending == 1
        code, headers, _ = http.post("/generate", {"prompt": [1],
                                                   "max_new_tokens": 4})
        assert code == 429 and int(headers["Retry-After"]) == 1
        srv.pause_admission = False
        t1.join(timeout=60)
        assert results[0][0] == 200
        assert json.loads(results[0][2])["finish_reason"] == "length"
        # a slow service history: the header grows with it
        with app.lock:
            for _ in range(30):
                srv._rate.observe(9.0)
            srv.pause_admission = True
        app.submit_async([1, 2], 4)
        code, headers, _ = http.post("/generate", {"prompt": [1],
                                                   "max_new_tokens": 4})
        assert code == 429
        assert int(headers["Retry-After"]) == srv._rate.retry_after_s(
            1, srv.slots) == 9
        srv.pause_admission = False
        st = app.stats()
        assert st["shed"] == 2 and st["retry_after_s"] >= 1
    finally:
        http.close()
        app.shutdown()


def test_class_budgets_shed_order_and_retry_after(model):
    """The paged engine's tiers (tests/test_paged_kv.py:269): queued
    batch work is displaced before any interactive request is refused, a
    refusal carries the engine's Retry-After and the refused class, and
    the displaced requests' traces end ``shed``."""
    srv = _srv(model, paged=True, max_queue=4, batch_queue_frac=0.5)
    occ = [S.Request(prompt=_prompt(8, seed=90 + i), max_new_tokens=12)
           for i in range(2)]
    for r in occ:
        srv.submit(r)
    for _ in range(4):
        srv.step()
    refused = {"batch": 0, "interactive": 0}
    for i in range(3):
        try:
            srv.submit(S.Request(prompt=_prompt(6, seed=i),
                                 max_new_tokens=4, priority="batch"))
        except S.QueueFullError as exc:
            refused["batch"] += 1
            assert exc.priority == "batch"
    retry_afters = []
    for i in range(5):
        try:
            srv.submit(S.Request(prompt=_prompt(6, seed=10 + i),
                                 max_new_tokens=4, priority="interactive"))
        except S.QueueFullError as exc:
            refused["interactive"] += 1
            assert exc.priority == "interactive"
            assert exc.retry_after_s == srv.estimate_retry_after()
            retry_afters.append(exc.retry_after_s)
    done = srv.run_until_drained()
    shed = [c for c in done.values() if c.finish_reason == "shed"]
    st = srv.stats()
    assert refused["batch"] >= 1 and len(shed) >= 1
    assert st["shed_by_class"]["batch"] >= len(shed)
    assert all(isinstance(s, int) and 1 <= s <= 60 for s in retry_afters)
    assert all(_span_names(c) == ["submitted", "shed"] for c in shed)
    ok = [c for c in done.values() if c.finish_reason in ("stop", "length")]
    assert len(ok) == (2 + (5 - refused["interactive"])
                       + (3 - refused["batch"]) - len(shed))
    srv._allocator.check()


# --------------------------------------------------------------------------
# the stream's inter-token gap and the first token (processing time)
# --------------------------------------------------------------------------

def test_stream_itl_and_first_token_at_processing(model):
    """In EOS mode every block is processed behind the pipeline lag: a
    stream's feeds are block by block, each gap after its first feeds
    stream_itl_s, and first_token is marked when the host processes the
    first block with the request's tokens, never at dispatch."""
    srv = _srv(model, stop_tokens=(255,))
    req = S.Request(prompt=_prompt(5, seed=31), max_new_tokens=20)
    srv.submit(req)
    ts = TokenStream()
    srv.attach_stream(req.id, ts)
    srv.step()                          # admits, dispatches block 1
    assert srv._traces[req.id].t("first_token") is None
    done = srv.run_until_drained()
    comp = done[req.id]
    assert ts.drain_all(timeout=10)[0] == comp.tokens
    feeds = -(-len(comp.tokens) // SRV["block_size"])
    assert srv.telemetry.hist["stream_itl_s"].count == feeds - 1 >= 2
    names = _span_names(comp)
    assert names.index("first_token") == names.index("prefill_done") + 1
