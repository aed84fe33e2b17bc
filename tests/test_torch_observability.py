"""The port's serving telemetry classes (tony_tpu_torch.observability,
.metrics, .events.trace and the StepTimer's turn clock) on the CPU, held
against the JAX package's: no model runs here.

Each case of tests/test_observability.py that needs no engine has its
counterpart (histograms, the renderer, Retry-After, the trace feeds, the
state round trip, the finish-reason and metric-name lints), plus the
cross-framework contract: the same inputs give the same bucket counts,
quantiles, estimates and byte-identical exposition text and trace-file
lines, and a ``state()`` dump restores across the two packages both
ways."""

import inspect
import json
import math
import re

import numpy as np
import pytest

from tony_tpu import metrics as jmetrics
from tony_tpu import observability as jobs
from tony_tpu.events import trace as jtrace
from tony_tpu_torch import metrics as pmetrics
from tony_tpu_torch import observability as pobs
from tony_tpu_torch.events import trace as ptrace
from tony_tpu_torch.observability import (
    Histogram,
    PromRenderer,
    RequestTrace,
    ServiceRateEstimator,
    ServingTelemetry,
    TraceContext,
)

# /metrics families of the JAX package's serve that the port leaves out,
# each with the ROADMAP.md queue-1 item that brings it (README.md names
# the same set):
LEFT_OUT_FAMILIES = {
    # item 9, observability hooks: compile counters as CUDA-graph captures
    "serving_xla_compile_seconds", "serving_xla_compiles_total",
    "serving_xla_recompiles_post_warm_total",
}

# one exposition line: a comment, or name{labels} value
_PROM_LINE = re.compile(
    r"^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+|"
    r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [^\s]+)$")


# --------------------------------------------------------------------------
# Histogram (tests/test_observability.py:70, :82, :96, :111, :500)
# --------------------------------------------------------------------------

def test_histogram_bucket_boundaries():
    h = Histogram(lo=1.0, hi=1000.0, per_decade=1)
    assert h.bounds == [1.0, 10.0, 100.0, 1000.0]
    h.observe(0.5)          # <= lo: first bucket
    h.observe(10.0)         # on a boundary: le semantics, bucket le=10
    h.observe(10.0001)      # just past it: next bucket
    h.observe(5000.0)       # past hi: +Inf overflow
    assert h.counts == [1, 1, 1, 0, 1]
    assert h.count == 4
    assert h.sum == pytest.approx(0.5 + 10.0 + 10.0001 + 5000.0)
    # the default buckets are the JAX package's, bound for bound
    assert Histogram().bounds == jobs.Histogram().bounds
    assert len(Histogram().counts) == len(jobs.Histogram().counts)


def test_histogram_merge():
    a = Histogram(lo=1.0, hi=100.0, per_decade=1)
    b = Histogram(lo=1.0, hi=100.0, per_decade=1)
    for v in (0.5, 5.0):
        a.observe(v)
    for v in (50.0, 5000.0):
        b.observe(v)
    a.merge(b)
    assert a.counts == [1, 1, 1, 1]
    assert a.count == 4 and a.sum == pytest.approx(5055.5)
    with pytest.raises(ValueError, match="different buckets"):
        a.merge(Histogram(lo=1.0, hi=100.0, per_decade=2))


def test_histogram_quantiles_known_distribution():
    h = Histogram(lo=1e-3, hi=100.0, per_decade=5)
    for k in range(1, 1001):                # uniform on (0, 1]
        h.observe(k / 1000.0)
    assert 0.35 < h.quantile(0.5) < 0.66
    assert 0.80 < h.quantile(0.99) <= 1.01
    qs = [h.quantile(q) for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)]
    assert qs == sorted(qs), "quantiles must be monotone in q"
    assert h.mean == pytest.approx(0.5005, rel=1e-6)
    assert Histogram().quantile(0.5) == 0.0         # empty: defined as 0
    with pytest.raises(ValueError):
        h.quantile(1.5)


def test_histogram_snapshot_shape():
    h = Histogram()
    h.observe(0.02)
    snap = h.snapshot()
    assert snap["count"] == 1
    assert set(snap) == {"count", "mean_s", "p50_s", "p90_s", "p99_s"}


def test_histogram_state_roundtrip():
    h = Histogram(lo=1.0, hi=100.0, per_decade=1)
    for v in (0.5, 5.0, 5000.0):
        h.observe(v)
    dumped = json.loads(json.dumps(h.state()))
    h2 = Histogram(lo=1.0, hi=100.0, per_decade=1)
    h2.restore(dumped)
    assert h2.counts == h.counts
    assert h2.count == 3 and h2.sum == pytest.approx(h.sum)
    h2.observe(5.0)                     # restored histograms keep counting
    assert h2.count == 4
    with pytest.raises(ValueError, match="different buckets"):
        Histogram(lo=1.0, hi=100.0, per_decade=2).restore(dumped)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_matches_jax(seed):
    """Log-uniform samples over and past the buckets: the same counts,
    sum, quantiles and snapshot as the JAX package's histogram, and a
    merge of two agrees too."""
    rng = np.random.default_rng(seed)
    xs = (10.0 ** rng.uniform(-4.5, 2.5, 500)).tolist() + [0.0, 1e-3, 120.0]
    ours, ref = Histogram(), jobs.Histogram()
    for x in xs:
        ours.observe(x)
        ref.observe(x)
    assert ours.counts == ref.counts and ours.count == ref.count
    assert ours.sum == ref.sum
    for q in np.linspace(0, 1, 21):
        assert ours.quantile(float(q)) == ref.quantile(float(q))
    assert ours.snapshot() == ref.snapshot()
    other, jother = Histogram(), jobs.Histogram()
    for x in xs[:50]:
        other.observe(x)
        jother.observe(x)
    ours.merge(other)
    ref.merge(jother)
    assert ours.state() == ref.state()


def test_state_dumps_restore_across_packages():
    """A ServingTelemetry dump (through JSON, as serve persists it) from
    either package restores in the other, bucket for bucket."""
    rng = np.random.default_rng(7)
    jtel, ptel = jobs.ServingTelemetry(), ServingTelemetry()
    for name in jobs.TELEMETRY_HISTOGRAMS:
        for x in (10.0 ** rng.uniform(-3.5, 2.2, 20)).tolist():
            jtel.observe(name, x)
            ptel.observe(name, 2 * x)
    into_port = ServingTelemetry()
    into_port.restore(json.loads(json.dumps(jtel.state())))
    assert into_port.state() == jtel.state()
    into_jax = jobs.ServingTelemetry()
    into_jax.restore(json.loads(json.dumps(ptel.state())))
    assert into_jax.state() == ptel.state()
    assert into_jax.snapshot() == ptel.snapshot()
    # an unknown histogram in a dump is skipped, not fatal
    into_port.restore({"no_such_hist_s": {"bounds": [], "counts": [],
                                          "count": 0, "sum": 0.0}})


# --------------------------------------------------------------------------
# Prometheus exposition (tests/test_observability.py:129, :158)
# --------------------------------------------------------------------------

def test_prom_renderer_golden():
    h = Histogram(lo=1.0, hi=100.0, per_decade=1)
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    r = PromRenderer()
    r.gauge("g_one", 3, "a gauge")
    r.counter("c_total", 7, "a counter", labels={"kind": "x"})
    r.histogram("h_seconds", h, "a histogram")
    text = r.render()
    assert text == (
        "# HELP g_one a gauge\n"
        "# TYPE g_one gauge\n"
        "g_one 3\n"
        "# HELP c_total a counter\n"
        "# TYPE c_total counter\n"
        'c_total{kind="x"} 7\n'
        "# HELP h_seconds a histogram\n"
        "# TYPE h_seconds histogram\n"
        'h_seconds_bucket{le="1"} 1\n'
        'h_seconds_bucket{le="10"} 2\n'
        'h_seconds_bucket{le="100"} 3\n'
        'h_seconds_bucket{le="+Inf"} 4\n'
        "h_seconds_sum 555.5\n"
        "h_seconds_count 4\n"
    )
    for line in text.strip().splitlines():
        assert _PROM_LINE.match(line), f"unparseable line: {line!r}"


def test_prom_renderer_sanitizes_and_groups():
    r = PromRenderer()
    r.gauge("weird-name.x", 1, "g", labels={"a b": 'q"uote\nnl'})
    r.gauge("weird-name.x", 2, "g", labels={"a b": "two"})
    text = r.render()
    assert text.count("# TYPE weird_name_x gauge") == 1
    assert 'weird_name_x{a_b="q\\"uote\\nnl"} 1' in text
    assert 'weird_name_x{a_b="two"} 2' in text


def _render_script(mod, seed):
    """The same calls on either package's renderer -> its text."""
    rng = np.random.default_rng(seed)
    h = mod.Histogram()
    for x in (10.0 ** rng.uniform(-4, 3, 200)).tolist():
        h.observe(x)
    r = mod.PromRenderer()
    r.gauge("serving_slots", 8, "configured KV-cache slots")
    r.gauge("9 bad-name", float(rng.uniform()), "", labels={"x y": 'a"b\\c'})
    r.counter("serving_shed_total", int(rng.integers(0, 1000)), "shed")
    r.counter("serving_shed_by_class_total", 3, "per class",
              labels={"class": "batch"})
    r.counter("serving_shed_by_class_total", 4, "per class",
              labels={"class": "interactive"})
    r.gauge("big", 1e16)
    r.gauge("inf", math.inf)
    r.gauge("tiny", 1.5e-7)
    r.histogram("serving_ttft_seconds", h, "ttft")
    r.histogram("serving_ttft_seconds", mod.Histogram(), "ttft",
                labels={"model": "m"})
    return r.render()


@pytest.mark.parametrize("seed", [0, 1])
def test_prom_renderer_byte_identical_to_jax(seed):
    ours = _render_script(pobs, seed)
    assert ours == _render_script(jobs, seed)
    jobs.parse_prom_text(ours, strict=True)
    assert pobs.PROM_CONTENT_TYPE == jobs.PROM_CONTENT_TYPE


# --------------------------------------------------------------------------
# Retry-After (tests/test_observability.py:173)
# --------------------------------------------------------------------------

def test_service_rate_estimator_retry_after():
    est = ServiceRateEstimator()
    assert est.retry_after_s(0, 8) == 1         # no observations: floor
    for _ in range(20):
        est.observe(8.0)
    assert est.service_time_s == pytest.approx(8.0)
    assert est.retry_after_s(0, 2) == 4         # 8s * 1 waiter / 2 slots
    assert est.retry_after_s(1000, 2) == 60     # ceiling clamp
    vals = [est.retry_after_s(q, 2) for q in range(0, 40, 4)]
    assert vals == sorted(vals) and vals[-1] > vals[0], (
        "Retry-After must grow with queue depth")
    fast = ServiceRateEstimator()
    fast.observe(0.01)
    assert fast.retry_after_s(0, 8) == 1        # sub-second: 1s floor


def test_service_rate_estimator_matches_jax():
    rng = np.random.default_rng(3)
    ours, ref = ServiceRateEstimator(), jobs.ServiceRateEstimator()
    for x in rng.uniform(-1.0, 30.0, 200).tolist():     # negatives ignored
        ours.observe(x)
        ref.observe(x)
        assert ours.service_time_s == ref.service_time_s
        for q, s in ((0, 1), (3, 8), (int(rng.integers(0, 500)), 2)):
            assert ours.retry_after_s(q, s) == ref.retry_after_s(q, s)


# --------------------------------------------------------------------------
# traces (tests/test_observability.py:881, tests/test_tracing.py:105)
# --------------------------------------------------------------------------

def test_telemetry_trace_feed_units():
    tel = ServingTelemetry()
    tr = RequestTrace(7)
    tr.mark("submitted", t=10.0)
    tr.mark("admitted", t=10.5)
    tr.mark("prefill_done", t=10.6)
    tr.mark("first_token", t=11.0)
    tr.attrs["n_tokens"] = 5
    tr.mark("finished", t=11.8)
    tel.observe_trace(tr)
    assert tel.hist["queue_wait_s"].sum == pytest.approx(0.5)
    assert tel.hist["prefill_s"].sum == pytest.approx(0.1)
    assert tel.hist["ttft_s"].sum == pytest.approx(1.0)
    assert tel.hist["e2e_s"].sum == pytest.approx(1.8)
    assert tel.hist["tpot_s"].sum == pytest.approx(0.8 / 4)  # (n-1) steps
    # a shed trace only feeds e2e
    tel2 = ServingTelemetry()
    shed = RequestTrace(8)
    shed.mark("submitted", t=1.0)
    shed.mark("shed", t=1.25)
    tel2.observe_trace(shed)
    assert tel2.hist["e2e_s"].count == 1
    assert tel2.hist["ttft_s"].count == 0
    # a replayed trace feeds replay_catchup_s from its newest mark
    tel3 = ServingTelemetry()
    rep = RequestTrace(9)
    for name, t in (("submitted", 0.0), ("admitted", 1.0),
                    ("replayed", 2.0), ("admitted", 2.5),
                    ("replayed", 3.0), ("admitted", 3.5), ("finished", 4.5)):
        rep.mark(name, t=t)
    tel3.observe_trace(rep)
    assert tel3.hist["replay_catchup_s"].sum == pytest.approx(1.5)
    assert rep.last_t("admitted") == 3.5 and rep.t("admitted") == 1.0
    assert rep.terminal == "finished"


def test_trace_feeds_match_jax():
    """The same span sequences fold into the same histograms."""
    rng = np.random.default_rng(11)
    ours, ref = ServingTelemetry(), jobs.ServingTelemetry()
    chains = (["submitted", "admitted", "prefill_done", "first_token",
               "finished"], ["submitted", "cancelled"],
              ["submitted", "admitted", "prefill_done", "replayed",
               "admitted", "prefill_done", "first_token", "finished"],
              ["submitted", "shed"], ["submitted", "expired"])
    for i in range(60):
        chain = chains[i % len(chains)]
        ts = np.cumsum(rng.uniform(0, 2, len(chain))).tolist()
        n = int(rng.integers(0, 40))
        for mod, tel in ((pobs, ours), (jobs, ref)):
            tr = mod.RequestTrace(i)
            for name, t in zip(chain, ts):
                tr.mark(name, t=t)
            tr.attrs["n_tokens"] = n
            tel.observe_trace(tr)
    assert ours.state() == ref.state()
    assert ours.snapshot() == ref.snapshot()
    assert list(pobs.TELEMETRY_HISTOGRAMS) == list(jobs.TELEMETRY_HISTOGRAMS)
    assert pobs.TELEMETRY_HISTOGRAMS == jobs.TELEMETRY_HISTOGRAMS


def test_request_trace_bind_rides_attrs():
    tr = RequestTrace(3)
    ctx = TraceContext.mint()
    assert tr.bind(ctx) is tr
    assert tr.ctx is not None and tr.ctx.trace_id == ctx.trace_id
    rec = tr.to_dict()
    assert rec["attrs"]["trace_id"] == ctx.trace_id
    assert rec["attrs"]["span_id"] == ctx.span_id
    assert RequestTrace(4).ctx is None
    assert RequestTrace(5).bind(None).to_dict()["attrs"].keys() == {
        "submitted_unix"}


def test_trace_file_lines_match_jax(tmp_path):
    """One record through each package's TraceWriter: the same bytes on
    disk, and each reader reads the other's file (torn lines skipped)."""
    tr = RequestTrace(12)
    tr.bind(TraceContext.from_header("0123456789abcdef:fedcba9876543210"))
    for name in ("submitted", "admitted", "prefill_done", "first_token"):
        tr.mark(name)
    tr.attrs.update(n_tokens=5, finish_reason="length", prompt_tokens=3)
    tr.mark("finished")
    rec = tr.to_dict()
    assert ptrace.TRACE_FILE == jtrace.TRACE_FILE
    pw = ptrace.TraceWriter(tmp_path / "p")
    jw = jtrace.TraceWriter(tmp_path / "j")
    for w in (pw, jw):
        w.write(rec)
        w.write({"id": 13, "spans": [["submitted", 1.0], ["shed", 1.5]],
                 "attrs": {"n_tokens": 0}})
        w.close()
    pbytes = (tmp_path / "p" / ptrace.TRACE_FILE).read_bytes()
    assert pbytes == (tmp_path / "j" / jtrace.TRACE_FILE).read_bytes()
    with open(tmp_path / "p" / ptrace.TRACE_FILE, "a") as f:
        f.write('{"id": 14, "spans": [["subm\n')          # torn by a crash
    got = ptrace.read_traces(tmp_path / "p" / ptrace.TRACE_FILE)
    assert got == jtrace.read_traces(tmp_path / "p" / ptrace.TRACE_FILE)
    assert [r["id"] for r in got] == [12, 13]
    assert got[0]["attrs"]["parent_span_id"] == "fedcba9876543210"
    # the JAX package's merge layer reads the port's file
    coll = jtrace.TraceCollector()
    coll.add_file(tmp_path / "p" / ptrace.TRACE_FILE)
    assert coll.skipped == 1            # record 13 carries no trace id
    assert list(coll.merged()) == ["0123456789abcdef"]


# --------------------------------------------------------------------------
# lints (tests/test_observability.py:551, :816)
# --------------------------------------------------------------------------

def test_metrics_names_rendered_and_documented():
    """The port's metric-name constants are the JAX package's, name for
    name and value for value; the JAX serving names it lacks are exactly
    the left-out families above; every constant is rendered by the port's
    serve and named in README.md's port section, with every left-out
    family."""
    from pathlib import Path

    import tony_tpu_torch.cli.serve as serve_mod

    ours = {k: v for k, v in vars(pmetrics).items()
            if k.isupper() and isinstance(v, str)}
    ref = {k: v for k, v in vars(jmetrics).items()
           if k.isupper() and isinstance(v, str) and k.startswith("SERVING_")}
    assert ours and all(ref[k] == v for k, v in ours.items())
    assert {ref[k] for k in set(ref) - set(ours)} <= LEFT_OUT_FAMILIES
    src = inspect.getsource(serve_mod)
    unrendered = sorted(k for k in ours if f"_metrics.{k}" not in src)
    assert not unrendered, f"constants serve never renders: {unrendered}"
    assert not any(f'"{fam}"' in src for fam in LEFT_OUT_FAMILIES)
    readme = (Path(__file__).resolve().parent.parent / "README.md"
              ).read_text()
    port = readme[readme.index("## PyTorch/CUDA port"):]
    missing = sorted(fam for fam in LEFT_OUT_FAMILIES | set(ours.values())
                     if f"`{fam}`" not in port)
    assert not missing, f"README's port section lacks {missing}"


def test_finish_reason_vocabulary_pinned():
    """The engine's finish reasons and trace terminals: the JAX package's
    sets, every reason produced by the port's engine source and none
    outside the set, and the HTTP mapping (shed -> 429, failed -> 503)
    wired in the port's serve."""
    import tony_tpu_torch.cli.serve as serve_mod
    import tony_tpu_torch.models.serving as serving_mod
    from tony_tpu.models import serving as jserving

    assert serving_mod.COMPLETION_FINISH_REASONS == \
        jserving.COMPLETION_FINISH_REASONS
    assert serving_mod.FINISH_REASONS == jserving.FINISH_REASONS
    assert pobs.TERMINAL_SPANS == jobs.TERMINAL_SPANS
    assert set(pobs.TERMINAL_SPANS) - {"finished"} == \
        set(serving_mod.FINISH_REASONS) - {"stop", "length", "prefilled"}
    assert "replayed" not in pobs.TERMINAL_SPANS
    serving_src = inspect.getsource(serving_mod)
    serve_src = inspect.getsource(serve_mod)
    produced = set(re.findall(r'_finish_trace\([^)]*"(\w+)"', serving_src))
    produced |= set(re.findall(r'_seal_trace\([^)]*"(\w+)"', serving_src))
    produced |= set(re.findall(
        r'Completion\(\s*[\w.\[\]]+,\s*[\w.\[\]() ]+,\s*"(\w+)"',
        serving_src))
    assert not produced - set(serving_mod.FINISH_REASONS) - {"finished"}
    assert {"cancelled", "expired", "failed", "shed", "finished"} <= produced
    for reason in serving_mod.FINISH_REASONS:
        assert f'"{reason}"' in serving_src, reason
    assert "QueueFullError" in serve_src and "429" in serve_src
    assert "ServingLoopError" in serve_src and "503" in serve_src
    assert '"Retry-After": "1"' not in serve_src


def test_metrics_accumulator_matches_jax():
    rng = np.random.default_rng(5)
    ours, ref = pmetrics.MetricsAccumulator(), jmetrics.MetricsAccumulator()
    for _ in range(100):
        name = str(rng.choice(["a", "b", "c"]))
        v = float(rng.normal())
        for acc in (ours, ref):
            (acc.set if name == "c" else acc.observe)(name, v)
    assert ours.snapshot() == ref.snapshot()


def test_step_timer_turn_clock(monkeypatch):
    """The serve loop's turn clock: durations from time.monotonic(), and
    reset_interval() skips an idle gap instead of booking it."""
    from tony_tpu_torch.train import profiling

    fake = {"t": 100.0}
    monkeypatch.setattr(profiling.time, "monotonic", lambda: fake["t"])
    timer = profiling.StepTimer(window=4)
    assert timer.tick() is None
    fake["t"] += 2.5
    assert timer.tick() == pytest.approx(2.5)
    assert timer.steps_per_sec == pytest.approx(1 / 2.5)
    timer.reset_interval()
    fake["t"] += 1000.0                 # idle: not a turn
    assert timer.tick() is None
    fake["t"] += 0.5
    assert timer.tick() == pytest.approx(0.5)
    assert timer.hist.count == 2
    assert isinstance(timer.hist, Histogram)


def test_serving_ab_reads_each_trees_run(tmp_path):
    """tools/serving_ab runs the serving phase with each tree as the
    working directory (so each imports its own modules) and reads back
    run A's record."""
    from tony_tpu_torch.tools import serving_ab

    for i in range(2):
        tree = tmp_path / f"t{i}"
        (tree / "tony_tpu_torch").mkdir(parents=True)
        (tree / "tony_tpu_torch" / "__init__.py").write_text("ops = None\n")
        (tree / "torch.py").write_text("")     # the tree's own, and quick
        rec = json.dumps({"run_a": {"tree": i}})
        (tree / "chip_smoke.py").write_text(
            "def phase_serving(torch, ops):\n"
            f"    print('serving ' + {rec!r})\n")
        assert serving_ab.run_tree(tree) == [{"tree": i}]
        assert serving_ab.run_tree(tree, repeat=2) == [{"tree": i}] * 2
    (tmp_path / "t1" / "chip_smoke.py").write_text("raise SystemExit(3)\n")
    with pytest.raises(RuntimeError, match="exit 3"):
        serving_ab.run_tree(tmp_path / "t1")
