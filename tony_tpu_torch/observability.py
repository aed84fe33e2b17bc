"""Request-level serving telemetry: trace identity, lifecycle traces,
latency histograms, the Retry-After estimate and the Prometheus
exposition (the port's own copies of the JAX package's observability.py
classes, with its semantics and bucket bounds).

- ``TraceContext``: one hop's identity in a distributed trace. A sender
  stamps ``X-Tony-Trace: <trace_id>:<span_id>`` on an outbound hop; the
  receiver adopts the trace_id, records the sender's span_id as its parent
  and mints a fresh span_id for its own work. ``serve`` echoes
  ``X-Tony-Trace-Id: <trace_id>`` on its buffered responses and puts the
  trace_id on a stream's closing frame, and journals ``as_dict()`` with
  the request, so a replayed or recovered request stays in its trace.
- ``RequestTrace``: one request's lifecycle spans on the host monotonic
  clock, in the order the host observed them: ``submitted -> admitted ->
  prefill_done -> first_token -> finished`` for a served request, else a
  terminal of ``cancelled``, ``expired``, ``shed`` or ``failed``. A
  request replayed after a loop crash carries a mid-life ``replayed`` mark
  and a fresh admission chain. ``first_token`` and ``finished`` are marked
  where the host processes a block's tokens, so they lag the card by the
  processing pipeline.
- ``Histogram``: fixed log-spaced buckets, mergeable by addition, with
  quantile estimates and a ``state()``/``restore()`` pair for persistence.
- ``ServingTelemetry``: the named histograms of ``TELEMETRY_HISTOGRAMS``,
  fed from sealed traces and directly by the engine's host timings.
- ``ServiceRateEstimator``: an EWMA of per-request service time, turned
  into a 429's ``Retry-After`` (seconds until a queue seat frees).
- ``PromRenderer``: Prometheus text exposition (format 0.0.4).
- ``DispatchTracker``: dispatch -> ready per device program kind, off the
  hot path. A tracked object only needs ``block_until_ready()``; the
  serving engine hands it a fence over a CUDA event recorded behind the
  dispatch (models/serving.py ``_Fence``).
- ``CompileTelemetry``: the kernel libraries a process built with nvcc or
  loaded from the build directory (ops/_build.py feeds
  ``COMPILE_TELEMETRY``), their seconds, and how many came after the
  warm-up line: the counterpart of the JAX package's XLA compile counters.
"""

from __future__ import annotations

import bisect
import collections
import hashlib
import logging
import math
import os
import re
import threading
import time

log = logging.getLogger(__name__)

__all__ = ["TRACE_HEADER", "TRACE_ID_RESPONSE_HEADER", "TraceContext",
           "TERMINAL_SPANS", "Histogram", "RequestTrace",
           "TELEMETRY_HISTOGRAMS", "ServingTelemetry",
           "ServiceRateEstimator", "PromRenderer", "PROM_CONTENT_TYPE",
           "DispatchTracker", "CompileTelemetry", "COMPILE_TELEMETRY"]

# terminal span names: exactly one ends every trace
TERMINAL_SPANS = ("finished", "cancelled", "expired", "shed", "failed")
# a job task's terminal spans (TaskTrace, the driver's clock)
TASK_TERMINAL_SPANS = ("finished", "failed", "killed", "heartbeat_expired")


class Histogram:
    """Fixed log-spaced-bucket histogram of non-negative values.

    ``per_decade`` buckets between successive powers of ten from ``lo`` to
    ``hi``; values above ``hi`` land in the +Inf overflow bucket, values at
    or below ``lo`` in the first. Bucket ``i`` counts values ``v <=
    bounds[i]`` not in earlier buckets: Prometheus's ``le`` semantics, so
    the exposition is a running sum. ``quantile`` interpolates linearly
    inside the containing bucket (the first bucket's lower edge is 0; the
    overflow bucket reports its lower edge, ``hi``)."""

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, lo: float = 1e-3, hi: float = 120.0,
                 per_decade: int = 5):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
        bounds = [lo * 10 ** (i / per_decade) for i in range(n)]
        # the log series rarely lands on hi exactly: the last finite
        # bucket ends at hi and anything above is +Inf
        self.bounds = [b for b in bounds if b < hi] + [float(hi)]
        self.counts = [0] * (n + 1)         # +1: the +Inf overflow bucket
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.sum += value

    def merge(self, other: "Histogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different buckets")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum

    def quantile(self, q: float) -> float:
        """q in [0, 1] -> estimated value; 0.0 on an empty histogram."""
        if not 0 <= q <= 1:
            raise ValueError(f"quantile wants q in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= rank and c > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.bounds[-1])
                if hi <= lo:                # overflow bucket: lower edge
                    return lo
                return lo + (hi - lo) * max(0.0, rank - seen) / c
            seen += c
        return self.bounds[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        """One histogram's /stats entry: its count and headline quantiles
        (bucket-resolution estimates)."""
        return {
            "count": self.count,
            "mean_s": round(self.mean, 6),
            "p50_s": round(self.quantile(0.50), 6),
            "p90_s": round(self.quantile(0.90), 6),
            "p99_s": round(self.quantile(0.99), 6),
        }

    def state(self) -> dict:
        """The full serializable state (bounds and raw bucket counts):
        ``restore()`` on a fresh histogram resumes the cumulative buckets
        exactly, so a server restart does not zero /metrics."""
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.count, "sum": self.sum}

    def restore(self, state: dict) -> None:
        """Adopt a ``state()`` dump; its bounds must be this histogram's
        (resuming into other buckets would re-bin history)."""
        if list(state["bounds"]) != self.bounds:
            raise ValueError("cannot restore state with different buckets")
        if len(state["counts"]) != len(self.counts):
            raise ValueError("cannot restore state with different buckets")
        self.counts = [int(c) for c in state["counts"]]
        self.count = int(state["count"])
        self.sum = float(state["sum"])


TRACE_HEADER = "X-Tony-Trace"
TRACE_ID_RESPONSE_HEADER = "X-Tony-Trace-Id"

_TRACE_TOKEN = re.compile(r"^[0-9a-f]{8,32}$")


class TraceContext:
    """One hop's identity inside a distributed trace: ``trace_id`` names
    the whole request across tiers, ``span_id`` this process's work on it,
    ``parent_span_id`` the span that caused it (None at the root). It
    travels between processes as the ``X-Tony-Trace`` header and inside
    durable records (the journal's entries) as ``as_dict()``."""

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_span_id: str | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id

    @staticmethod
    def _new_id() -> str:
        return os.urandom(8).hex()

    @classmethod
    def mint(cls) -> "TraceContext":
        """A fresh root context, for a request that came without a trace
        header."""
        return cls(cls._new_id(), cls._new_id(), None)

    @classmethod
    def for_request_id(cls, request_id: str) -> "TraceContext":
        """A root context whose trace_id derives from the client's
        idempotency key, so two front doors that never exchanged a byte
        put one client request into one trace."""
        digest = hashlib.sha256(
            b"tony-trace:" + request_id.encode("utf-8", "replace"))
        return cls(digest.hexdigest()[:16], cls._new_id(), None)

    @classmethod
    def from_header(cls, value: str | None) -> "TraceContext | None":
        """The RECEIVER's context from an inbound ``X-Tony-Trace`` header:
        the same trace, the sender's span as parent, a fresh span_id. None
        for an absent or malformed header (the caller mints a root): a
        garbled proxy header never fails the request."""
        if not value:
            return None
        trace_id, sep, span_id = value.strip().partition(":")
        if not sep or not _TRACE_TOKEN.match(trace_id) \
                or not _TRACE_TOKEN.match(span_id):
            return None
        return cls(trace_id, cls._new_id(), span_id)

    @classmethod
    def from_dict(cls, d: dict | None) -> "TraceContext | None":
        """A context persisted by ``as_dict()``, with the SAME span
        identity (a recovered request continues the dead attempt's span);
        None for anything else."""
        if not isinstance(d, dict):
            return None
        trace_id, span_id = d.get("trace_id"), d.get("span_id")
        if not isinstance(trace_id, str) or not isinstance(span_id, str):
            return None
        parent = d.get("parent_span_id")
        return cls(trace_id, span_id,
                   parent if isinstance(parent, str) else None)

    def child(self) -> "TraceContext":
        """The context a downstream hop runs under: the same trace, this
        span as parent, a fresh span_id."""
        return type(self)(self.trace_id, self._new_id(), self.span_id)

    def to_header(self) -> str:
        return f"{self.trace_id}:{self.span_id}"

    def as_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_span_id": self.parent_span_id}


class RequestTrace:
    """One request's lifecycle spans: (name, t_monotonic) pairs in the
    order the host observed them, plus free-form ``attrs`` (prompt_tokens,
    prefix_hit_blocks, n_tokens, finish_reason, ...). ``submitted_unix``
    anchors the monotonic timeline to the wall clock for display only;
    durations come from the monotonic spans."""

    __slots__ = ("id", "spans", "attrs")

    TERMINALS = TERMINAL_SPANS

    def __init__(self, request_id):
        self.id = request_id
        self.spans: list[tuple[str, float]] = []
        self.attrs: dict = {"submitted_unix": time.time()}

    def mark(self, name: str, t: float | None = None) -> None:
        self.spans.append((name, time.monotonic() if t is None else t))

    def bind(self, ctx: "TraceContext | None") -> "RequestTrace":
        """Attach a distributed-trace identity, carried in ``attrs`` so
        every sealed record is self-describing. A no-op for None."""
        if ctx is not None:
            self.attrs.update(ctx.as_dict())
        return self

    @property
    def ctx(self) -> "TraceContext | None":
        """The bound TraceContext, if any (the inverse of ``bind``)."""
        return TraceContext.from_dict(self.attrs)

    def t(self, name: str) -> float | None:
        for n, t in self.spans:
            if n == name:
                return t
        return None

    def dur(self, a: str, b: str) -> float | None:
        """Seconds from span ``a`` to span ``b``; None unless both were
        recorded."""
        ta, tb = self.t(a), self.t(b)
        return None if ta is None or tb is None else tb - ta

    @property
    def terminal(self) -> str | None:
        if self.spans and self.spans[-1][0] in type(self).TERMINALS:
            return self.spans[-1][0]
        return None

    def last_t(self, name: str) -> float | None:
        """The newest occurrence of span ``name`` (a replayed request
        records its admission chain once per attempt)."""
        for n, t in reversed(self.spans):
            if n == name:
                return t
        return None

    def to_dict(self) -> dict:
        return {"id": self.id,
                "spans": [[n, round(t, 6)] for n, t in self.spans],
                "attrs": dict(self.attrs)}


class TaskTrace(RequestTrace):
    """One job task's lifecycle spans, id ``role:index``, on the DRIVER's
    monotonic clock: ``requested -> allocated -> launched -> registered ->
    first_heartbeat -> running`` (running: the gang barrier opened for the
    task), the executor's spans (``work_dir_ready``, ``child_spawned``,
    ``child_exited``: wall-clock instants re-anchored at receipt), a
    ``restarted`` mark per spent restart-budget unit (the attempt chain
    repeats after it), and one terminal of TASK_TERMINAL_SPANS."""

    __slots__ = ()

    TERMINALS = TASK_TERMINAL_SPANS


# histogram name -> HELP text; the keys are the ServingTelemetry
# vocabulary and, with _s -> _seconds, the /metrics family names
TELEMETRY_HISTOGRAMS = {
    "ttft_s": "time from submit to the host observing the first emitted "
              "token (host monotonic clock; lags the device by the "
              "processing pipeline)",
    "tpot_s": "mean time per output token after the first, per request",
    "queue_wait_s": "time from submit to admission into a slot",
    "e2e_s": "time from submit to the terminal span (any finish reason)",
    "prefill_s": "admission-burst prefill dispatch time (host-side)",
    "decode_block_s": "host dispatch time of one decode block (async "
                      "dispatch, not device execution time)",
    "loop_turn_s": "one ServeApp scheduling turn",
    "device_lag_s": "measured lag between a decode block becoming ready "
                    "on device and the host observing its tokens (the "
                    "pipeline-depth lag, now measured per block instead "
                    "of bounded on paper)",
    "replay_catchup_s": "time from a reset-replay requeue (the "
                        "'replayed' span) to the request's terminal — "
                        "what a loop crash actually cost the request in "
                        "latency instead of failing it",
    "stream_itl_s": "inter-token latency OBSERVED AT THE EMISSION "
                    "POINT: the gap between consecutive token-chunk "
                    "feeds into a request's TokenStream (tokens inside "
                    "one processed block arrive together, so this is "
                    "the between-chunk gap a streaming client actually "
                    "waits — the worst-case per-token spacing)",
}


class ServingTelemetry:
    """The serving path's latency histograms, fed from sealed traces and
    directly for the host's dispatch timings. One per SlotServer; host
    bookkeeping only, no locks (callers hold the serving lock)."""

    def __init__(self):
        self.hist = {name: Histogram() for name in TELEMETRY_HISTOGRAMS}

    def observe(self, name: str, seconds: float) -> None:
        self.hist[name].observe(seconds)

    def observe_trace(self, trace: RequestTrace) -> None:
        """Fold one sealed trace into the histograms. Only recorded spans
        contribute: a shed request feeds e2e (its rejection latency) but
        no ttft."""
        for name, a, b in (("queue_wait_s", "submitted", "admitted"),
                           ("prefill_s", "admitted", "prefill_done"),
                           ("ttft_s", "submitted", "first_token")):
            d = trace.dur(a, b)
            if d is not None:
                self.hist[name].observe(max(0.0, d))
        if trace.spans:
            e2e = trace.spans[-1][1] - trace.spans[0][1]
            self.hist["e2e_s"].observe(max(0.0, e2e))
            # the newest 'replayed' mark to the terminal: what a loop
            # crash cost the request
            rt = trace.last_t("replayed")
            if rt is not None:
                self.hist["replay_catchup_s"].observe(
                    max(0.0, trace.spans[-1][1] - rt))
        n_tokens = trace.attrs.get("n_tokens", 0)
        d = trace.dur("first_token", "finished")
        if d is not None and n_tokens >= 2:
            self.hist["tpot_s"].observe(max(0.0, d) / (n_tokens - 1))

    def snapshot(self) -> dict:
        """{histogram name: {count, mean, p50, p90, p99}} for the
        histograms with observations: ``SlotServer.stats()["latency"]``."""
        return {name: h.snapshot() for name, h in self.hist.items()
                if h.count}

    def state(self) -> dict:
        """Every histogram's bucket state: what ``serve --trace-dir``
        persists across process restarts (``SlotServer.reset()`` keeps
        its telemetry object)."""
        return {name: h.state() for name, h in self.hist.items()}

    def restore(self, state: dict) -> None:
        """Adopt a ``state()`` dump. Unknown histogram names are skipped
        (an old dump must not block a newer server); other buckets
        raise."""
        for name, h_state in state.items():
            if name in self.hist:
                self.hist[name].restore(h_state)


class ServiceRateEstimator:
    """EWMA of per-request service time (admission to the slot-freeing
    terminal), turned into a Retry-After estimate.

    S slots serving at ~``ewma`` seconds a request free at S/ewma a
    second, so Q waiting requests plus the shed one drain in ewma * (Q +
    1) / S seconds: monotone in the queue's depth. Clamped to [1, 60]
    integer seconds (the header's floor; past a minute the answer is
    "overloaded")."""

    __slots__ = ("_ewma", "alpha", "default_s")

    def __init__(self, alpha: float = 0.2, default_s: float = 1.0):
        self.alpha = alpha
        self.default_s = default_s
        self._ewma: float | None = None

    def observe(self, service_s: float) -> None:
        if service_s < 0:
            return
        self._ewma = (service_s if self._ewma is None
                      else self.alpha * service_s
                      + (1 - self.alpha) * self._ewma)

    @property
    def service_time_s(self) -> float:
        return self._ewma if self._ewma is not None else self.default_s

    def retry_after_s(self, queued: int, slots: int) -> int:
        eta = self.service_time_s * (max(0, queued) + 1) / max(1, slots)
        return int(min(60, max(1, math.ceil(eta))))


# ------------------------------------------------------------- exposition


class DispatchTracker:
    """Dispatch -> ready attribution for device programs enqueued without
    a wait (the JAX package's observability.py:510, with its API, bounds
    and counters).

    Every dispatch registers one object whose ``block_until_ready()``
    returns once the dispatch has run (``track``); one background thread,
    ``dispatch-reaper``, waits on them in dispatch order and records each
    ready instant. Dispatch order is stream order, so when entry N is
    ready every earlier one is too, and the serial walk never waits on
    anything the card has passed. That gives, off the hot path:

    - a dispatch -> ready Histogram per program ``kind`` (prefill,
      decode_block, prefix_copy, ...): how long the card spent behind
      each dispatch, which the host's dispatch timing cannot see;
    - ``in_flight``: dispatched, not yet observed ready (the measured
      pipeline depth);
    - ``ready_time(seq)``: one dispatch's ready instant, which the serving
      engine subtracts from its observation instant (``device_lag_s``).

    Host-side only: no torch here. The wait must release the interpreter
    lock and must not spin (the engine's fences wait on CUDA events made
    with ``blocking=True``), or the reaper would compete with the serving
    loop for the host. ``reset()`` drops pending entries and recorded
    instants without waiting on them (after a failed dispatch they may
    never complete) and re-arms the same thread; ``shutdown()`` stops it
    for good."""

    # reaped ready instants kept for ready_time(): callers ask about the
    # few blocks of the processing pipeline, so a small ring bounds memory
    READY_KEEP = 512

    def __init__(self, max_pending: int = 1024):
        self.max_pending = max_pending
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._ready: collections.OrderedDict[int, float] = \
            collections.OrderedDict()
        self.hist: dict[str, Histogram] = {}
        self._seq = 0
        self._gen = 0               # bumped by reset(): stale entries drop
        self._busy = False          # the reaper is waiting on an entry
        self._busy_seq = -1         # which one
        self.tracked_total = 0
        self.dropped = 0            # queue full: the reaper fell behind
        self.reap_errors = 0        # block_until_ready raised
        self._stop = False
        self._thread = threading.Thread(
            target=self._reap, name="dispatch-reaper", daemon=True)
        self._thread.start()

    def track(self, kind: str, buf) -> int:
        """Register one dispatch's fence -> its sequence number
        (monotonic). The hot path pays a lock and an append; the wait is
        the reaper's."""
        with self._cv:
            self._seq += 1
            seq = self._seq
            if self._stop:
                return seq
            if len(self._queue) >= self.max_pending:
                # a wedged reaper must not grow host memory: the dispatch
                # loses its telemetry, nothing else
                self.dropped += 1
                return seq
            self.tracked_total += 1
            self._queue.append((seq, kind, time.monotonic(), buf,
                                self._gen))
            self._cv.notify_all()
        return seq

    def _reap(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                seq, kind, t0, buf, gen = self._queue.popleft()
                self._busy, self._busy_seq = True, seq
            try:
                buf.block_until_ready()
                t_ready = time.monotonic()
            except Exception:
                # a fence that cannot be waited on (a stub without the
                # method, a failed dispatch's event): counted, and the
                # tracker outlives it
                t_ready = None
                with self._lock:
                    self.reap_errors += 1
            with self._cv:
                if t_ready is not None and gen == self._gen:
                    h = self.hist.get(kind)
                    if h is None:
                        h = self.hist[kind] = Histogram()
                    h.observe(max(0.0, t_ready - t0))
                    self._ready[seq] = t_ready
                    while len(self._ready) > self.READY_KEEP:
                        self._ready.popitem(last=False)
                self._busy = False
                self._cv.notify_all()

    def ready_time(self, seq: int, timeout: float = 0.0) -> float | None:
        """The recorded ready instant of dispatch ``seq``, or None when it
        was never tracked, was evicted or is not reaped within
        ``timeout`` seconds. Callers ask right after waiting for that
        dispatch themselves, so the reaper's walk up to it returns at
        once and the wait is short unless the reaper is wedged."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                t = self._ready.get(seq)
                if t is not None or seq > self._seq:
                    return t
                pending = (self._busy and self._busy_seq == seq) or any(
                    s == seq for s, *_ in self._queue)
                if not pending:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)

    @property
    def in_flight(self) -> int:
        """Dispatches registered and not yet observed ready."""
        with self._lock:
            return len(self._queue) + (1 if self._busy else 0)

    def drain(self, timeout: float = 5.0) -> bool:
        """Wait until every tracked dispatch is reaped (or ``timeout``
        passes) -> whether it is."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._queue or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    def reset(self) -> None:
        """Drop pending entries and recorded instants without waiting on
        them; the same thread serves the next generation. The histograms
        are cumulative and survive, as ``ServingTelemetry``'s do across
        ``SlotServer.reset()``."""
        with self._cv:
            self._gen += 1
            self._queue.clear()
            self._ready.clear()
            self._cv.notify_all()

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the reaper (idempotent); pending entries are dropped
        unwaited."""
        with self._cv:
            self._stop = True
            self._queue.clear()
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._stop

    def snapshot(self) -> dict:
        """``SlotServer.stats()["device"]``: the counters and each kind's
        dispatch -> ready quantiles."""
        with self._lock:
            return {
                "in_flight": len(self._queue) + (1 if self._busy else 0),
                "tracked": self.tracked_total,
                "dropped": self.dropped,
                "reap_errors": self.reap_errors,
                "dispatch_ready": {k: h.snapshot()
                                   for k, h in self.hist.items()},
            }

    def histograms(self) -> dict[str, Histogram]:
        """Copies of the per-kind histograms taken under the tracker's
        lock, safe to render while the reaper observes into the
        originals."""
        with self._lock:
            states = {k: h.state() for k, h in self.hist.items()}
        out = {}
        for k, st in states.items():
            h = Histogram()
            h.restore(st)
            out[k] = h
        return out


# what ops/_build.py notes for a kernel library: compiled by nvcc in this
# process, or loaded from build/kernels/ where an earlier process left it
KERNEL_EVENTS = ("build", "load")


class CompileTelemetry:
    """Kernel-library build visibility (the JAX package's
    observability.py:719 ``CompileTelemetry``, with its API and histogram
    bounds). The port compiles no XLA programs: what it compiles is its
    kernel libraries, each built by nvcc at first use or loaded from the
    build directory. ``ops/_build.py`` notes each library once a process
    (``note("build", nvcc seconds)`` or ``note("load", seconds)``), so
    ``builds`` counts the libraries this process built or loaded.
    ``mark_warm()`` draws the warm-up line (a training loop's first
    measured step, serve's first delivered completion): a library made
    ready after it cost a request or a step its seconds, and
    ``storm_threshold`` of them log one loud warning."""

    def __init__(self, storm_threshold: int = 8):
        # nvcc runs seconds to minutes: wider buckets than the latency
        # histograms' 120 s ceiling
        self.hist = Histogram(lo=1e-3, hi=600.0)
        self.builds = 0
        self.nvcc_builds = 0
        self.build_time_s = 0.0
        self.storm_threshold = storm_threshold
        self._warm_at: int | None = None
        self._storm_warned = False
        self._lock = threading.Lock()

    def note(self, event: str, duration_s: float) -> None:
        if event not in KERNEL_EVENTS:
            return
        with self._lock:
            self.builds += 1
            self.nvcc_builds += event == "build"
            self.build_time_s += duration_s
            self.hist.observe(duration_s)
            storm = (self._warm_at is not None
                     and not self._storm_warned
                     and self.builds - self._warm_at
                     >= self.storm_threshold)
            if storm:
                self._storm_warned = True
        if storm:
            log.warning(
                "kernel build storm: %d kernel libraries built or loaded "
                "after warm-up (%.1fs in all): a steady-state workload "
                "should need no new library", self.builds - self._warm_at,
                self.build_time_s)

    def mark_warm(self) -> None:
        """Draw the warm-up line (idempotent: only the first call
        counts)."""
        with self._lock:
            if self._warm_at is None:
                self._warm_at = self.builds

    @property
    def recompiles_post_warm(self) -> int:
        """Libraries built or loaded after the warm-up line."""
        with self._lock:
            if self._warm_at is None:
                return 0
            return self.builds - self._warm_at

    def hist_copy(self) -> Histogram:
        """A consistent copy of the build-seconds histogram, safe to
        render while a build thread feeds the original."""
        with self._lock:
            state = self.hist.state()
        h = Histogram(lo=1e-3, hi=600.0)
        h.restore(state)
        return h

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "kernel_builds": self.builds,
                "kernel_nvcc_builds": self.nvcc_builds,
                "kernel_build_time_s": round(self.build_time_s, 3),
                "kernel_builds_post_warm": (
                    self.builds - self._warm_at
                    if self._warm_at is not None else 0),
                "warm": self._warm_at is not None,
            }


# the process's instance: ops/_build.py feeds it, every StepTimer and
# ServeApp reads it
COMPILE_TELEMETRY = CompileTelemetry()


_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _sanitize(name: str) -> str:
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return name if _NAME_OK.match(name) else "_" + name


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labels(labels: dict | None) -> str:
    if not labels:
        return ""
    esc = {ord("\\"): "\\\\", ord('"'): '\\"', ord("\n"): "\\n"}
    return "{" + ",".join(
        f'{_sanitize(k)}="{str(v).translate(esc)}"'
        for k, v in labels.items()) + "}"


class PromRenderer:
    """Prometheus text-format (0.0.4) builder: ``# HELP``/``# TYPE`` once
    a family, on first use; a family's label sets group under it."""

    def __init__(self):
        self._families: dict[str, list[str]] = {}
        self._order: list[str] = []

    def _family(self, name: str, kind: str, help_text: str) -> list[str]:
        name = _sanitize(name)
        fam = self._families.get(name)
        if fam is None:
            fam = []
            if help_text:
                fam.append(f"# HELP {name} {help_text}")
            fam.append(f"# TYPE {name} {kind}")
            self._families[name] = fam
            self._order.append(name)
        return fam

    def gauge(self, name: str, value: float, help_text: str = "",
              labels: dict | None = None) -> None:
        self._sample(name, "gauge", value, help_text, labels)

    def counter(self, name: str, value: float, help_text: str = "",
                labels: dict | None = None) -> None:
        self._sample(name, "counter", value, help_text, labels)

    def _sample(self, name, kind, value, help_text, labels) -> None:
        fam = self._family(name, kind, help_text)
        fam.append(f"{_sanitize(name)}{_labels(labels)} {_fmt(value)}")

    def histogram(self, name: str, hist: Histogram,
                  help_text: str = "", labels: dict | None = None) -> None:
        """Cumulative ``_bucket`` lines (``le`` after any ``labels``),
        then ``_sum`` and ``_count``."""
        name = _sanitize(name)
        fam = self._family(name, "histogram", help_text)
        base = _labels(labels)[1:-1] if labels else ""
        prefix = base + "," if base else ""
        cum = 0
        for bound, c in zip(hist.bounds + [math.inf], hist.counts):
            cum += c
            fam.append(
                f'{name}_bucket{{{prefix}le="{_fmt(bound)}"}} {cum}')
        suffix = "{" + base + "}" if base else ""
        fam.append(f"{name}_sum{suffix} {_fmt(hist.sum)}")
        fam.append(f"{name}_count{suffix} {hist.count}")

    def render(self) -> str:
        return "\n".join(
            line for fam in self._order for line in self._families[fam]
        ) + "\n"


PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
