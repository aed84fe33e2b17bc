"""Profiling and step timing (port of the JAX package's train/profiling.py).

``trace`` captures a ``torch.profiler`` trace (Chrome trace JSON, viewable in
Perfetto) into a directory. ``StepTimer`` writes the same JSONL step records
as the JAX package's and polls the executor's preemption flag file. Not
ported yet: the XLA compile counters and the on-demand profiler capture
(ROADMAP queue 1, observability item) and the checkpoint-recency fields
(the checkpoint slice).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import logging
import math
import os
import time
from pathlib import Path

import torch

from .. import constants as c

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str | Path, enabled: bool = True):
    """Capture a torch.profiler trace of the block into
    ``log_dir/trace.<pid>.json`` (host activity, and the card's when there
    is one)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / f"trace.{os.getpid()}.json"))


class Histogram:
    """Fixed log-spaced-bucket histogram of non-negative values (the JAX
    package's observability.Histogram, observe and quantile only).
    ``quantile`` interpolates linearly inside the containing bucket."""

    def __init__(self, lo: float = 1e-3, hi: float = 120.0,
                 per_decade: int = 5):
        n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
        bounds = [lo * 10 ** (i / per_decade) for i in range(n)]
        self.bounds = [b for b in bounds if b < hi] + [float(hi)]
        self.counts = [0] * (n + 1)         # +1: the +Inf overflow bucket
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.count += 1

    def quantile(self, q: float) -> float:
        """q in [0, 1] -> estimated value; 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, n in enumerate(self.counts):
            if seen + n >= rank and n > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
                if hi <= lo:                # overflow bucket: lower edge
                    return lo
                return lo + (hi - lo) * max(0.0, rank - seen) / n
            seen += n
        return self.bounds[-1]


class StepTimer:
    """Rolling step-time stats written as JSONL every ``window`` steps.
    Durations come from ``time.monotonic()``; the record's ``ts`` is wall
    clock and only labels the line."""

    def __init__(self, out_path: str | Path | None = None, window: int = 50):
        self._out = Path(out_path) if out_path else None
        self._window = window
        self._t_last: float | None = None
        self._times: list[float] = []
        self.hist = Histogram()
        self.step = 0
        # preemption drain: the executor drops `<out_path>.preempt`; the
        # poll is time-gated (every ~0.25 s), never per step
        self.preempt_requested = False
        self._preempt_poll_t = 0.0

    def tick(self, **extra) -> float | None:
        """Call once per training step; returns the last step's duration."""
        now = time.monotonic()
        dt = None
        if self._t_last is not None:
            dt = now - self._t_last
            self._times.append(dt)
            if len(self._times) > self._window:
                self._times.pop(0)
            self.hist.observe(dt)
        self._t_last = now
        self.step += 1
        if now - self._preempt_poll_t >= 0.25:
            self._preempt_poll_t = now
            self._poll_preempt_flag()
        if self._out and dt is not None and self.step % self._window == 0:
            rec = {
                "step": self.step,
                "mean_step_s": sum(self._times) / len(self._times),
                "steps_per_sec": len(self._times) / sum(self._times),
                "p50_s": round(self.hist.quantile(0.5), 6),
                "p99_s": round(self.hist.quantile(0.99), 6),
                "ts": time.time(),
                **extra,
            }
            # best effort: a missing log dir or a full disk must not kill
            # the training loop
            try:
                self._out.parent.mkdir(parents=True, exist_ok=True)
                with open(self._out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError as e:
                log.warning("step log write failed: %s", e)
        return dt

    def _poll_preempt_flag(self) -> None:
        """Check for the executor's ``<out>.preempt`` drain notice. Sticky
        once seen: the loop exits EXIT_PREEMPTED at its step boundary."""
        if self.preempt_requested or self._out is None:
            return
        flag = self._out.with_name(self._out.name + c.PREEMPT_REQUEST_SUFFIX)
        try:
            present = flag.exists()
        except OSError:
            return
        if not present:
            return
        try:
            flag.unlink()
        except OSError:
            # presence is the signal; a failed unlink only risks a second,
            # idempotent notice
            pass
        log.warning("preemption notice received: exit at this step boundary")
        self.preempt_requested = True

    @property
    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)


__all__ = ["trace", "StepTimer", "Histogram"]
