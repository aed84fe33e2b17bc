"""Profiling and step timing (port of the JAX package's train/profiling.py).

``trace`` captures a ``torch.profiler`` trace (Chrome trace JSON, viewable in
Perfetto) into a directory. ``StepTimer`` writes the same JSONL step records
as the JAX package's, with its checkpoint-recency fields
(``note_checkpoint``), and polls the executor's preemption flag file; its
histogram is observability.py's. ``serve``'s loop times its scheduling
turns with it too (``reset_interval`` skips the idle gaps). Not ported
yet: the XLA compile counters and the on-demand profiler capture (ROADMAP
queue 1, observability item).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from pathlib import Path

import torch

from .. import constants as c
from ..observability import Histogram

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
        # checkpoint recency (note_checkpoint): rides the JSONL records so
        # the job's metrics can show the checkpoint's age centrally
        self._ckpt_step: int | None = None
        self._ckpt_ts: float | None = None

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
            if self._ckpt_step is not None:
                rec["last_ckpt_step"] = self._ckpt_step
                rec["last_ckpt_ts"] = self._ckpt_ts
            # best effort: a missing log dir or a full disk must not kill
            # the training loop
            try:
                self._out.parent.mkdir(parents=True, exist_ok=True)
                with open(self._out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError as e:
                log.warning("step log write failed: %s", e)
        return dt

    def note_checkpoint(self, step: int) -> None:
        """Tell the timer a checkpoint of ``step`` was written or handed to
        the writer: the next JSONL record carries ``last_ckpt_step`` and
        ``last_ckpt_ts``."""
        self._ckpt_step = int(step)
        self._ckpt_ts = time.time()

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

    def reset_interval(self) -> None:
        """Forget the last tick's instant (the rolling window stays): a
        serving loop that idles between requests must not record the gap
        as one giant step when work resumes."""
        self._t_last = None

    @property
    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)


__all__ = ["trace", "StepTimer"]
