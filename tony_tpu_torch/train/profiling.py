"""Profiling and step timing (port of the JAX package's train/profiling.py).

``trace`` captures a ``torch.profiler`` trace (Chrome trace JSON, viewable in
Perfetto) into a directory. ``StepTimer`` writes the same JSONL step records
as the JAX package's, with its checkpoint-recency fields
(``note_checkpoint``), the process's kernel-library build counters
(observability.py ``COMPILE_TELEMETRY``: ``kernel_builds``,
``kernel_build_time_s``, ``kernel_builds_post_warm``, the counterparts of
the JAX package's ``xla_*`` keys) and, given a CUDA device, the device's
memory peak (``gpu_memory_peak_mb``: ``torch.cuda.max_memory_allocated``
in MiB; the key is left out on the CPU). It polls the executor's
preemption flag file, and at record cadence the profile flag
(``<step log>.profile``, JSON ``{"seconds": N, "out_dir": path}``): a
``torch.profiler`` capture of the CPU and, on a card, CUDA activity for N
seconds, written as Chrome-trace JSON into ``out_dir``. ``serve``'s loop
times its scheduling turns with it too (``reset_interval`` skips the idle
gaps; ``compile_warm_on_step=False``: serve draws the warm-up line at its
first delivered completion).
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
from ..observability import COMPILE_TELEMETRY, Histogram

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


# the on-demand capture in progress: (torch.profiler.profile, its out_dir)
_capture: tuple | None = None


def _start_profiler(log_dir: str) -> None:
    """Start a ``torch.profiler`` capture of the CPU and, when CUDA is up,
    the card into ``log_dir`` (``_stop_profiler`` writes it). One seam, so
    tests can stub the profiler."""
    global _capture
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _capture = (prof, log_dir)


def _stop_profiler() -> None:
    """Stop the capture and write ``<out_dir>/trace.<pid>.json``. On the
    card the work queued so far finishes first, so the trace holds every
    kernel the captured steps launched."""
    global _capture
    prof, log_dir = _capture
    _capture = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(str(Path(log_dir) / f"trace.{os.getpid()}.json"))


class StepTimer:
    """Rolling step-time stats written as JSONL every ``window`` steps.
    Durations come from ``time.monotonic()``; the record's ``ts`` is wall
    clock and only labels the line. ``compile_warm_on_step`` (default
    True): the first measured step draws the process's kernel-build
    warm-up line (a training loop has then run every kernel it needs).
    ``device``: the training's device; a CUDA device adds its memory peak
    to every record."""

    def __init__(self, out_path: str | Path | None = None, window: int = 50,
                 compile_warm_on_step: bool = True, device=None):
        self._out = Path(out_path) if out_path else None
        self._window = window
        self._compile_warm_on_step = compile_warm_on_step
        self._compile = COMPILE_TELEMETRY
        self._device = (torch.device(device) if device is not None
                        else None)
        self._t_last: float | None = None
        self._times: list[float] = []
        self.hist = Histogram()
        self.step = 0
        # the on-demand capture: `<out_path>.profile` is the flag file the
        # executor writes, polled at record cadence, never per step
        self._profile_stop_t: float | None = None
        self._atexit_armed = False
        # preemption drain: the executor drops `<out_path>.preempt`; the
        # poll is time-gated (every ~0.25 s), never per step
        self.preempt_requested = False
        self._preempt_poll_t = 0.0
        # checkpoint recency (note_checkpoint): rides the JSONL records so
        # the job's metrics can show the checkpoint's age centrally
        self._ckpt_step: int | None = None
        self._ckpt_ts: float | None = None

    def tick(self, **extra) -> float | None:
        """Call once per training step; returns the last step's duration.
        ``extra`` rides the step's record; a tensor (a step's loss) is read
        to the host only when a record is written."""
        now = time.monotonic()
        dt = None
        if self._t_last is not None:
            dt = now - self._t_last
            self._times.append(dt)
            if len(self._times) > self._window:
                self._times.pop(0)
            self.hist.observe(dt)
            if self._compile_warm_on_step:
                self._compile.mark_warm()
        self._t_last = now
        self.step += 1
        if self._profile_stop_t is not None and now >= self._profile_stop_t:
            self._finish_profile()
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
                **{k: float(v) if isinstance(v, torch.Tensor) else v
                   for k, v in extra.items()},
            }
            snap = self._compile.snapshot()
            for key in ("kernel_builds", "kernel_build_time_s",
                        "kernel_builds_post_warm"):
                rec[key] = snap[key]
            if self._device is not None and self._device.type == "cuda":
                rec["gpu_memory_peak_mb"] = round(
                    torch.cuda.max_memory_allocated(self._device) / 2**20,
                    3)
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
            self._poll_profile_flag()
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

    # ------------------------------------------- on-demand profiler capture
    @property
    def _flag_path(self) -> Path | None:
        """``<step log>.profile``: the executor relays a driver's profile
        command into this process through it."""
        if self._out is None:
            return None
        return self._out.with_name(self._out.name + c.PROFILE_REQUEST_SUFFIX)

    def _poll_profile_flag(self) -> None:
        flag = self._flag_path
        if flag is None or self._profile_stop_t is not None:
            return
        try:
            if not flag.exists():
                return
            req = json.loads(flag.read_text())
            flag.unlink()
            # inside the tolerant block: JSON that is not an object, or a
            # seconds that is not a number, is dropped as a torn flag is
            seconds = float(req.get("seconds", 5.0))
            out_dir = str(req.get("out_dir")
                          or self._out.parent / c.PROFILE_DIR_NAME
                          / f"step{self.step}")
        except (OSError, ValueError, TypeError, AttributeError) as e:
            # a torn or unreadable request must not stop training; the
            # flag goes, so it cannot wedge the next request
            log.warning("profile request unreadable: %s", e)
            try:
                flag.unlink()
            except OSError:
                pass
            return
        try:
            _start_profiler(out_dir)
        except Exception:
            log.exception("profiler capture failed to start")
            return
        self._profile_stop_t = time.monotonic() + max(0.0, seconds)
        # the loop may end inside the window: close() (called at the
        # loop's end, and at exit) writes what was captured
        if not self._atexit_armed:
            import atexit

            atexit.register(self.close)
            self._atexit_armed = True
        log.info("profiler capture started (%.1fs) -> %s", seconds, out_dir)

    def _finish_profile(self) -> None:
        self._profile_stop_t = None
        try:
            _stop_profiler()
            log.info("profiler capture finished")
        except Exception:
            log.exception("profiler capture failed to stop")

    def close(self) -> None:
        """Stop a capture in progress early, so its trace is written
        (idempotent): at the training loop's end and at exit, a window
        that outlives the loop still gives a trace of what ran."""
        if self._profile_stop_t is not None:
            log.info("capture window outlived the loop: stopping early")
            self._finish_profile()

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
