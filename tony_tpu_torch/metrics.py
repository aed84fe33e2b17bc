"""Metric names, the max/average accumulator and the executor's sampler
(the port's own copies of the JAX package's metrics.py constants,
``MetricsAccumulator`` and ``TaskMonitor``).

The names are one contract between ``serve``'s /stats ``metrics``
snapshot, its GET /metrics families, the driver's /metrics and the tests.
The *_total names are cumulative counters sampled as gauges: their max_
snapshot is the running total.

``TaskMonitor`` samples the user process tree's RSS from /proc, the task's
card through ``nvidia-smi`` (``sample_gpu_metrics``, the counterpart of the
JAX package's libtpu duty cycle and HBM sampler) and the training child's
StepTimer JSONL (step times, kernel-library builds, the device-memory
peak), and pushes max and mean to the driver over the metrics RPC. It imports no torch: the executor never holds a CUDA context.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import threading
import time
from typing import Any

log = logging.getLogger(__name__)

MEMORY_RSS = "memory_rss_mb"
# the task's card, read by nvidia-smi: utilization.gpu (percent of the
# sample period a kernel ran: the counterpart of libtpu's duty_cycle_pct)
# and memory.used (the counterpart of hbm_capacity_usage), MB; the card's
# nvidia-smi index rides along
GPU_UTILIZATION = "gpu_utilization_pct"
GPU_MEMORY_USED = "gpu_memory_used_mb"
GPU_MEMORY_TOTAL = "gpu_memory_total_mb"
GPU_INDEX = "gpu_index"
# the training child's device-memory peak (torch.cuda.max_memory_allocated,
# MiB), sampled from its StepTimer records: the counterpart of the JAX
# package's tpu_hbm_peak_mb; absent (never 0) when the child trains on the
# CPU
GPU_MEMORY_PEAK = "gpu_memory_peak_mb"

# serving-load gauges, fed by cli/serve.ServeApp once a scheduling turn
SERVING_ACTIVE_SLOTS = "serving_active_slots"
SERVING_QUEUE_DEPTH = "serving_queue_depth"
SERVING_PREFILL_REUSED_FRAC = "serving_prefill_reused_frac"
SERVING_SHED_TOTAL = "serving_shed_total"
SERVING_CANCELLED_TOTAL = "serving_cancelled_total"
SERVING_EXPIRED_TOTAL = "serving_expired_total"
SERVING_LOOP_RESTARTS = "serving_loop_restarts"
# latency quantiles sampled from the observability histograms (host
# monotonic spans); the histograms themselves are on GET /metrics
SERVING_TTFT_P50_S = "serving_ttft_p50_s"
SERVING_TTFT_P99_S = "serving_ttft_p99_s"
SERVING_TPOT_P50_S = "serving_tpot_p50_s"
SERVING_TPOT_P99_S = "serving_tpot_p99_s"
SERVING_RETRY_AFTER_S = "serving_retry_after_s"
# request durability: admissions resumed from a journaled prefix, and the
# emitted tokens carried across the failure
SERVING_REPLAYS_TOTAL = "serving_replays_total"
SERVING_REPLAYED_TOKENS_TOTAL = "serving_replayed_tokens_total"
# streaming delivery: live SSE streams, streams ever opened, feeds that
# found a stream's chunk queue full (coalesced, never dropped), clients
# that vanished mid-stream
SERVING_STREAMS_ACTIVE = "serving_streams_active"
SERVING_STREAMS_OPENED_TOTAL = "serving_streams_opened_total"
SERVING_STREAM_STALLS_TOTAL = "serving_stream_backpressure_stalls_total"
SERVING_STREAM_DISCONNECTS_TOTAL = "serving_stream_disconnects_total"
# the paged pool's blocks by owner {state=free|slot|trie|shared}, and KV
# block transfer (which reads 0 until disaggregated roles are ported)
SERVING_KV_POOL_BLOCKS = "serving_kv_pool_blocks"
SERVING_KV_EXPORTS_TOTAL = "serving_kv_exports_total"
SERVING_KV_IMPORTS_TOTAL = "serving_kv_imports_total"
SERVING_KV_IMPORT_REJECTS_TOTAL = "serving_kv_import_rejects_total"
# multi-model serving (models/registry.py): the info gauge, one series a
# registered serving model (value 1); the serving families repeat with a
# {model="..."} label beside the unlabeled process aggregates
SERVING_MODELS = "serving_models"
# speculative serving (models/serving.py _spec_block), per model: verify
# rounds, draft proposals verified and accepted (host-observed, behind
# the pipeline), the next round's gamma, and the acceptance-rate and
# verify-rounds-per-request histograms
SERVING_SPEC_ROUNDS_TOTAL = "serving_spec_rounds_total"
SERVING_SPEC_PROPOSED_TOKENS_TOTAL = "serving_spec_proposed_tokens_total"
SERVING_SPEC_ACCEPTED_TOKENS_TOTAL = "serving_spec_accepted_tokens_total"
SERVING_SPEC_GAMMA = "serving_spec_gamma"
SERVING_SPEC_ACCEPTANCE_RATE = "serving_spec_acceptance_rate"
SERVING_SPEC_VERIFY_ROUNDS = "serving_spec_verify_rounds"


class MetricsAccumulator:
    """Max and running average per metric."""

    def __init__(self) -> None:
        self._count: dict[str, int] = {}
        self._avg: dict[str, float] = {}
        self._max: dict[str, float] = {}

    def observe(self, name: str, value: float) -> None:
        n = self._count.get(name, 0)
        self._avg[name] = (self._avg.get(name, 0.0) * n + value) / (n + 1)
        self._count[name] = n + 1
        self._max[name] = max(self._max.get(name, float("-inf")), value)

    def set(self, name: str, value: float) -> None:
        """Overwrite, for cumulative counters: averaging a monotone
        total's successive values means nothing, so both snapshots report
        the latest total."""
        self._count[name] = 1
        self._avg[name] = value
        self._max[name] = value

    def snapshot(self) -> list[dict[str, Any]]:
        out = []
        for name in sorted(self._count):
            out.append({"name": f"max_{name}", "value": self._max[name]})
            out.append({"name": f"avg_{name}",
                        "value": round(self._avg[name], 3)})
        return out


# driver-side cluster telemetry (Driver.render_metrics on the driver's GET
# /metrics; the subset of the JAX package's families the port's driver has)
DRIVER_GANG_LAUNCH_SECONDS = "driver_gang_launch_seconds"
DRIVER_HEARTBEAT_INTERVAL_SECONDS = "driver_heartbeat_interval_seconds"
DRIVER_TASK_RESTARTS_TOTAL = "driver_task_restarts_total"
DRIVER_HEARTBEAT_EXPIRED_TOTAL = "driver_heartbeat_expired_total"
DRIVER_STRAGGLER_REGISTRATION_S = "driver_straggler_registration_s"
DRIVER_STRAGGLER_HEARTBEAT_S = "driver_straggler_heartbeat_s"
DRIVER_TASKS = "driver_tasks"
DRIVER_TASK_METRIC = "driver_task_metric"
DRIVER_TASK_SERVICE_PORT = "driver_task_service_port"
DRIVER_CHECKPOINT_AGE_S = "driver_checkpoint_age_s"
# elastic training: preemption drains relayed or reported (budget-free
# relaunches) and gang resizes (down on a worker lost past its budget, up
# when capacity returns)
DRIVER_PREEMPTIONS_TOTAL = "driver_preemptions_total"
DRIVER_GANG_RESIZES_TOTAL = "driver_gang_resizes_total"

# executor-accumulator names (ride update_metrics pushes; on the driver's
# /metrics as driver_task_metric{name="max_..."} and in TASK_FINISHED)
HEARTBEAT_RTT_MS = "heartbeat_rtt_ms"
HEARTBEATS_MISSED = "heartbeats_missed"
CHILD_ALIVE = "child_alive"
STEP_TIME_MEAN_S = "step_time_mean_s"
STEP_TIME_P50_S = "step_time_p50_s"
STEP_TIME_P99_S = "step_time_p99_s"
STEPS_PER_SEC = "steps_per_sec"
TRAIN_STEP = "train_step"
CKPT_STEP = "ckpt_step"
CKPT_UNIX_TS = "ckpt_unix_ts"
# the kernel libraries the training child built with nvcc or loaded
# (observability.CompileTelemetry's snapshot in every StepTimer record),
# their seconds, and those after its first measured step: the
# counterparts of the JAX package's xla_compiles, xla_compile_time_s and
# xla_recompiles_post_warm. A nonzero post-warm count on a steady-state
# job is a library built mid-run
KERNEL_BUILDS = "kernel_builds"
KERNEL_BUILD_TIME_S = "kernel_build_time_s"
KERNEL_BUILDS_POST_WARM = "kernel_builds_post_warm"
# cumulative totals: set semantics (latest total) in the accumulator
_COUNTER_NOTES = frozenset({HEARTBEATS_MISSED, KERNEL_BUILDS,
                            KERNEL_BUILD_TIME_S, KERNEL_BUILDS_POST_WARM,
                            TRAIN_STEP, CKPT_STEP, CKPT_UNIX_TS, GPU_INDEX,
                            GPU_MEMORY_TOTAL})


def _proc_tree_rss_mb(root_pid: int) -> float:
    """Sum RSS over root_pid and its descendants via /proc (the JAX
    package's Python walk; its C++ fast path is not ported)."""
    children: dict[int, list[int]] = {}
    try:
        for entry in os.listdir("/proc"):
            if not entry.isdigit():
                continue
            pid = int(entry)
            try:
                with open(f"/proc/{pid}/stat") as f:
                    fields = f.read().split()
                ppid = int(fields[3])
            except (OSError, IndexError, ValueError):
                continue
            children.setdefault(ppid, []).append(pid)
    except OSError:
        return 0.0
    tree, stack = set(), [root_pid]
    while stack:
        pid = stack.pop()
        if pid in tree:
            continue
        tree.add(pid)
        stack.extend(children.get(pid, []))
    total_kb = 0
    for pid in tree:
        try:
            with open(f"/proc/{pid}/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        total_kb += int(line.split()[1])
                        break
        except (OSError, ValueError):
            continue
    return total_kb / 1024.0


_NVIDIA_SMI_QUERY = ["nvidia-smi",
                     "--query-gpu=index,utilization.gpu,memory.used,"
                     "memory.total", "--format=csv,noheader,nounits"]


def visible_gpu_indices(rows: list[list[str]]) -> list[int]:
    """The nvidia-smi indices this process's CUDA would see, in CUDA's
    order: CUDA_VISIBLE_DEVICES's integer entries when it is set, else
    every card nvidia-smi lists."""
    listed = [int(r[0]) for r in rows]
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is None:
        return listed
    out = []
    for part in vis.split(","):
        part = part.strip()
        if part.isdigit() and int(part) in listed:
            out.append(int(part))
    return out


def task_gpu_index(rank: int, rows: list[list[str]]) -> int | None:
    """The card a rank takes: ``rank % visible cards``, the rule of
    train/bootstrap.py ``init()`` (the executor isolates no cards)."""
    visible = visible_gpu_indices(rows)
    return visible[rank % len(visible)] if visible else None


def parse_gpu_query(text: str) -> list[list[str]]:
    """nvidia-smi's csv,noheader,nounits rows -> lists of stripped
    fields; malformed rows are dropped."""
    rows = []
    for line in text.splitlines():
        fields = [f.strip() for f in line.split(",")]
        if len(fields) == 4 and fields[0].isdigit():
            rows.append(fields)
    return rows


def sample_gpu_metrics(rank: int = 0, explain: bool = False):
    """The task's card through ``nvidia-smi --query-gpu=index,
    utilization.gpu,memory.used,memory.total --format=csv,noheader,
    nounits``: {gpu_index, gpu_utilization_pct, gpu_memory_used_mb,
    gpu_memory_total_mb} for card ``rank % visible cards``; {} where no
    nvidia-smi answers. A subprocess, never a CUDA call: the sampler runs
    in the executor, which must hold no CUDA context.

    ``explain=True`` returns ``(metrics, reason)``; ``reason`` says why the
    sample is empty (None when it is not), as the JAX package's
    ``sample_tpu_metrics(explain=True)`` does."""
    try:
        proc = subprocess.run(_NVIDIA_SMI_QUERY, capture_output=True,
                              text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired) as e:
        return ({}, f"nvidia-smi not runnable: {e!r}") if explain else {}
    if proc.returncode != 0:
        reason = (f"nvidia-smi exited {proc.returncode}: "
                  f"{proc.stderr.strip()[-200:]}")
        return ({}, reason) if explain else {}
    rows = parse_gpu_query(proc.stdout)
    index = task_gpu_index(rank, rows)
    out: dict[str, float] = {}
    for r in rows:
        if int(r[0]) != index:
            continue
        for name, raw in ((GPU_UTILIZATION, r[1]), (GPU_MEMORY_USED, r[2]),
                          (GPU_MEMORY_TOTAL, r[3])):
            try:
                out[name] = float(raw)
            except ValueError:
                pass    # "[N/A]" on a card that does not report it
        out[GPU_INDEX] = float(index)
    if explain:
        return out, (None if out else
                     f"no visible card in nvidia-smi's rows {rows}")
    return out


class TaskMonitor:
    """Executor-side sampler and the executor->driver telemetry channel.

    Each ``update_metrics`` push carries the process tree's RSS, the task's
    card (``sample_gpu_metrics``), ``note()``-d metrics (the Heartbeater's
    RPC round trip and missed beats), the child's liveness, step-time
    quantiles from the training child's StepTimer JSONL (``set_step_log``;
    the TONY_STEP_LOG contract), and executor-side lifecycle spans
    (``add_span``) that the driver merges into the task's TaskTrace."""

    def __init__(self, rpc_client, task_id: str, interval_s: float = 5.0):
        self._rpc = rpc_client
        self._task_id = task_id
        self._interval = interval_s
        self._acc = MetricsAccumulator()
        self._ctx = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._mlock = threading.Lock()
        self._spans: list[list] = []        # [name, unix_ts] (+ attrs)
        self._step_log: str | None = None

    def set_context(self, ctx) -> None:
        self._ctx = ctx

    def set_step_log(self, path: str | None) -> None:
        self._step_log = path

    def note(self, name: str, value: float) -> None:
        with self._mlock:
            if name in _COUNTER_NOTES:
                self._acc.set(name, value)
            else:
                self._acc.observe(name, value)

    def add_span(self, name: str, t: float | None = None,
                 attrs: dict | None = None) -> None:
        """An executor-side lifecycle span at wall-clock ``t``; ``attrs``
        (scalars) land on the task's trace beside it."""
        span = [name, time.time() if t is None else t]
        if attrs:
            span.append(dict(attrs))
        with self._mlock:
            self._spans.append(span)

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="task-monitor", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.refresh()
            except Exception:
                log.exception("metrics refresh failed")

    def _rank(self) -> int:
        """This task's rank from its cluster payload (the torch runtime's
        ``ranks``), else its index."""
        ctx = self._ctx
        if ctx is None:
            return 0
        task_id = f"{ctx.job_name}:{ctx.task_index}"
        ranks = (ctx.cluster_payload or {}).get("ranks") or {}
        return int(ranks.get(task_id, ctx.task_index))

    def _sample_step_log(self) -> dict[str, float]:
        """Newest StepTimer record -> step-time metrics."""
        if not self._step_log:
            return {}
        try:
            with open(self._step_log, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - 8192))
                lines = f.read().splitlines()
        except OSError:
            return {}
        for raw in reversed(lines):     # torn-tail tolerant
            try:
                rec = json.loads(raw)
            except ValueError:
                continue
            out = {}
            for src, dst in (("mean_step_s", STEP_TIME_MEAN_S),
                             ("p50_s", STEP_TIME_P50_S),
                             ("p99_s", STEP_TIME_P99_S),
                             ("steps_per_sec", STEPS_PER_SEC),
                             ("kernel_builds", KERNEL_BUILDS),
                             ("kernel_build_time_s", KERNEL_BUILD_TIME_S),
                             ("kernel_builds_post_warm",
                              KERNEL_BUILDS_POST_WARM),
                             ("gpu_memory_peak_mb", GPU_MEMORY_PEAK),
                             ("train_step", TRAIN_STEP),
                             ("last_ckpt_step", CKPT_STEP),
                             ("last_ckpt_ts", CKPT_UNIX_TS)):
                if isinstance(rec.get(src), (int, float)):
                    out[dst] = float(rec[src])
            return out
        return {}

    def refresh(self) -> None:
        proc = getattr(self._ctx, "child_process", None) if self._ctx else None
        child_alive = proc is not None and proc.poll() is None
        root = proc.pid if child_alive else os.getpid()
        rss = _proc_tree_rss_mb(root)
        gpu = sample_gpu_metrics(self._rank())
        steps = self._sample_step_log()
        with self._mlock:
            self._acc.observe(MEMORY_RSS, rss)
            if proc is not None:
                self._acc.observe(CHILD_ALIVE, 1.0 if child_alive else 0.0)
            for name, value in {**gpu, **steps}.items():
                if name in _COUNTER_NOTES:
                    self._acc.set(name, value)
                else:
                    self._acc.observe(name, value)
            metrics = self._acc.snapshot()
            spans = [list(s) for s in self._spans]
        spans += [list(s) for s in getattr(self._ctx, "spans", []) or []]
        spans.sort(key=lambda s: s[1])
        try:
            self._rpc.call("update_metrics", task_id=self._task_id,
                           metrics=metrics, spans=spans)
        except Exception as e:
            log.warning("metrics push failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        # final flush so short tasks still report
        try:
            self.refresh()
        except Exception:
            pass
