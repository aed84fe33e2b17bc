"""The job driver: session owner, capacity requester, liveness monitor (the
port's own copy of the JAX package's driver.py, its ``DriverService`` and
the ``Driver`` lifecycle).

Mirrors the reference ApplicationMaster (tony-core/.../ApplicationMaster.java):
lifecycle init -> prepare -> start -> monitor -> (reset/retry) -> stop
(:326-437), an RPC server for client+executors (:858-974), heartbeat liveness
(:201-221, onTaskDeemedDead:1229-1236), container-completion handling
(processFinishedContainer:1238-1274), registration-timeout and
startup-failure detection (:1276-1334), and whole-job retry that rebuilds the
session with session_id+1 (reset:611-627). Beyond the reference, as the JAX
package: a per-task restart budget (``tony.<role>.max-restarts``), task
lifecycle traces (``tasks.trace.jsonl``), the control-plane journal
(``driver.journal.jsonl``) and a Prometheus ``/metrics`` endpoint.

Capacity comes from a Provisioner; the "container" is an executor process
(``python -S -m tony_tpu_torch.executor``) on a host of cards. The driver
runs under ``python -S`` and imports no torch: it never holds a CUDA
context.

An operator asks a running task for a profiler capture with the
client-only ``request_task_profile`` RPC (or GET /profile on the metrics
port while token auth is off); the command rides the task's next
heartbeat answer.

Elastic training, as the JAX package's driver: a preemption notice
(client-only ``preempt_task``, the chaos knob, or an executor's own
``notify_preemption``) rides the heartbeat answer as ``{"preempt":
...}``, the child checkpoints and exits, and the task relaunches without
spending its restart budget (trace mark ``preempted``). With
``tony.train.elastic-enabled`` a non-chief worker lost past its budget is
detached instead of failing the job: the survivors drain (SIGTERM, which
the executor relays) and re-register into a new gang generation at the
smaller world size (trace mark ``resized``); every
``tony.train.rescale-retry-ms`` the slot is tried again, and the
rejoining executor prestages ``tony.train.checkpoint-dir``. A straggler
(``tony.train.straggler-restart-factor``) is restarted on the budget. The
chaos knobs ``TONY_TEST_DRIVER_KILL_RATE``, ``_PREEMPT_AT_STEP`` and
``_HEARTBEAT_DROP_RATE`` are seeded by ``_CHAOS_SEED``.

Every other feature of the JAX driver raises at ``prepare`` when its
conf key is set (``check_ported``), naming its ROADMAP.md queue 1 item,
and its RPC methods refuse by name; nothing falls back quietly. Donation
(the arbiter's drain, ``_initiate_donation``) comes with the autoscaler,
``TONY_TEST_DRIVER_SIGKILL_AT_STEP`` with driver recovery.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import sys
import threading
import time
from pathlib import Path
from typing import Any

from . import constants as c
from .api import DistributedMode, JobStatus, TaskStatus, now_ms
from .cluster import ContainerHandle, Provisioner, create_provisioner
from .conf import RoleSpec, TonyConf, keys
from .events import EventHandler
from .events.driver_journal import DriverJournal
from .events.trace import TASK_TRACE_FILE, TraceWriter
from .events.types import (
    application_finished,
    application_inited,
    task_finished,
    task_started,
    task_trace,
)
from .metrics import (
    CKPT_UNIX_TS,
    DRIVER_CHECKPOINT_AGE_S,
    DRIVER_GANG_LAUNCH_SECONDS,
    DRIVER_GANG_RESIZES_TOTAL,
    DRIVER_HEARTBEAT_EXPIRED_TOTAL,
    DRIVER_HEARTBEAT_INTERVAL_SECONDS,
    DRIVER_PREEMPTIONS_TOTAL,
    DRIVER_STRAGGLER_HEARTBEAT_S,
    DRIVER_STRAGGLER_REGISTRATION_S,
    DRIVER_TASK_METRIC,
    DRIVER_TASK_RESTARTS_TOTAL,
    DRIVER_TASK_SERVICE_PORT,
    DRIVER_TASKS,
    STEP_TIME_P50_S,
    TRAIN_STEP,
)
from .observability import PROM_CONTENT_TYPE, Histogram, PromRenderer, TaskTrace
from .rpc import RpcServer
from .scheduler import TaskScheduler
from .session import Session

log = logging.getLogger(__name__)

# the JAX driver's features that wait for a ROADMAP.md queue 1 item, by the
# item's name
WARM_POOL = "the warm pool"
RECOVERY = "driver recovery"
AUTOSCALE = "the autoscaler, the arbiter and the metrics hub/SLOs"
ELASTIC = "elastic resize, donation, preemption and chaos"
ROUTER = "the router, its role and HA"
PORTAL = "the portal, notebook, proxy and native/"

# conf keys whose (truthy) value turns on a feature the port's driver
# does not have: key -> the item it waits for
_REFUSED_KEYS = {
    keys.WARMPOOL_SIZE: WARM_POOL,
    keys.AUTOSCALE_ENABLED: AUTOSCALE,
    keys.QUOTA_POOL_SLOTS: AUTOSCALE,
    keys.APPLICATION_ENABLE_PREPROCESS: PORTAL,
}
# driver chaos the port does not have: the driver's SIGKILL of itself at a
# step needs ``driver --recover`` to pick the job up again
_CHAOS_ENV = {c.TEST_DRIVER_SIGKILL_AT_STEP: RECOVERY}


def _not_ported(feature: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported yet (ROADMAP.md queue 1: {item})")


def check_ported(conf: TonyConf, environ=None) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item, when the conf
    (or the driver chaos env) turns on a feature of the JAX driver the port
    does not have yet."""
    environ = os.environ if environ is None else environ
    for key, item in _REFUSED_KEYS.items():
        if conf.get(key):
            raise _not_ported(f"{key}={conf.get(key)!r}", item)
    data = conf.as_dict()
    for key in sorted(data):
        if key.startswith(keys.SLO_PREFIX) and key.endswith(".objective"):
            raise _not_ported(f"the SLO {key}", AUTOSCALE)
    for spec in conf.role_specs():
        if spec.priority_class != "interactive" or spec.quota >= 0:
            raise _not_ported(
                f"role {spec.name}'s arbiter tier (priority-class "
                f"{spec.priority_class!r}, quota {spec.quota})", AUTOSCALE)
    for name, item in _CHAOS_ENV.items():
        if environ.get(name):
            raise _not_ported(f"driver chaos ({name})", item)


def _lag_stats(rel: list[float]) -> dict[str, float]:
    """max/median of per-task lag values — the straggler gauge's two
    stats. An empty list reads as zero skew rather than omitting the
    series."""
    if not rel:
        return {"max": 0.0, "median": 0.0}
    return {"max": max(rel), "median": float(statistics.median(rel))}


class DriverService:
    """RPC-facing service — reference RpcForClient
    (ApplicationMaster.java:858-974). Public methods = wire methods."""

    def __init__(self, driver: "Driver"):
        self._d = driver

    # ------------------------------------------------------------- executors
    def register_worker(self, task_id: str, host: str, port: int,
                        attempt: int = -1):
        d = self._d
        # attempt fence: a superseded attempt's executor (lingering past its
        # SIGTERM) must not register itself over the replacement. -1
        # (absent) skips the fence.
        if attempt >= 0:
            current = d._attempts.get(task_id)
            if current is not None and attempt != current:
                raise ValueError(
                    f"stale attempt {attempt} of {task_id}: the current "
                    f"attempt is {current} (zombie registration refused)")
        task = d.session.register_task(task_id, host, port)
        if task is None:
            raise ValueError(f"unknown task {task_id}")
        d._jrec("register", task=task_id, host=host, port=port)
        d.heartbeats[task_id] = time.time()
        d._on_task_registered(task_id)
        log.info("registered %s at %s:%s (%d/%d)", task_id, host, port,
                 d.session.registered_count(), len(d.session.all_tasks()))
        # fault injection: kill listed tasks once the chief registers
        # (reference TEST_WORKER_TERMINATION, ApplicationMaster.java:1338-1349)
        victims = os.environ.get(c.TEST_WORKER_TERMINATION, "")
        if victims and d.session.is_chief(task.name, task.index):
            def _terminate():
                for victim in victims.split(","):
                    log.warning("fault injection: terminating %s", victim)
                    d._kill_task(victim.strip())
            threading.Thread(target=_terminate, daemon=True).start()
        return self.get_cluster_spec(task_id)

    def get_cluster_spec(self, task_id: str):
        """None until the runtime's gang barrier opens — the executor polls
        (reference 'return null until ready', TaskExecutor.java:296-298)."""
        d = self._d
        if not d.runtime_driver.can_start_task(d.mode, task_id):
            return None
        payload = d.runtime_driver.cluster_spec_payload(task_id)
        d._mark_running(task_id)    # the gang barrier opened for this task
        return payload

    def heartbeat(self, task_id: str):
        """True, or a one-shot dict when a command waits for this task:
        ``{"profile": {"seconds": N}}`` (``Driver.request_profile``) and/or
        ``{"preempt": {"grace_ms": N}}`` (``Driver.preempt_task``: drain
        at the next step boundary and exit). The heartbeat is the one
        driver -> executor channel at steady state, so commands ride its
        answer (the JAX package's driver.py:156)."""
        d = self._d
        if d._chaos_hb_drop and d._chaos_rng.random() < d._chaos_hb_drop:
            # chaos: the beat is lost in transit; the caller counts a
            # miss and the driver records nothing
            raise RuntimeError("chaos: heartbeat dropped")
        prev = d.heartbeats.get(task_id)
        now = time.time()
        d.heartbeats[task_id] = now
        d._on_heartbeat(task_id, prev, now)
        cmd: dict[str, Any] = {}
        prof = d.take_profile_command(task_id)
        if prof:
            cmd["profile"] = prof
        pre = d.take_preempt_command(task_id)
        if pre:
            cmd["preempt"] = pre
        return cmd or True

    def register_execution_result(self, task_id: str, exit_code: int) -> str:
        log.info("%s reported exit code %d", task_id, exit_code)
        self._d.on_task_result(task_id, exit_code, source="executor")
        return "RECEIVED"

    def register_callback_info(self, task_id: str,
                               payload: dict[str, Any]) -> bool:
        self._d.runtime_driver.receive_callback_info(task_id, payload)
        return True

    def publish_ports(self, task_id: str, ports: dict[str, int]) -> bool:
        """A task advertises named service ports (``serve_port``,
        ``metrics_port``, ...): they land on the task's Session entry, ride
        the cluster-spec payload (``service_ports``), surface on
        get_task_infos and render as ``driver_task_service_port``."""
        return self._d.publish_task_ports(task_id, ports)

    def register_tensorboard_url(self, url: str) -> bool:
        self._d.tensorboard_url = url
        log.info("tensorboard at %s", url)
        return True

    def update_metrics(self, task_id: str, metrics: list[dict[str, Any]],
                       spans: list | None = None) -> bool:
        """``spans`` (optional, [name, unix_ts] pairs) are executor-side
        lifecycle spans merged into the task's trace."""
        self._d.metrics[task_id] = metrics
        if spans:
            self._d._merge_executor_spans(task_id, spans)
        return True

    def get_metrics(self, task_id: str):
        return self._d.metrics.get(task_id, [])

    # the JAX driver's operator commands, refused by name
    def roll_task(self, task_id: str) -> bool:
        raise _not_ported("roll_task", ROUTER)

    def preempt_task(self, task_id: str) -> bool:
        """Relay a preemption notice to one RUNNING task (client-only
        under token auth): it rides the task's next heartbeat answer, the
        executor drops the ``$TONY_STEP_LOG.preempt`` flag, the child
        checkpoints at its next step boundary and exits, and the driver
        relaunches it without spending the restart budget."""
        return self._d.preempt_task(task_id)

    def notify_preemption(self, task_id: str) -> bool:
        """An executor reports that it received a preemption signal (a
        SIGTERM to its host): its coming exit relaunches budget-free."""
        return self._d.note_preemption(task_id, source="executor")

    def request_task_profile(self, task_id: str,
                             seconds: float = 5.0) -> bool:
        """Queue an on-demand profiler capture of ``task_id``'s training
        child (``Driver.request_profile``); client-only under token
        auth."""
        return self._d.request_profile(task_id, seconds)

    # ---------------------------------------------------------------- client
    def get_task_infos(self):
        return [t.to_dict() for t in self._d.session.task_infos()]

    def get_application_state(self):
        d = self._d
        status = d.session.status
        # a failure before the driver finalizes is not terminal for the
        # client — the reference client polls through AM attempts
        if status == JobStatus.FAILED and not d.finalized:
            status = JobStatus.RUNNING
        return {
            "app_id": d.app_id,
            "status": status.value,
            "message": d.session.failure_message,
            "session_id": d.session.session_id,
            "tensorboard_url": d.tensorboard_url,
        }

    def finish_application(self) -> bool:
        """Client acknowledges the terminal state so the driver may exit
        (reference signalAMToFinish / FinishApplication RPC)."""
        self._d.client_signal.set()
        return True


class Driver:
    def __init__(
        self,
        conf: TonyConf,
        app_id: str,
        job_dir: str,
        token: str = "",
        user: str = "",
        provisioner: Provisioner | None = None,
    ):
        self.conf = conf
        self.app_id = app_id
        self.job_dir = Path(job_dir)
        self.token = token
        self.user = user or os.environ.get("USER", "")
        self.tensorboard_url = ""
        self.metrics: dict[str, list[dict[str, Any]]] = {}
        self.heartbeats: dict[str, float] = {}
        self.client_signal = threading.Event()
        self.finalized = False
        self._stop_requested = threading.Event()
        # on-demand profile commands waiting for their task's next
        # heartbeat (request_profile), at most one a task
        self._profile_cmds: dict[str, dict] = {}
        self._profile_lock = threading.Lock()
        self.mode = DistributedMode(
            str(conf.get(keys.APPLICATION_DISTRIBUTED_MODE, "GANG")).upper())

        from .runtimes import get_runtime

        self._runtime = get_runtime(
            str(conf.get(keys.APPLICATION_FRAMEWORK, "torch")))
        self.runtime_driver = self._runtime.driver_adapter()
        self.runtime_driver.validate_and_update_config(conf)
        conf.validate()

        self.provisioner = provisioner or create_provisioner(conf)
        self.provisioner.on_completion = self._on_container_completed

        self.session = Session(conf, session_id=0)
        self.runtime_driver.set_session(self.session)
        self.scheduler: TaskScheduler | None = None

        # per-principal auth: the root job secret (client + driver only)
        # derives one key per role; executors get ONLY the executor key, so
        # they cannot sign client-privileged calls (reference
        # TonyPolicyProvider ACL split, ApplicationMaster.java:483-503)
        from .rpc.protocol import derive_role_key

        self.executor_token = derive_role_key(token, "executor")
        roles = acl = None
        if token:
            roles = {"client": derive_role_key(token, "client"),
                     "executor": self.executor_token}
            # aiming the profiler is an operator action, as ending the
            # job is: an executor key must not aim it at its peers
            acl = {"finish_application": {"client"},
                   "request_task_profile": {"client"},
                   "preempt_task": {"client"}}
        self.rpc_server = RpcServer(
            host=str(conf.get(keys.AM_RPC_HOST, "127.0.0.1")), port=0,
            token=token, roles=roles, acl=acl)
        self.rpc_server.register_service(DriverService(self))
        self.events: EventHandler | None = None
        self._handles: dict[str, ContainerHandle] = {}  # task_id -> handle
        self._launch_ms: dict[str, int] = {}            # task_id -> launch time
        self._restarts: dict[str, int] = {}             # task_id -> restarts used
        # per-task launch ordinal, echoed back on register_worker so a
        # superseded attempt's executor is refused by the fence
        self._attempts: dict[str, int] = {}
        self._journal: DriverJournal | None = None
        self.driver_generation = 0
        # serializes the restart paths — container completion (watcher
        # threads) and heartbeat expiry (monitor thread) — so a crash that
        # coincides with heartbeat death cannot double-spend the budget or
        # kill the replacement the other path just launched
        self._restart_lock = threading.RLock()
        self._retries_left = conf.get_int(keys.AM_RETRY_COUNT, 0)
        self._start_ms = now_ms()

        # ---- task lifecycle telemetry (observability.TaskTrace): marks
        # come from RPC threads, watcher threads and the monitor loop
        self._tt_lock = threading.Lock()
        self.task_traces: dict[str, TaskTrace] = {}   # live (unsealed)
        self._task_trace_writer: TraceWriter | None = None
        self._gang_hist: dict[str, Histogram] = {}    # role -> req->reg
        self._hb_hist = Histogram()                   # beat inter-arrival
        self._restart_count = 0                       # budget units spent
        self._hb_expired_count = 0                    # liveness expiries
        self._reg_t: dict[str, float] = {}            # task -> reg monotime
        self._barrier_open: set[str] = set()          # "running" marked
        self._first_beat: set[str] = set()            # "first_heartbeat"
        self._exec_spans_seen: dict[str, set] = {}    # per-attempt dedupe
        self._attempt_wall: dict[str, float] = {}     # restart wall fence
        self._metrics_httpd = None

        # ---- elastic, preemption-tolerant training. Ledgers of
        # deliberate exits, each discharged by the task's container
        # completion into a budget-free relaunch: tasks mid-preemption
        # drain (and the notices waiting for a heartbeat), survivors
        # mid-resize drain. Detached slots wait for the rescale timer.
        self._preempts: set[str] = set()
        self._preempt_cmds: set[str] = set()
        self._preempt_count = 0
        self._resizes: set[str] = set()
        self._resize_count = 0
        self._detach_t: dict[str, float] = {}    # task -> detach monotime
        # stops the driver itself made (chaos or fault-injection kill,
        # heartbeat expiry, straggler): the dying executor's SIGTERM relay
        # reports a "preemption", which must not relabel a deliberate
        # kill as budget-free. Cleared when the next attempt launches.
        self._driver_stops: set[str] = set()
        self._elastic = conf.get_bool(keys.TRAIN_ELASTIC_ENABLED, False)
        self._elastic_min = conf.get_int(keys.TRAIN_ELASTIC_MIN_INSTANCES, 1)
        self._rescale_retry_s = conf.get_int(
            keys.TRAIN_RESCALE_RETRY_MS, 30000) / 1000
        # straggler action: consecutive slow checks a task
        self._straggler_factor = float(
            conf.get(keys.TRAIN_STRAGGLER_RESTART_FACTOR, 0) or 0)
        self._straggler_grace = max(
            1, conf.get_int(keys.TRAIN_STRAGGLER_GRACE_CHECKS, 3))
        self._straggler_strikes: dict[str, int] = {}
        self._straggler_check_t = 0.0
        # seeded driver chaos (TONY_TEST_DRIVER_*), read once so a run's
        # fault sequence repeats from its seed
        import random

        def _env_num(name, cast, lo=None, hi=None):
            try:
                v = cast(os.environ.get(name, "0") or 0)
            except ValueError:
                log.error("bad %s value; chaos knob disabled", name)
                return cast(0)
            return v if lo is None else min(hi, max(lo, v))

        self._chaos_kill_rate = _env_num(c.TEST_DRIVER_KILL_RATE, float,
                                         0.0, 1.0)
        self._chaos_hb_drop = _env_num(c.TEST_DRIVER_HEARTBEAT_DROP_RATE,
                                       float, 0.0, 1.0)
        self._chaos_preempt_at = _env_num(c.TEST_DRIVER_PREEMPT_AT_STEP, int)
        self._chaos_preempt_fired = False
        self._chaos_rng = random.Random(
            _env_num(c.TEST_DRIVER_CHAOS_SEED, int))
        if (self._chaos_kill_rate or self._chaos_hb_drop
                or self._chaos_preempt_at):
            log.warning("driver chaos armed: kill_rate=%s hb_drop=%s "
                        "preempt_at_step=%s", self._chaos_kill_rate,
                        self._chaos_hb_drop, self._chaos_preempt_at)

    # ------------------------------------------------------------- lifecycle
    def run(self) -> JobStatus:
        self.prepare()
        try:
            while True:
                self.start_session()
                status = self.monitor()
                if status == JobStatus.FAILED and self._retries_left > 0:
                    self._retries_left -= 1
                    log.warning(
                        "job failed (%s); retrying (%d attempts left)",
                        self.session.failure_message, self._retries_left)
                    self.reset()
                    continue
                self.finalized = True
                return status
        finally:
            # the state the client reads must go terminal either way
            self.finalized = True
            self.stop()

    def prepare(self) -> None:
        """Refuse unported features, then RPC up, events up, endpoint
        advertised — reference prepare:442-526."""
        check_ported(self.conf)
        self.rpc_server.start()
        self.events = EventHandler(
            str(self.conf.get(keys.HISTORY_INTERMEDIATE)), self.app_id,
            user=self.user)
        self.events.start()
        self.events.emit(application_inited(
            self.app_id, len(self.session.all_tasks()),
            self.rpc_server.address[0]))
        self.conf.write_final(self.job_dir)
        # advertise the RPC endpoint for the client (plays the role of the
        # YARN application report carrying the AM host:port)
        info = {"host": self.rpc_server.address[0],
                "port": self.rpc_server.port, "app_id": self.app_id,
                "pid": os.getpid(),
                "driver_generation": self.driver_generation}
        self._task_trace_writer = TraceWriter(
            self.events.job_dir, filename=TASK_TRACE_FILE)
        self._start_metrics_server()
        if self.metrics_port is not None:
            info["metrics_port"] = self.metrics_port
        tmp = self.job_dir / (c.DRIVER_INFO_FILE + ".tmp")
        tmp.write_text(json.dumps(info))
        tmp.rename(self.job_dir / c.DRIVER_INFO_FILE)
        self._journal = DriverJournal(self.job_dir / c.DRIVER_JOURNAL_FILE)
        self._jrec("meta", app_id=self.app_id, token=self.token,
                   session_id=self.session.session_id,
                   rpc_port=self.rpc_server.port,
                   driver_generation=self.driver_generation)

    def start_session(self) -> None:
        """Build the scheduler and request capacity — reference
        start:577-608."""
        self.scheduler = TaskScheduler(
            self.conf, list(self.session.role_specs.values()),
            self._request_role)
        self.scheduler.schedule()

    def _request_role(self, spec: RoleSpec) -> None:
        """Launch all instances of a role — the local analogue of
        addContainerRequest + ContainerLauncher (allocation is immediate
        for a provisioner that owns its capacity)."""
        from .runtimes.generic import GenericDriverAdapter

        if isinstance(self.runtime_driver, GenericDriverAdapter):
            self.runtime_driver.note_requests_submitted()
        hold = os.environ.get(c.TEST_ALLOCATION_HOLD, "")
        for index in range(spec.instances):
            task = self.session.get_task(spec.name, index)
            if task is None or task.status.is_terminal():
                continue
            if task.task_id in self.session.detached:
                continue    # only a capacity return launches it
            task.status = TaskStatus.REQUESTED
            self._trace_mark(task.task_id, "requested", role=spec.name)
            if hold == f"{spec.name}#{index}":
                # fault hook: this task never receives capacity (gang
                # deadlock — broken by the allocation-timeout health check)
                log.info("TEST_ALLOCATION_HOLD: withholding capacity for %s",
                         task.task_id)
                continue
            env = self._task_env(spec, index)
            env[c.ENV_TASK_ATTEMPT] = str(self._bump_attempt(task.task_id))
            # launch + handle publication are atomic vs the completion
            # callback (which takes the same lock): a container that exits
            # faster than this thread stores its handle would otherwise
            # read as superseded and its completion would be dropped
            with self._restart_lock:
                handle = self.provisioner.launch(
                    spec, index, env, self.job_dir / "logs")
                self._handles[task.task_id] = handle
            self.session.note_allocated(task.task_id, handle.container_id)
            self._journal_launch(task.task_id, handle)
            self._trace_mark(task.task_id, "allocated", host=handle.host)
            task.host = handle.host
            # per-task log URL (reference util/Utils.java:220-235)
            task.url = handle.extra.get("log_path") or str(
                self.job_dir / "logs" / f"{spec.name}_{index}.stdout")
            self._launch_ms[task.task_id] = now_ms()
            self._trace_mark(task.task_id, "launched")
            if self.events:
                self.events.emit(
                    task_started(task.task_id, handle.host, url=task.url))
            log.info("launched %s as %s on %s", task.task_id,
                     handle.container_id, handle.host)

    def _task_env(self, spec: RoleSpec, index: int) -> dict[str, str]:
        """The driver->executor env contract — reference ContainerLauncher
        env assembly (ApplicationMaster.java:1179-1192)."""
        env = {
            c.ENV_JOB_NAME: spec.name,
            c.ENV_TASK_INDEX: str(index),
            c.ENV_TASK_NUM: str(spec.instances),
            c.ENV_NUM_TOTAL_TASKS: str(len(self.session.all_tasks())),
            c.ENV_GANG_GENERATION: str(self.session.gang_generation),
            c.ENV_DRIVER_GENERATION: str(self.driver_generation),
            c.ENV_IS_CHIEF: str(
                self.session.is_chief(spec.name, index)).lower(),
            c.ENV_SESSION_ID: str(self.session.session_id),
            c.ENV_DISTRIBUTED_MODE: self.mode.value,
            c.ENV_DRIVER_HOST: self.rpc_server.address[0],
            c.ENV_DRIVER_PORT: str(self.rpc_server.port),
            c.ENV_APP_ID: self.app_id,
            c.ENV_JOB_DIR: str(self.job_dir),
            c.ENV_TOKEN: self.executor_token,
            c.ENV_TASK_COMMAND: spec.command,
        }
        # job-archive shipping: executors on hosts without the staging FS
        # fetch + unpack this URI; its digest rides the launch env
        archive_uri = str(
            self.conf.get(keys.APPLICATION_ARCHIVE_URI, "") or "")
        if archive_uri:
            env[c.ENV_JOB_ARCHIVE] = archive_uri
            digest = str(
                self.conf.get(keys.APPLICATION_ARCHIVE_SHA256, "") or "")
            if digest:
                env[c.ENV_JOB_ARCHIVE_SHA256] = digest
        if self.conf.get_bool(keys.TASK_LOCALIZE, False):
            env[c.ENV_LOCALIZE] = "true"
        for kv in self.conf.get_list(keys.EXECUTION_ENV):
            if "=" in kv:
                k, v = kv.split("=", 1)
                env[k] = v
        env.update(spec.env)
        return env

    # -------------------------------------------------- control-plane journal
    def _jrec(self, op: str, **fields) -> None:
        """Best-effort journal append (no-op before prepare / after close):
        the journal must never take the driver down."""
        if self._journal is not None:
            self._journal.record(op, **fields)

    # ------------------------------------------------------- task telemetry
    def _trace_mark(self, task_id: str, span: str, **attrs) -> None:
        with self._tt_lock:
            tr = self.task_traces.get(task_id)
            if tr is None:
                tr = self.task_traces[task_id] = TaskTrace(task_id)
            tr.mark(span)
            if attrs:
                tr.attrs.update(attrs)

    def _on_task_registered(self, task_id: str) -> None:
        """Registration: mark the span and feed the per-role gang-launch
        histogram (capacity request -> registration, from the newest
        ``requested``). Once per attempt: the RPC client retries transport
        errors, so a re-delivered register_worker must not double-count."""
        role = task_id.partition(":")[0]
        with self._tt_lock:
            if task_id in self._reg_t:
                return
            tr = self.task_traces.get(task_id)
            if tr is None:
                tr = self.task_traces[task_id] = TaskTrace(task_id)
            t_req = tr.last_t("requested")
            tr.mark("registered")
            now = tr.spans[-1][1]
            self._reg_t[task_id] = now
            if t_req is not None:
                h = self._gang_hist.get(role)
                if h is None:
                    h = self._gang_hist[role] = Histogram()
                h.observe(max(0.0, now - t_req))

    def _on_heartbeat(self, task_id: str, prev: float | None,
                      now: float) -> None:
        with self._tt_lock:
            if prev is not None:
                self._hb_hist.observe(max(0.0, now - prev))
            # first_heartbeat only counts after registration (the executor
            # beats before it registers)
            if task_id not in self._first_beat and task_id in self._reg_t:
                tr = self.task_traces.get(task_id)
                if tr is not None:
                    self._first_beat.add(task_id)
                    tr.mark("first_heartbeat")

    def _mark_running(self, task_id: str) -> None:
        """The gang barrier opened for this task — once per attempt."""
        with self._tt_lock:
            if task_id in self._barrier_open:
                return
            tr = self.task_traces.get(task_id)
            if tr is not None:
                self._barrier_open.add(task_id)
                tr.mark("running")

    def _merge_executor_spans(self, task_id: str, spans: list) -> None:
        """Executor-side lifecycle spans arrive as [name, unix_ts] pairs
        (optionally with an attrs dict); each name merges once per attempt,
        re-anchored from the executor's wall clock onto this host's
        monotonic timeline. ``child_spawned`` sets the task's wire-visible
        ``launch_path`` to "cold" (the port spawns every child)."""
        offset = time.monotonic() - time.time()
        with self._tt_lock:
            tr = self.task_traces.get(task_id)
            if tr is None:
                return
            # spans stamped before this attempt began are a superseded
            # attempt's executor talking
            floor = self._attempt_wall.get(task_id, 0.0)
            seen = self._exec_spans_seen.setdefault(task_id, set())
            for item in spans:
                try:
                    name, unix_t = item[0], float(item[1])
                except (TypeError, ValueError, IndexError):
                    continue        # a malformed push must not kill the RPC
                if not isinstance(name, str) or name in seen:
                    continue
                if unix_t < floor:
                    continue
                seen.add(name)
                attrs = (item[2] if len(item) > 2
                         and isinstance(item[2], dict) else {})
                for k, v in attrs.items():
                    if isinstance(k, str) and isinstance(
                            v, (str, int, float, bool)):
                        tr.attrs[k] = v
                tr.mark(name, t=unix_t + offset)
                if name == "child_spawned":
                    task = self.session.get_task_by_id(task_id)
                    if task is not None:
                        task.launch_path = "cold"

    def _clear_attempt_state_locked(self, task_id: str) -> None:
        """Drop the once-per-attempt markers. Caller holds _tt_lock."""
        self._exec_spans_seen.pop(task_id, None)
        self._barrier_open.discard(task_id)
        self._first_beat.discard(task_id)
        self._reg_t.pop(task_id, None)
        self._attempt_wall.pop(task_id, None)

    def _clear_attempt_state(self, task_id: str) -> None:
        """Reset the once-per-attempt markers so a restarted task records a
        fresh chain, and fence off the superseded attempt's late pushes."""
        with self._tt_lock:
            self._clear_attempt_state_locked(task_id)
            self._attempt_wall[task_id] = time.time()

    def _seal_task_trace(self, task_id: str, terminal: str,
                         **attrs) -> None:
        """Close the task's trace with its terminal span, append it to
        tasks.trace.jsonl and the jhist stream as a TASK_TRACE event.
        Idempotent: a second seal finds no live trace."""
        with self._tt_lock:
            tr = self.task_traces.pop(task_id, None)
            if tr is None:
                return
            self._clear_attempt_state_locked(task_id)
            if attrs:
                tr.attrs.update(attrs)
            tr.attrs.setdefault("restarts", self._restarts.get(task_id, 0))
            tr.mark(terminal)
            record = tr.to_dict()
        if self._task_trace_writer is not None:
            self._task_trace_writer.write(record)
        if self.events:
            self.events.emit(task_trace(record))

    def _seal_remaining_traces(self) -> None:
        """Seal every still-live trace by its task's final status."""
        with self._tt_lock:
            live = list(self.task_traces)
        for task_id in live:
            task = self.session.get_task_by_id(task_id)
            status = task.status if task is not None else TaskStatus.KILLED
            terminal = {TaskStatus.SUCCEEDED: "finished",
                        TaskStatus.FAILED: "failed"}.get(status, "killed")
            self._seal_task_trace(task_id, terminal, status=status.value)

    # ------------------------------------------------------- driver /metrics
    def _start_metrics_server(self) -> None:
        """GET /metrics in Prometheus text 0.0.4. Port from
        ``tony.am.metrics-port`` (0 = ephemeral, advertised as
        ``metrics_port`` in driver.json; negative = disabled)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        port = self.conf.get_int(keys.AM_METRICS_PORT, 0)
        if port < 0:
            return
        driver = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug("metrics: " + fmt, *args)

            def do_GET(self):
                route = self.path.partition("?")[0]
                if route == "/metrics":
                    try:
                        body = driver.render_metrics().encode()
                        code, ctype = 200, PROM_CONTENT_TYPE
                    except Exception as e:   # never 500 silently
                        log.exception("metrics render failed")
                        body, code, ctype = (
                            f"error: {e}".encode(), 500, "text/plain")
                elif route == "/profile":
                    body, code = driver._profile_route(self.path)
                    ctype = "application/json"
                else:
                    body, code, ctype = b"not found", 404, "text/plain"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        host = str(self.conf.get(keys.AM_RPC_HOST, "127.0.0.1"))
        try:
            self._metrics_httpd = ThreadingHTTPServer((host, port), _Handler)
        except OSError as e:
            # a taken port must not fail the job — telemetry is optional
            log.error("could not bind driver metrics port %s: %s", port, e)
            return
        threading.Thread(target=self._metrics_httpd.serve_forever,
                         name="driver-metrics", daemon=True).start()

    def _profile_route(self, path: str) -> tuple[bytes, int]:
        """GET /profile?task=worker:0&seconds=5 (the JAX package's
        driver.py:1130): the command ``request_task_profile`` queues, for
        local use. Only while token auth is off: with auth on, this
        unauthenticated route would hand any peer on the network the
        action the RPC's ACL keeps for the client (403)."""
        from urllib.parse import parse_qs, urlparse

        if self.token:
            return json.dumps(
                {"error": "token auth is on: use the client-authenticated "
                 "request_task_profile RPC"}).encode(), 403
        qs = parse_qs(urlparse(path).query)
        task_id = qs.get("task", [""])[0]
        try:
            ok = self.request_profile(task_id,
                                      float(qs.get("seconds", ["5"])[0]))
        except (ValueError, TypeError) as e:
            return json.dumps({"error": str(e)}).encode(), 400
        return (json.dumps({"queued": ok, "task": task_id}).encode(),
                200 if ok else 404)

    @property
    def metrics_port(self) -> int | None:
        return (self._metrics_httpd.server_address[1]
                if self._metrics_httpd is not None else None)

    def render_metrics(self) -> str:
        """The driver /metrics payload: per-role gang-launch histograms,
        the heartbeat inter-arrival histogram, restart/expiry counters,
        preemption and resize counters, task-state gauges (``detached``
        beside the statuses), the per-role straggler gauges, checkpoint
        age, published service ports, and every executor-pushed metric as
        a labeled gauge."""
        r = PromRenderer()
        roles = sorted(self.session.role_specs)
        now_wall = time.time()
        beats = {}
        for task_id, last in list(self.heartbeats.items()):
            task = self.session.get_task_by_id(task_id)
            if (task is None or task.status.is_terminal()
                    or task.exit_code is not None
                    or task_id in self.session.detached):
                continue
            beats[task_id] = last
        with self._tt_lock:
            for role in roles:
                h = self._gang_hist.setdefault(role, Histogram())
                r.histogram(
                    DRIVER_GANG_LAUNCH_SECONDS, h,
                    "capacity request -> worker registration, per role",
                    labels={"role": role})
            r.histogram(
                DRIVER_HEARTBEAT_INTERVAL_SECONDS, self._hb_hist,
                "observed heartbeat inter-arrival time across all tasks")
            r.counter(DRIVER_TASK_RESTARTS_TOTAL, self._restart_count,
                      "per-task restart budget units spent")
            r.counter(DRIVER_HEARTBEAT_EXPIRED_TOTAL, self._hb_expired_count,
                      "tasks deemed dead after missing the heartbeat "
                      "budget")
            r.counter(DRIVER_PREEMPTIONS_TOTAL, self._preempt_count,
                      "preemption drains relayed or reported "
                      "(budget-free relaunches)")
            r.counter(DRIVER_GANG_RESIZES_TOTAL, self._resize_count,
                      "elastic gang re-formations (down on worker loss "
                      "past its budget, up when capacity returned)")
            reg = dict(self._reg_t)
        counts: dict[str, int] = {}
        for t in self.session.all_tasks():
            counts[t.status.value] = counts.get(t.status.value, 0) + 1
        # detached is a formation state, not a status: a slot can be
        # RUNNING and detached mid-drain, so it is a series of its own
        counts["detached"] = len(self.session.detached)
        for status in sorted(counts):
            r.gauge(DRIVER_TASKS, counts[status], "tasks by state",
                    labels={"state": status})
        for task_id in sorted(self.metrics):
            ts = self._pushed_metric(task_id, f"max_{CKPT_UNIX_TS}")
            if ts:
                r.gauge(DRIVER_CHECKPOINT_AGE_S,
                        round(max(0.0, now_wall - ts), 3),
                        "age of the newest checkpoint each worker "
                        "reported (StepTimer note_checkpoint)",
                        labels={"task": task_id})
        for task_id, ports in sorted(self.session.service_ports().items()):
            for pname, port in sorted(ports.items()):
                r.gauge(DRIVER_TASK_SERVICE_PORT, port,
                        "named service ports tasks published "
                        "(publish_ports RPC)",
                        labels={"task": task_id, "name": pname})
        for role in roles:
            rts = [v for tid, v in reg.items()
                   if tid.partition(":")[0] == role]
            lo = min(rts) if rts else 0.0
            for stat, val in _lag_stats([v - lo for v in rts]).items():
                r.gauge(DRIVER_STRAGGLER_REGISTRATION_S, val,
                        "registration lag behind the role's first "
                        "registrant (gang-launch straggler gauge)",
                        labels={"role": role, "stat": stat})
            bts = [v for tid, v in beats.items()
                   if tid.partition(":")[0] == role]
            hi = max(bts) if bts else now_wall
            for stat, val in _lag_stats([hi - v for v in bts]).items():
                r.gauge(DRIVER_STRAGGLER_HEARTBEAT_S, val,
                        "heartbeat staleness behind the role's freshest "
                        "beat (liveness straggler gauge)",
                        labels={"role": role, "stat": stat})
        # every pushed metric, the children's kernel-library builds and
        # device-memory peak included. The driver's own build histogram
        # (the JAX package's driver_xla_compile_seconds, for user code the
        # driver runs: preprocess, notebook) waits for ROADMAP.md queue 1
        # item "the portal, notebook, proxy and native/", whose code it
        # would count
        for task_id in sorted(self.metrics):
            for entry in self.metrics[task_id]:
                name, value = entry.get("name"), entry.get("value")
                if name is None or not isinstance(value, (int, float)):
                    continue
                r.gauge(DRIVER_TASK_METRIC, value,
                        "executor-pushed metric snapshot (max_/avg_ "
                        "per name)",
                        labels={"task": task_id, "name": name})
        return r.render()

    def _pushed_metric(self, task_id: str, name: str) -> float | None:
        for entry in self.metrics.get(task_id, []):
            if entry.get("name") == name and isinstance(
                    entry.get("value"), (int, float)):
                return float(entry["value"])
        return None

    # ------------------------------------------------- on-demand profiling
    def request_profile(self, task_id: str, seconds: float = 5.0) -> bool:
        """Queue a profiler capture of ``seconds`` for ``task_id`` (the JAX
        package's driver.py:2913): it rides the task's next heartbeat
        answer, the executor writes the ``$TONY_STEP_LOG.profile`` flag,
        and the training child's StepTimer captures. False for an unknown
        or terminal task, and for a NEW or REQUESTED one, which has no
        container to beat (the command would wait for whatever attempt
        launches, long after it was asked for). A second request before
        the first is picked up replaces it."""
        seconds = float(seconds)
        if not 0 < seconds <= 120:
            raise ValueError("seconds must be in (0, 120]")
        task = self.session.get_task_by_id(task_id)
        if (task is None or task.status.is_terminal()
                or task.status in (TaskStatus.NEW, TaskStatus.REQUESTED)):
            return False
        with self._profile_lock:
            self._profile_cmds[task_id] = {"seconds": seconds}
        log.info("queued a %gs profile capture for %s", seconds, task_id)
        return True

    def take_profile_command(self, task_id: str) -> dict | None:
        """Pop ``task_id``'s waiting profile command (the heartbeat's)."""
        with self._profile_lock:
            return self._profile_cmds.pop(task_id, None)

    # ------------------------------------------------------------ completion
    def _on_container_completed(self, handle: ContainerHandle,
                                exit_code: int) -> None:
        """Provisioner watcher callback — reference
        processFinishedContainer:1238-1274."""
        task_id = f"{handle.role}:{handle.index}"
        # fault injection: hold back the completion so heartbeat expiry
        # races it (reference ApplicationMaster.java:1075-1087)
        try:
            delay_ms = int(os.environ.get(c.TEST_COMPLETION_DELAY_MS, "0"))
        except ValueError:
            log.error("bad %s value; ignoring", c.TEST_COMPLETION_DELAY_MS)
            delay_ms = 0
        if delay_ms:
            log.warning("fault injection: delaying completion of %s by %dms",
                        task_id, delay_ms)
            time.sleep(delay_ms / 1000)
        # a superseded attempt's container (killed after its heartbeat
        # death already restarted it in place) must not burn the new
        # attempt's budget or fail the job out from under it
        with self._restart_lock:
            current = self._handles.get(task_id)
            if current is None or current.container_id != handle.container_id:
                log.info(
                    "ignoring completion of superseded container %s for %s",
                    handle.container_id, task_id)
                return
            self.on_task_result(task_id, exit_code, source="container")

    def on_task_result(self, task_id: str, exit_code: int,
                       source: str) -> None:
        task = self.session.get_task_by_id(task_id)
        if task is None:
            return
        if source == "executor":
            # informational: the authoritative completion is the container
            # exit. The task stops heartbeating now, so unregister it from
            # liveness (the reference's HB-unregister race, AM:1075-1087)
            task.exit_code = exit_code
            self.heartbeats.pop(task_id, None)
            return
        if not task.status.is_terminal() and not self._stop_requested.is_set():
            # a resize drain and a preemption drain are ledgered,
            # deliberate exits (any exit code): budget-free relaunches.
            # Failures then take the budgeted restart, and a loss past the
            # budget tries the elastic resize before the completion policy
            # may fail the job. (The JAX driver's ladder also discharges
            # scale-downs, donations and rolls: they come with the
            # autoscaler and the router.)
            if self._discharge_resize(task_id):
                return
            if self._discharge_preempt(task_id, exit_code):
                return
            if exit_code != 0 and self._try_restart_task(task_id, exit_code):
                return
            if (exit_code != 0 and self._elastic_candidate(task_id)
                    and self._resize_down(task_id,
                                          cause=f"exited {exit_code}")):
                return
        already_terminal = task.status.is_terminal()
        name, _, idx = task_id.partition(":")
        self.session.on_task_completed(name, int(idx), exit_code)
        if not already_terminal:
            self._jrec("terminal", task=task_id, status=task.status.value,
                       exit_code=exit_code)
            self._seal_task_trace(
                task_id, "finished" if exit_code == 0 else "failed",
                exit_code=exit_code, status=task.status.value)
            if self.events:
                self.events.emit(task_finished(
                    task_id, task.status.value, exit_code,
                    metrics=self.metrics.get(task_id, [])))
            if self.scheduler:
                self.scheduler.on_task_completed(name, exit_code == 0)

    def _try_restart_task(self, task_id: str, exit_code: int,
                          cause: str = "") -> bool:
        """Per-task restart within the same session, budgeted by
        tony.<role>.max-restarts; container exits and heartbeat deaths
        (``cause``) spend from the same budget."""
        name, _, idx = task_id.partition(":")
        spec = self.session.role_specs.get(name)
        if spec is None or spec.max_restarts <= 0:
            return False
        used = self._restarts.get(task_id, 0)
        if used >= spec.max_restarts:
            return False
        # a failure restart supersedes a pending preempt or resize entry:
        # a stale one would make the next crash a budget-free relaunch
        self._preempts.discard(task_id)
        self._preempt_cmds.discard(task_id)
        self._resizes.discard(task_id)
        self._straggler_strikes.pop(task_id, None)
        self._restarts[task_id] = used + 1
        self._jrec("restarts", task=task_id, used=used + 1)
        log.warning("task %s %s; restarting (%d/%d)", task_id,
                    cause or f"exited {exit_code}", used + 1,
                    spec.max_restarts)
        with self._tt_lock:
            self._restart_count += 1
        self._clear_attempt_state(task_id)
        self._trace_mark(task_id, "restarted", restarts=used + 1,
                         last_cause=cause or f"exited {exit_code}")
        self._relaunch_task(task_id, spec, int(idx))
        return True

    def _bump_attempt(self, task_id: str) -> int:
        att = self._attempts.get(task_id, 0) + 1
        self._attempts[task_id] = att
        return att

    def _journal_launch(self, task_id: str, handle: ContainerHandle) -> None:
        pid = handle.process.pid if handle.process is not None else 0
        self._jrec("launch", task=task_id,
                   attempt=self._attempts.get(task_id, 0),
                   container_id=handle.container_id, pid=pid,
                   host=handle.host, t=time.time(),
                   log_path=str(handle.extra.get("log_path", "")))

    def _relaunch_task(self, task_id: str, spec: RoleSpec, idx: int,
                       extra_env: dict[str, str] | None = None) -> None:
        """Launch a fresh attempt of an existing task: new container, fresh
        liveness, stale published ports dropped. ``extra_env`` rides this
        attempt only (the rejoin's TONY_PRESTAGE_CKPT)."""
        task = self.session.get_task_by_id(task_id)
        task.status = TaskStatus.REQUESTED
        task.exit_code = None  # re-arm heartbeat liveness
        # a clean slate: a deliberate-stop mark or a late preemption
        # notice of the superseded attempt (its notify can straggle behind
        # its own exit) must not reach the replacement, whose first real
        # crash would escape the budget
        self._driver_stops.discard(task_id)
        self._preempts.discard(task_id)
        self._preempt_cmds.discard(task_id)
        task.ports.clear()     # the old attempt's endpoints are dead
        task.launch_path = ""
        self._trace_mark(task_id, "requested")
        env = self._task_env(spec, idx)
        if extra_env:
            env.update(extra_env)
        env[c.ENV_TASK_ATTEMPT] = str(self._bump_attempt(task_id))
        with self._restart_lock:
            handle = self.provisioner.launch(
                spec, idx, env, self.job_dir / "logs")
            self._handles[task_id] = handle
        self.session.note_allocated(task_id, handle.container_id)
        self._journal_launch(task_id, handle)
        self._trace_mark(task_id, "allocated", host=handle.host)
        self._launch_ms[task_id] = now_ms()
        self._trace_mark(task_id, "launched")
        self.heartbeats.pop(task_id, None)
        if self.events:
            self.events.emit(task_started(task_id, handle.host))

    def publish_task_ports(self, task_id: str, ports: dict) -> bool:
        """publish_ports RPC body: merge the named ports into the task's
        session entry and record them on its lifecycle trace."""
        if not self.session.set_task_ports(task_id, ports):
            return False
        self._jrec("ports", task=task_id,
                   ports={str(k): int(v) for k, v in (ports or {}).items()})
        with self._tt_lock:
            tr = self.task_traces.get(task_id)
            if tr is not None:
                merged = dict(tr.attrs.get("ports", {}))
                merged.update({str(k): int(v) for k, v in ports.items()})
                tr.attrs["ports"] = merged
        log.info("%s published service ports %s", task_id, dict(ports))
        return True

    # --------------------------------------------------------------- monitor
    def monitor(self) -> JobStatus:
        """The driver hot loop — reference monitor:633-728 and its exit
        conditions: timeout, heartbeat expiry, registration timeout,
        runtime unhealthy, DAG stall, completion."""
        interval = self.conf.get_int(keys.AM_MONITOR_INTERVAL_MS, 200) / 1000
        timeout_ms = self.conf.get_int(keys.APPLICATION_TIMEOUT_MS, 0)
        reg_timeout_ms = self.conf.get_int(
            keys.AM_REGISTRATION_TIMEOUT_MS, 900000)
        hb_interval_ms = self.conf.get_int(
            keys.TASK_HEARTBEAT_INTERVAL_MS, 1000)
        max_missed = max(3, self.conf.get_int(
            keys.TASK_MAX_MISSED_HEARTBEATS, 25))
        hb_expiry_s = hb_interval_ms * max_missed / 1000

        while not self._stop_requested.is_set():
            now = time.time()

            # 1. application timeout
            if timeout_ms > 0 and now_ms() - self._start_ms > timeout_ms:
                self.session.kill_all(
                    f"application timed out after {timeout_ms}ms")
                return JobStatus.KILLED

            # 2. heartbeat expiry (reference onTaskDeemedDead:1229-1236); a
            # task whose executor reported its result stopped beating
            # legitimately
            for task_id, last in list(self.heartbeats.items()):
                task = self.session.get_task_by_id(task_id)
                if (task is None or task.status.is_terminal()
                        or task.exit_code is not None):
                    continue
                if task_id in self.session.detached:
                    # a detached slot's zombie executor may still beat on
                    # its way down: no longer liveness-tracked
                    self.heartbeats.pop(task_id, None)
                    continue
                if now - last <= hb_expiry_s:
                    continue
                with self._restart_lock:
                    # re-check under the lock: a concurrent completion
                    # restart may have just relaunched this task
                    last = self.heartbeats.get(task_id)
                    if last is None or now - last <= hb_expiry_s:
                        continue
                    msg = (f"task {task_id} missed {max_missed} "
                           "heartbeats; deemed dead")
                    log.error(msg)
                    with self._tt_lock:
                        self._hb_expired_count += 1
                    # popping the handle under the lock makes the dying
                    # container's completion read as superseded
                    old = self._handles.pop(task_id, None)
                    self.heartbeats.pop(task_id, None)
                    self._driver_stops.add(task_id)
                # stop BEFORE launching the replacement: the hung process
                # still holds its card
                if old is not None:
                    self.provisioner.stop_container(old)
                if (not self._stop_requested.is_set()
                        and self._try_restart_task(
                            task_id, c.EXIT_KILLED,
                            cause=f"missed {max_missed} heartbeats")):
                    continue
                # past its budget: an elastic job re-forms the gang from
                # the survivors instead of failing
                if (self._elastic_candidate(task_id)
                        and self._resize_down(task_id, cause=msg)):
                    continue
                self._seal_task_trace(task_id, "heartbeat_expired",
                                      reason=msg)
                self.session._fail(msg)
                self.session.on_task_completed(
                    task.name, task.index, c.EXIT_KILLED)
                self._jrec("terminal", task=task_id,
                           status=task.status.value, exit_code=c.EXIT_KILLED)

            # 2b. stragglers: restarted on the budget
            self._check_stragglers(now)
            # 2c. elastic scale-up: retry detached slots whose timer ran
            if self._elastic:
                self._try_rescale_up()
            # 2d. seeded chaos (TONY_TEST_DRIVER_*)
            self._chaos_tick()

            # 3. registration timeout (reference :1314-1334)
            for task_id, launched in list(self._launch_ms.items()):
                task = self.session.get_task_by_id(task_id)
                if task is None or task.status.is_terminal():
                    continue
                if (task.status == TaskStatus.ALLOCATED
                        and now_ms() - launched > reg_timeout_ms):
                    reg_msg = (f"task {task_id} failed to register within "
                               f"{reg_timeout_ms}ms")
                    # capacity that launches but never answers detaches
                    # like any other loss
                    if (self._elastic_candidate(task_id)
                            and self._resize_down(task_id, cause=reg_msg)):
                        self._launch_ms.pop(task_id, None)
                        continue
                    self.session._fail(reg_msg)

            # 4. runtime health (gang allocation deadlock breaker)
            if not self.runtime_driver.is_healthy(self.conf):
                self.session._fail(
                    "runtime reported unhealthy (allocation timeout)")

            # 5. DAG stall: dependencies failed, dependents can never run
            if self.scheduler and self.scheduler.unscheduled_roles():
                blocked = self.scheduler.unscheduled_roles()
                tracked_done = all(
                    t.status.is_terminal()
                    for t in self.session.tracked_tasks()
                    if t.name not in blocked)
                if tracked_done and self.session.status != JobStatus.FAILED:
                    self.session._fail(
                        "roles " + ",".join(blocked)
                        + " blocked by failed dependencies")

            status = self.session.update_status()
            if status.is_terminal():
                return status
            time.sleep(interval)
        return self.session.update_status()

    def _kill_task(self, task_id: str) -> None:
        handle = self._handles.get(task_id)
        if handle is not None:
            self._driver_stops.add(task_id)
            self.provisioner.stop_container(handle)

    # ------------------------------------------------------ preemption drain
    def preempt_task(self, task_id: str) -> bool:
        """Relay a preemption notice (the preempt_task RPC, chaos): queue
        a one-shot ``preempt`` command on the task's heartbeat answer.
        The executor drops the drain flag, the child checkpoints at its
        next step boundary and exits, and the completion relaunches
        budget-free with a ``preempted`` trace mark. False for an unknown,
        not yet running or terminal task."""
        task = self.session.get_task_by_id(task_id)
        if task is None or task.status != TaskStatus.RUNNING:
            return False
        with self._restart_lock:
            if task_id not in self._handles:
                return False
            first = task_id not in self._preempts
            self._preempts.add(task_id)
            self._preempt_cmds.add(task_id)
        self._jrec("ledger", kind="preempt", task=task_id, cmd=True)
        if first:
            with self._tt_lock:
                self._preempt_count += 1
            self._trace_mark(task_id, "preempting", preempt_source="driver")
        log.warning("preempting %s: drain notice queued on its heartbeat",
                    task_id)
        return True

    def note_preemption(self, task_id: str, source: str = "executor") -> bool:
        """The task's own executor reports an external preemption signal:
        nothing to relay (it is already draining its child), the pending
        exit is marked budget-free."""
        task = self.session.get_task_by_id(task_id)
        if (task is None or task.status.is_terminal()
                or self._stop_requested.is_set()):
            return False
        with self._restart_lock:
            if task_id in self._resizes or task_id in self._driver_stops:
                # the driver sent this SIGTERM itself (a resize drain or
                # a deliberate kill): the exit is accounted for already
                return True
            first = task_id not in self._preempts
            self._preempts.add(task_id)
        self._jrec("ledger", kind="preempt", task=task_id, cmd=False)
        if first:
            with self._tt_lock:
                self._preempt_count += 1
            self._trace_mark(task_id, "preempting", preempt_source=source)
            log.warning("%s reports a preemption (%s); its exit is "
                        "budget-free", task_id, source)
        return True

    def take_preempt_command(self, task_id: str) -> dict | None:
        """Pop ``task_id``'s waiting preempt relay (the heartbeat's)."""
        with self._restart_lock:
            if task_id not in self._preempt_cmds:
                return None
            self._preempt_cmds.discard(task_id)
        return {"grace_ms": self.conf.get_int(
            keys.TASK_PREEMPT_GRACE_MS, 3000)}

    def _discharge_preempt(self, task_id: str, exit_code: int) -> bool:
        """Container completion of a preempted task (a commanded drain, a
        self-reported preemption, or an uncommanded EXIT_PREEMPTED: the
        child drained on its own notice): relaunch without charging the
        budget, trace-marked ``preempted``. The caller holds the restart
        lock, and the superseded-container guard already made this the
        current attempt's completion, so a racing heartbeat-expiry
        restart cannot spend twice."""
        commanded = task_id in self._preempts
        if not commanded and (exit_code != c.EXIT_PREEMPTED
                              or task_id in self._driver_stops):
            return False
        if exit_code == 0:
            # training finished before (or despite) the notice: a real
            # completion, final
            self._preempts.discard(task_id)
            self._preempt_cmds.discard(task_id)
            return False
        if not commanded:
            # self-initiated: counted here (the others at notice time)
            with self._tt_lock:
                self._preempt_count += 1
        self._preempts.discard(task_id)
        self._preempt_cmds.discard(task_id)
        name, _, idx = task_id.partition(":")
        spec = self.session.role_specs.get(name)
        if spec is None:
            return False
        self._clear_attempt_state(task_id)
        self._trace_mark(task_id, "preempted", exit_code=exit_code)
        log.info("relaunching preempted %s (budget-free)", task_id)
        self._relaunch_task(task_id, spec, int(idx))
        return True

    # --------------------------------------------------- elastic gang resize
    def _elastic_candidate(self, task_id: str) -> bool:
        """May this task, lost past its budget, be detached instead of
        failing the job? Elastic on, the job live, the task a tracked
        non-chief, and the role's survivors at or above the floor."""
        if not self._elastic or self._stop_requested.is_set():
            return False
        task = self.session.get_task_by_id(task_id)
        if task is None or task_id in self.session.detached:
            return False
        if task.name in self.session.untracked:
            return False
        if self.session.is_chief(task.name, task.index):
            # the chief carries the completion policy and rank 0's
            # coordinator: its loss stays fatal
            return False
        survivors = [t for t in self.session.active_tasks()
                     if t.name == task.name and t.task_id != task_id
                     and not t.status.is_terminal()]
        return len(survivors) >= self._elastic_min

    def _drain_survivors(self, task_id: str) -> list:
        """Mark every other RUNNING active task mid-resize and take its
        handle (caller holds the restart lock) -> (survivors, handles).
        The JAX driver drains only the lost task's priority class; the
        port refuses every class but the default (check_ported), so that
        is every task."""
        survivors = [t.task_id for t in self.session.active_tasks()
                     if t.status == TaskStatus.RUNNING
                     and t.task_id != task_id]
        handles = []
        for tid in survivors:
            self._resizes.add(tid)
            self.heartbeats.pop(tid, None)
            h = self._handles.get(tid)
            if h is not None:
                handles.append(h)
        # the straggler ledger is attempt-scoped
        self._straggler_strikes.clear()
        return survivors, handles

    def _stop_off_lock(self, handles, name: str) -> None:
        """Stop containers each on a thread of its own, off the lock: a
        slow drain costs its own grace, not a stall of every other
        completion."""
        for h in handles:
            threading.Thread(target=self.provisioner.stop_container,
                             args=(h,), name=f"{name}-{h.role}:{h.index}",
                             daemon=True).start()

    def _resize_down(self, task_id: str, cause: str) -> bool:
        """A worker is gone past its restart budget: detach it, bump the
        gang generation, and drain every surviving RUNNING task so the
        gang re-forms from its checkpoints at the smaller world size (the
        survivors' relaunches are budget-free). The slot is tried again
        every rescale-retry-ms (_try_rescale_up)."""
        with self._restart_lock:
            if self._stop_requested.is_set():
                return False
            if not self.session.detach_task(task_id):
                return False
            old = self._handles.pop(task_id, None)
            self.heartbeats.pop(task_id, None)
            self._preempts.discard(task_id)
            self._preempt_cmds.discard(task_id)
            self._detach_t[task_id] = time.monotonic()
            gen = self.session.begin_generation()
            with self._tt_lock:
                self._resize_count += 1
            survivors, handles = self._drain_survivors(task_id)
        self._jrec("detach", task=task_id)
        self._jrec("generation", gen=gen)
        for tid in survivors:
            self._jrec("ledger", kind="resize", task=tid)
        log.warning("elastic resize DOWN to generation %d: %s lost (%s); "
                    "draining %d survivors to re-form at the smaller world "
                    "size", gen, task_id, cause, len(survivors))
        self._trace_mark(task_id, "resized", gang_generation=gen,
                         resize="detached", resize_cause=cause)
        for tid in survivors:
            self._trace_mark(tid, "resized", gang_generation=gen,
                             resize="down", lost=task_id)
            self.metrics.pop(tid, None)   # stale step stats
        self._stop_off_lock(([old] if old is not None else []) + handles,
                            "resize-drain")
        return True

    def _discharge_resize(self, task_id: str) -> bool:
        """Container completion of a survivor draining for a resize: a
        budget-free relaunch into the new generation. The caller holds
        the restart lock."""
        if task_id not in self._resizes:
            return False
        self._resizes.discard(task_id)
        # the drain's SIGTERM looks like a cloud preemption to the
        # executor, which reports it: the resize owns this exit, and a
        # stale preempt entry would relaunch the next real completion too
        self._preempts.discard(task_id)
        self._preempt_cmds.discard(task_id)
        name, _, idx = task_id.partition(":")
        spec = self.session.role_specs.get(name)
        if spec is None:
            return False
        self._clear_attempt_state(task_id)
        self._relaunch_task(task_id, spec, int(idx))
        return True

    def _try_rescale_up(self) -> None:
        """Monitor hook: a detached slot whose retry timer ran is
        re-attached; the survivors drain again and the whole gang
        re-registers at the restored world size. The rejoining executor
        prestages ``tony.train.checkpoint-dir``. If the provisioner still
        cannot place it (its launch raises), the slot detaches again and
        the timer re-arms."""
        if not self._detach_t or self._stop_requested.is_set():
            return
        now = time.monotonic()
        task_id = next((t for t, t0 in self._detach_t.items()
                        if now - t0 >= self._rescale_retry_s), None)
        if task_id is None:
            return
        name, _, idx = task_id.partition(":")
        spec = self.session.role_specs.get(name)
        with self._restart_lock:
            if self._stop_requested.is_set():
                return
            self._detach_t.pop(task_id, None)
            if spec is None or not self.session.reattach_task(task_id):
                return
            gen = self.session.begin_generation()
            with self._tt_lock:
                self._resize_count += 1
            # the returned slot is fresh capacity: its budget starts over
            self._restarts.pop(task_id, None)
            survivors, handles = self._drain_survivors(task_id)
        self._jrec("reattach", task=task_id)
        self._jrec("generation", gen=gen)
        for tid in survivors:
            self._jrec("ledger", kind="resize", task=tid)
        log.warning("elastic resize UP to generation %d: re-adding %s; "
                    "draining %d survivors to re-form at the restored world "
                    "size", gen, task_id, len(survivors))
        self._trace_mark(task_id, "resized", gang_generation=gen,
                         resize="rejoined")
        for tid in survivors:
            self._trace_mark(tid, "resized", gang_generation=gen,
                             resize="up", rejoined=task_id)
            self.metrics.pop(tid, None)
        ckpt_dir = str(self.conf.get(keys.TRAIN_CKPT_DIR, "") or "")
        extra_env = {c.ENV_PRESTAGE_CKPT: ckpt_dir} if ckpt_dir else None
        try:
            with self._restart_lock:
                self._clear_attempt_state(task_id)
                self._relaunch_task(task_id, spec, int(idx),
                                    extra_env=extra_env)
        except Exception as e:
            # capacity still gone: the survivors re-register into the
            # current generation, which excludes the re-detached slot
            log.warning("rescale-up launch of %s failed (%s); staying at "
                        "the smaller world size", task_id, e)
            with self._restart_lock:
                self.session.detach_task(task_id)
                self._detach_t[task_id] = time.monotonic()
            self._jrec("detach", task=task_id)
        self._stop_off_lock(handles, "resize-drain")

    # ------------------------------------------------------------ stragglers
    def _check_stragglers(self, now: float) -> None:
        """Per role, compare each RUNNING task's pushed step-time p50 with
        the role's median; a non-chief slower than
        ``tony.train.straggler-restart-factor`` times it for
        ``straggler-grace-checks`` checks in a row is restarted through
        the normal budget (a fresh process, the cure for a degraded
        host). A factor of 1 or less turns it off."""
        if self._straggler_factor <= 1.0 or self._stop_requested.is_set():
            return
        if now - self._straggler_check_t < 2.0:   # pushes come every ~5 s
            return
        self._straggler_check_t = now
        metric = f"max_{STEP_TIME_P50_S}"
        for role in self.session.role_specs:
            p50s: dict[str, float] = {}
            for t in self.session.active_tasks():
                if t.name != role or t.status != TaskStatus.RUNNING:
                    continue
                v = self._pushed_metric(t.task_id, metric)
                if v is not None and v > 0:
                    p50s[t.task_id] = v
            if len(p50s) < 2:
                continue
            median = float(statistics.median(p50s.values()))
            if median <= 0:
                continue
            for task_id, p50 in p50s.items():
                name, _, idx = task_id.partition(":")
                if p50 <= self._straggler_factor * median:
                    self._straggler_strikes.pop(task_id, None)
                    continue
                if self.session.is_chief(name, int(idx)):
                    continue    # rank 0's restart tears down everyone's
                strikes = self._straggler_strikes.get(task_id, 0) + 1
                self._straggler_strikes[task_id] = strikes
                if strikes < self._straggler_grace:
                    continue
                spec = self.session.role_specs.get(name)
                if (spec is None
                        or self._restarts.get(task_id, 0) >= spec.max_restarts):
                    continue    # no budget left: tolerate the laggard
                cause = (f"straggler: step p50 {p50:.3f}s vs role median "
                         f"{median:.3f}s (factor {self._straggler_factor})")
                # the stop and the restart run under the restart lock, so
                # a concurrent exit's restart cannot strand a stopped task
                with self._restart_lock:
                    if self._restarts.get(task_id, 0) >= spec.max_restarts:
                        continue
                    old = self._handles.pop(task_id, None)
                    self.heartbeats.pop(task_id, None)
                    self._driver_stops.add(task_id)
                    self.metrics.pop(task_id, None)
                    self._straggler_strikes.pop(task_id, None)
                    if old is not None:
                        self.provisioner.stop_container(old)
                    self._try_restart_task(task_id, c.EXIT_KILLED,
                                           cause=cause)
                return      # one restart a check: the median moves

    # ---------------------------------------------------------- driver chaos
    def _chaos_tick(self) -> None:
        """Seeded fault injection, one decision a monitor tick: a SIGKILL
        of a random running container (``TONY_TEST_DRIVER_KILL_RATE``),
        and one preemption drain once the gang's pushed training step
        reaches ``TONY_TEST_DRIVER_PREEMPT_AT_STEP``."""
        if self._stop_requested.is_set():
            return
        if self._chaos_kill_rate and (
                self._chaos_rng.random() < self._chaos_kill_rate):
            with self._restart_lock:
                live = sorted(t.task_id for t in self.session.active_tasks()
                              if t.status == TaskStatus.RUNNING
                              and t.task_id in self._handles
                              and t.task_id not in self._resizes)
                victim = self._chaos_rng.choice(live) if live else None
                handle = self._handles.get(victim) if victim else None
            if handle is not None:
                log.warning("chaos: SIGKILLing %s (%s)", victim,
                            handle.container_id)
                self.provisioner.kill_container(handle)
        if self._chaos_preempt_at and not self._chaos_preempt_fired:
            steps = [self._pushed_metric(t.task_id, f"max_{TRAIN_STEP}")
                     for t in self.session.active_tasks()]
            top = max((s for s in steps if s is not None), default=0)
            if top >= self._chaos_preempt_at:
                live = sorted(t.task_id for t in self.session.active_tasks()
                              if t.status == TaskStatus.RUNNING
                              and t.task_id in self._handles)
                if live:
                    victim = self._chaos_rng.choice(live)
                    self._chaos_preempt_fired = True
                    log.warning("chaos: preempting %s at observed step %d",
                                victim, int(top))
                    self.preempt_task(victim)

    # ----------------------------------------------------------------- retry
    def reset(self) -> None:
        """Stop everything, rebuild the session with session_id+1 —
        reference reset:611-627."""
        self.provisioner.stop_all()
        self._seal_remaining_traces()
        old = self.session
        self.session = Session(self.conf, session_id=old.session_id + 1)
        self.runtime_driver = self._runtime.driver_adapter()
        self.runtime_driver.set_session(self.session)
        # a whole-job retry starts from scratch: truncate the journal and
        # re-stamp the meta. _attempts stays: the fence must keep refusing
        # the previous session's zombies.
        if self._journal is not None:
            self._journal.close()
            try:
                (self.job_dir / c.DRIVER_JOURNAL_FILE).write_text("")
            except OSError:
                log.exception("could not truncate the driver journal")
            self._journal = DriverJournal(
                self.job_dir / c.DRIVER_JOURNAL_FILE)
            self._jrec("meta", app_id=self.app_id, token=self.token,
                       session_id=self.session.session_id,
                       rpc_port=self.rpc_server.port,
                       driver_generation=self.driver_generation)
        self.heartbeats.clear()
        self._handles.clear()
        self._launch_ms.clear()
        self._restarts.clear()
        self.metrics.clear()
        for ledger in (self._preempts, self._preempt_cmds, self._resizes,
                       self._detach_t, self._driver_stops,
                       self._straggler_strikes):
            ledger.clear()

    # ------------------------------------------------------------------ stop
    def stop(self) -> None:
        """Reference stop:739-781: stop containers, wait briefly for the
        client's finish signal so it can read terminal state, then tear
        down. The stop flag goes up first: a container stopped here exits
        non-zero, and its completion must not relaunch it on the restart
        budget (the JAX driver never raises the flag, so a task with
        restarts left is relaunched into a driver that is exiting)."""
        self._stop_requested.set()
        status = self.session.status
        self.provisioner.stop_all()
        self._seal_remaining_traces()
        if self.events:
            failed = sum(1 for t in self.session.all_tasks()
                         if t.status in (TaskStatus.FAILED,
                                         TaskStatus.KILLED))
            self.events.emit(application_finished(
                self.app_id, status.value, failed,
                self.session.failure_message))
        # grace window for the client to pull final state + ack
        self.client_signal.wait(timeout=10)
        if self.events:
            self.events.stop(status.value)
        if self._task_trace_writer is not None:
            self._task_trace_writer.close()
        if self._journal is not None:
            self._journal.close()
        if self._metrics_httpd is not None:
            self._metrics_httpd.shutdown()
            self._metrics_httpd.server_close()
        self.rpc_server.stop()


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s driver %(name)s: %(message)s")
    parser = argparse.ArgumentParser(description="the port's job driver")
    parser.add_argument("--job-dir", required=True)
    parser.add_argument("--app-id", required=True)
    parser.add_argument("--recover", action="store_true",
                        help="not ported yet: refused")
    args = parser.parse_args(argv)
    if args.recover:
        raise _not_ported("driver --recover (Driver.recover/_restore)",
                          RECOVERY)

    conf = TonyConf.from_final(args.job_dir)
    token = os.environ.get(c.ENV_TOKEN, "")

    # a killed driver must take its containers with it: executors run in
    # their own process groups — mirror the reference AM shutdown hook.
    # Registered BEFORE the Driver exists, via a holder.
    import signal as _signal

    holder: dict = {}

    def _teardown(signum):
        try:
            if holder.get("driver") is not None:
                # no relaunch of what this stop kills (Driver.stop)
                holder["driver"]._stop_requested.set()
                holder["driver"].provisioner.stop_all()
        except Exception:
            log.exception("stop_all on signal failed")
        os._exit(128 + signum)

    def _on_term(signum, frame):
        # tear down on a helper thread: stop_all takes the provisioner lock,
        # which the interrupted main thread may hold
        log.warning("signal %d: stopping all containers and exiting", signum)
        threading.Thread(target=_teardown, args=(signum,), daemon=True).start()

    _signal.signal(_signal.SIGTERM, _on_term)
    _signal.signal(_signal.SIGINT, _on_term)

    driver = Driver(conf, app_id=args.app_id, job_dir=args.job_dir,
                    token=token)
    holder["driver"] = driver

    if os.environ.get(c.TEST_DRIVER_CRASH):
        def _crash_later():
            time.sleep(float(os.environ[c.TEST_DRIVER_CRASH]))
            log.error("TEST_DRIVER_CRASH: exiting now")
            os._exit(3)
        threading.Thread(target=_crash_later, daemon=True).start()

    status = driver.run()
    log.info("driver exiting with job status %s", status.value)
    return 0 if status == JobStatus.SUCCEEDED else 1


if __name__ == "__main__":
    sys.exit(main())
