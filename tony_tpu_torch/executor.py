"""Per-container executor agent (the port's own copy of the JAX package's
executor.py).

Mirrors the reference TaskExecutor (tony-core/.../TaskExecutor.java): reads
the env contract (initConfigs:239-283), allocates its rendezvous port
(setupPorts:88-100), registers with the driver and blocks on the gang
barrier (registerAndGetClusterSpec:285-299), heartbeats (Heartbeater:
324-364), samples metrics (metrics.TaskMonitor: RSS, the task's card through
nvidia-smi, the StepTimer JSONL at ``$TONY_STEP_LOG``), delegates env
construction and the user process to the runtime task adapter (main:
188-237), and reports the exit code (registerExecutionResult:315-322).

It runs as ``python -S -m tony_tpu_torch.executor`` and imports no torch:
the user process it forks owns the card. The driver's commands ride a
heartbeat's answer and become flag files beside ``$TONY_STEP_LOG``, which
the training child's StepTimer polls: ``profile`` -> ``.profile``
(``write_profile_flag``), ``preempt`` -> ``.preempt``
(``write_preempt_flag``: the child checkpoints at its next step boundary
and exits EXIT_PREEMPTED). A SIGTERM to this executor (a cloud preemption,
or the driver draining a survivor for an elastic resize) is relayed the
same way, with ``notify_preemption`` to the driver, for every framework
but ``serving``, whose child drains itself; a grace watchdog terminates a
child that does not drain. An elastic rejoin (``$TONY_PRESTAGE_CKPT``)
reads the newest checkpoint before it registers (utils/prestage.py).

Not ported from the JAX executor: warm-pool adoption (executor.py:497-516,
ROADMAP.md queue 1's warm pool item) and the driver-outage ride-through
with endpoint re-resolution and its drain (driver recovery). A driver that
stops answering for ``tony.task.driver-outage-grace-ms`` takes this
executor and its child down.

Fault-injection hooks are production code paths keyed off env vars, like the
reference's TEST_* hooks (Constants.java:124-130, TaskExecutor.java:328-386).
"""

from __future__ import annotations

import json
import logging
import os
import random
import signal
import socket
import sys
import threading
import time

from . import constants as c
from .api import DistributedMode
from .conf import TonyConf, keys
from .metrics import TaskMonitor
from .rpc import RpcClient

log = logging.getLogger(__name__)


def _write_flag_file(step_log: str, suffix: str, payload: dict,
                     label: str) -> str | None:
    """Write ``<step_log><suffix>`` through a temporary file and a rename,
    so the training child's StepTimer never reads a torn request. One
    writer for every flag kind."""
    flag = step_log + suffix
    tmp = flag + ".tmp"
    try:
        with open(tmp, "w") as f:
            f.write(json.dumps(payload))
        os.replace(tmp, flag)
    except (OSError, TypeError, ValueError) as e:
        log.warning("could not write the %s flag: %s", label, e)
        return None
    return flag


def write_profile_flag(step_log: str | None, cmd: dict) -> str | None:
    """Relay a driver's profile command to the training child (the JAX
    package's executor.py:57): ``$TONY_STEP_LOG.profile`` with the
    capture's seconds and where its trace goes, ``logs/profiles/<task>_
    <unix time>/`` beside the step log. -> the flag's path, or None
    without a step log (nothing would poll the flag)."""
    if not step_log:
        log.warning("profile command dropped: no step log configured")
        return None
    stem = os.path.basename(step_log).partition(".")[0]
    out_dir = os.path.join(os.path.dirname(step_log), c.PROFILE_DIR_NAME,
                           f"{stem}_{int(time.time())}")
    try:
        payload = {"seconds": float(cmd.get("seconds", 5.0)),
                   "out_dir": out_dir}
    except (TypeError, ValueError, AttributeError) as e:
        log.warning("could not write the profile flag: %s", e)
        return None
    flag = _write_flag_file(step_log, c.PROFILE_REQUEST_SUFFIX, payload,
                            "profile")
    if flag:
        log.info("profile command relayed via %s -> %s", flag, out_dir)
    return flag


def write_preempt_flag(step_log: str | None, cmd: dict) -> str | None:
    """Relay a preemption drain notice to the training child (the JAX
    package's executor.py:85): ``$TONY_STEP_LOG.preempt`` with the grace
    and the notice's time. The child checkpoints at its next step
    boundary and exits EXIT_PREEMPTED; the driver relaunches it without
    spending the restart budget. -> the flag's path, or None without a
    step log (the grace watchdog then does the draining)."""
    if not step_log:
        log.warning("preempt notice: no step log configured; relying on "
                    "the grace watchdog")
        return None
    try:
        payload = {"grace_ms": float(cmd.get("grace_ms", 3000)),
                   "ts": time.time()}
    except (TypeError, ValueError, AttributeError) as e:
        log.warning("could not write the preempt flag: %s", e)
        return None
    flag = _write_flag_file(step_log, c.PREEMPT_REQUEST_SUFFIX, payload,
                            "preempt")
    if flag:
        log.info("preempt notice relayed via %s", flag)
    return flag


class Heartbeater(threading.Thread):
    """Reference TaskExecutor.Heartbeater:324-364, with the skip-N-
    heartbeats fault hook. Doubles as the driver-death watchdog: a beat the
    driver refuses counts toward ``max_failures``; a beat that cannot reach
    the driver at all opens an outage window of ``outage_grace_s``. Either
    budget spent calls ``on_driver_lost``. Each wait is jittered ±10% so a
    gang's beats do not land on the driver in one burst. ``monitor`` (the
    TaskMonitor) receives each beat's round trip and the missed-beat
    count. The driver's commands ride a beat's answer: a dict instead of
    the plain True, whose ``"profile"`` goes to ``on_command`` and whose
    ``"preempt"`` goes to ``on_preempt`` (a raising callback never stops
    the beat: the beat is the liveness signal)."""

    def __init__(self, client: RpcClient, task_id: str, interval_s: float,
                 max_failures: int = 30, on_driver_lost=None, monitor=None,
                 on_command=None, on_preempt=None,
                 outage_grace_s: float = 30.0):
        super().__init__(name="heartbeater", daemon=True)
        self._client = client
        self._task_id = task_id
        self._interval = interval_s
        self._skip = int(os.environ.get(c.TEST_EXECUTOR_NUM_HB_MISS, "0"))
        self._max_failures = max_failures
        self._on_driver_lost = on_driver_lost
        self._monitor = monitor
        self._on_command = on_command
        self._on_preempt = on_preempt
        self._outage_grace_s = max(0.0, float(outage_grace_s))
        self._rng = random.Random()     # urandom-seeded: per-process phase
        self.missed = 0
        self.stop_event = threading.Event()

    def _note(self, name: str, value: float) -> None:
        if self._monitor is not None:
            self._monitor.note(name, value)

    def _lost(self) -> None:
        if self._on_driver_lost:
            self._on_driver_lost()

    def run(self) -> None:
        from .metrics import HEARTBEAT_RTT_MS, HEARTBEATS_MISSED
        from .rpc import RpcError

        failures = 0
        outage_t: float | None = None
        while not self.stop_event.wait(
                self._interval * self._rng.uniform(0.9, 1.1)):
            if self._skip > 0:
                self._skip -= 1
                log.warning("fault injection: skipping heartbeat (%d left)",
                            self._skip)
                continue
            try:
                t0 = time.monotonic()
                result = self._client.call("heartbeat",
                                           task_id=self._task_id)
                self._note(HEARTBEAT_RTT_MS,
                           (time.monotonic() - t0) * 1000.0)
                failures, outage_t = 0, None
                if isinstance(result, dict):
                    for key, cb in (("profile", self._on_command),
                                    ("preempt", self._on_preempt)):
                        cmd = result.get(key)
                        if cmd and cb is not None:
                            try:
                                cb(cmd)
                            except Exception:
                                log.exception("heartbeat command failed")
            except RpcError as e:
                # the driver answered and refused: this executor is
                # disowned, the classic budget
                outage_t = None
                failures += 1
                self.missed += 1
                self._note(HEARTBEATS_MISSED, float(self.missed))
                log.warning("heartbeat refused (%d/%d): %s",
                            failures, self._max_failures, e)
                if failures >= self._max_failures:
                    log.error("driver refused %d heartbeats; giving up",
                              failures)
                    self._lost()
                    return
            except Exception as e:
                # transport failure: the driver process is unreachable
                if outage_t is None:
                    outage_t = time.monotonic()
                    log.warning("driver unreachable (%s); %.1fs of outage "
                                "grace", e, self._outage_grace_s)
                if time.monotonic() - outage_t > self._outage_grace_s:
                    log.error("driver unreachable for %.1fs; exiting",
                              time.monotonic() - outage_t)
                    self._lost()
                    return


class Executor:
    def __init__(self) -> None:
        env = os.environ
        self.job_name = env[c.ENV_JOB_NAME]
        self.task_index = int(env[c.ENV_TASK_INDEX])
        self.task_num = int(env.get(c.ENV_TASK_NUM, "1"))
        self.num_total_tasks = int(env.get(c.ENV_NUM_TOTAL_TASKS, "1"))
        self.is_chief = env.get(c.ENV_IS_CHIEF, "false") == "true"
        self.session_id = int(env.get(c.ENV_SESSION_ID, "0"))
        self.mode = DistributedMode(env.get(c.ENV_DISTRIBUTED_MODE, "GANG"))
        self.driver_host = env[c.ENV_DRIVER_HOST]
        self.driver_port = int(env[c.ENV_DRIVER_PORT])
        self.app_id = env.get(c.ENV_APP_ID, "")
        self.job_dir = env.get(c.ENV_JOB_DIR, "")
        self.command = env.get(c.ENV_TASK_COMMAND, "")
        self.task_id = f"{self.job_name}:{self.task_index}"
        # launch ordinal of this attempt, echoed on register_worker so the
        # driver refuses a superseded attempt's registration
        try:
            self.attempt = int(env.get(c.ENV_TASK_ATTEMPT, "-1") or -1)
        except ValueError:
            self.attempt = -1
        # one drain watchdog an attempt (_arm_drain_watchdog)
        self._drain_armed = False

        # remote-host localization: when the client's job dir isn't visible
        # here (no shared FS) — or localization is forced — fetch + unpack
        # the shipped archive and use the local copy as the job dir
        # (reference Utils.extractResources, util/Utils.java:758-771)
        archive_uri = env.get(c.ENV_JOB_ARCHIVE, "")
        force_localize = env.get(c.ENV_LOCALIZE, "") == "true"
        from .conf import FINAL_CONF_NAME

        final_visible = self.job_dir and os.path.exists(
            os.path.join(self.job_dir, FINAL_CONF_NAME))
        if archive_uri and (force_localize or not final_visible):
            from .utils import shipping

            self.job_dir = shipping.localize_job(
                archive_uri, self.app_id,
                sha256=env.get(c.ENV_JOB_ARCHIVE_SHA256) or None)
            log.info("running from localized job dir %s", self.job_dir)

        self.conf = (TonyConf.from_final(self.job_dir) if self.job_dir
                     else TonyConf())

        token = env.get(c.ENV_TOKEN, "")
        # ENV_TOKEN carries the executor-role key (derived one-way from the
        # job secret by the driver): enough for the umbilical methods,
        # unable to sign client-privileged ones
        self.rpc = RpcClient(self.driver_host, self.driver_port, token=token,
                             max_retries=30,
                             role="executor" if token else "")

        from .runtimes import get_runtime

        # per-role runtime override; "" = the app-level framework
        self.framework = str(
            self.conf.get(keys.role_key(self.job_name, "framework"), "")
            or self.conf.get(keys.APPLICATION_FRAMEWORK, "torch"))
        self.adapter = get_runtime(self.framework).task_adapter()

        # the port this task advertises: the torch runtime's rank 0 hands
        # it to the TCP store as the coordinator; a serving replica binds
        # it. Ephemeral reservations are released just before exec,
        # SO_REUSEPORT ones held across it (reference setupPorts:88-100)
        from .utils import ports

        self._port_res = ports.allocate(
            self.conf.get_bool(keys.TASK_PORT_REUSE_ENABLED, False))
        self.port = self._port_res.port
        self.host = self._my_host()

        # TB port: chief of a TB-aware runtime, or a dedicated `tensorboard`
        # sidecar role (reference TaskExecutor.java:92-99)
        self.tb_port: int | None = None
        self._tb_res: ports.ServerPort | None = None
        if ((self.adapter.need_tb_port() and self.is_chief)
                or self.job_name == "tensorboard"):
            self._tb_res = ports.allocate(
                self.conf.get_bool(keys.TASK_TB_PORT_REUSE_ENABLED, False))
            self.tb_port = self._tb_res.port

    def _my_host(self) -> str:
        # route-based local address discovery; falls back to loopback for
        # the single-host mini-cluster
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.connect((self.driver_host, self.driver_port))
            host = s.getsockname()[0]
            s.close()
            return host
        except OSError:
            return "127.0.0.1"

    # ---------------------------------------------------------------- barrier
    def register_and_get_cluster_spec(self) -> dict:
        """Register, then poll until the gang barrier opens — reference
        registerAndGetClusterSpec:285-299."""
        self._maybe_skew()
        poll_s = self.conf.get_int(keys.TASK_REGISTRATION_POLL_MS, 250) / 1000
        payload = self.rpc.call(
            "register_worker", task_id=self.task_id, host=self.host,
            port=self.port, attempt=self.attempt)
        while payload is None:
            time.sleep(poll_s)
            payload = self.rpc.call("get_cluster_spec", task_id=self.task_id)
        return payload

    def _maybe_skew(self) -> None:
        """TONY_TEST_EXECUTOR_SKEW=job#idx#ms — straggler simulation
        (reference skewAndHangIfTesting:366-386)."""
        spec = os.environ.get(c.TEST_EXECUTOR_SKEW, "")
        if not spec:
            return
        try:
            job, idx, ms = spec.split("#")
            if job == self.job_name and int(idx) == self.task_index:
                log.warning("fault injection: skewing registration by %sms",
                            ms)
                time.sleep(int(ms) / 1000)
        except ValueError:
            log.error("bad skew spec: %s", spec)

    # -------------------------------------------------------- preempt drain
    def _arm_drain_watchdog(self, ctx_holder: dict, grace_s: float) -> None:
        """Give the training child ``grace_s`` to checkpoint at a step
        boundary and exit on its own; terminate it after. Armed once an
        attempt: a repeated notice must not stack timers."""
        if self._drain_armed:
            return
        self._drain_armed = True

        def _enforce():
            proc = getattr(ctx_holder.get("ctx"), "child_process", None)
            if proc is not None and proc.poll() is None:
                log.warning("preempt drain grace (%.1fs) expired; "
                            "terminating the child", grace_s)
                proc.terminate()
                try:
                    proc.wait(timeout=2)
                except Exception:
                    proc.kill()

        t = threading.Timer(grace_s, _enforce)
        t.daemon = True
        t.start()

    def _on_preempt_notice(self, ctx_holder: dict, cmd: dict,
                           notify_driver: bool = False) -> None:
        """Drain on a preemption notice (the heartbeat's ``preempt``
        command, or a SIGTERM to this executor): drop the flag the child's
        StepTimer polls and arm the grace watchdog for a child that never
        polls. With ``notify_driver`` (the SIGTERM path, which the driver
        may not know of) report the preemption, so the coming exit is
        relaunched without spending the budget."""
        try:
            grace_s = max(0.1, float(cmd.get("grace_ms", 3000)) / 1000)
        except (TypeError, ValueError, AttributeError):
            grace_s = 3.0
        write_preempt_flag(self._step_log_path(), cmd)
        self._arm_drain_watchdog(ctx_holder, grace_s)
        if not notify_driver:
            return

        def _notify():
            # a fast client of its own: the shared one retries for about
            # a minute, and a notice that straggles long past this
            # executor's exit could mark the replacement attempt as
            # preempting (the driver fences that on relaunch too)
            token = os.environ.get(c.ENV_TOKEN, "")
            nrpc = RpcClient(self.driver_host, self.driver_port,
                             token=token, max_retries=3,
                             role="executor" if token else "")
            try:
                nrpc.call("notify_preemption", task_id=self.task_id)
            except Exception as e:
                log.warning("could not report the preemption: %s", e)
            finally:
                nrpc.close()

        threading.Thread(target=_notify, name="preempt-notify",
                         daemon=True).start()

    def _clear_stale_preempt_flag(self) -> None:
        """A drain notice relayed to the previous attempt, whose child
        died before it polled (a SIGTERM during its start-up), is still on
        disk: left there, it would drain this attempt at its first step."""
        step_log = self._step_log_path()
        if not step_log:
            return
        try:
            os.unlink(step_log + c.PREEMPT_REQUEST_SUFFIX)
            log.info("removed a superseded attempt's preempt flag")
        except FileNotFoundError:
            pass
        except OSError as e:
            log.warning("could not remove a stale preempt flag: %s", e)

    def _prestage(self, monitor) -> None:
        """An elastic rejoin carries ``$TONY_PRESTAGE_CKPT``: read the
        newest checkpoint under it ($VARS expanded, e.g. a per-task
        ``ckpt_$TONY_TASK_INDEX``) before registering, so the barrier
        opens onto a worker whose checkpoint bytes are local. A failure
        leaves the child a cold restore."""
        directory = os.environ.get(c.ENV_PRESTAGE_CKPT, "")
        if not directory:
            return
        from .utils.prestage import prestage_checkpoint

        t0 = time.monotonic()
        staged = prestage_checkpoint(os.path.expandvars(directory))
        if staged is None:
            return
        monitor.add_span("ckpt_prestaged", attrs={
            "prestage_step": staged["step"],
            "prestage_files": staged["files"],
            "prestage_bytes": staged["bytes"],
            "prestage_s": round(time.monotonic() - t0, 3)})
        log.info("prestaged checkpoint step %s (%d files, %d bytes) in "
                 "%.2fs before registration", staged["step"],
                 staged["files"], staged["bytes"], time.monotonic() - t0)

    # -------------------------------------------------------------------- run
    def run(self) -> int:
        if os.environ.get(c.TEST_TASK_EXECUTOR_CRASH):
            log.error("fault injection: executor crashing before registration")
            return 3

        hb_interval = self.conf.get_int(
            keys.TASK_HEARTBEAT_INTERVAL_MS, 1000) / 1000
        ctx_holder: dict = {}

        def _die_with_driver() -> None:
            proc = getattr(ctx_holder.get("ctx"), "child_process", None)
            if proc is not None and proc.poll() is None:
                proc.kill()
            os._exit(c.EXIT_KILLED)

        # created (not started) before the heartbeater so beat RTT and
        # missed-beat counts accumulate from the first beat on; the sampler
        # thread starts once the gang barrier opens
        monitor = TaskMonitor(
            self.rpc, self.task_id,
            interval_s=self.conf.get_int(
                keys.TASK_METRICS_INTERVAL_MS, 5000) / 1000)
        # a dedicated fast-fail client: the shared one retries each call
        # for about a minute, and here one failed call is one missed beat.
        # Started BEFORE the gang barrier so a driver that dies
        # mid-registration still takes this executor down
        hb_token = os.environ.get(c.ENV_TOKEN, "")
        hb_rpc = RpcClient(self.driver_host, self.driver_port,
                           token=hb_token, max_retries=1,
                           role="executor" if hb_token else "")
        heartbeater = Heartbeater(
            hb_rpc, self.task_id, hb_interval,
            max_failures=max(
                3, self.conf.get_int(keys.TASK_MAX_MISSED_HEARTBEATS, 25)),
            on_driver_lost=_die_with_driver, monitor=monitor,
            # a driver's profile command -> the $TONY_STEP_LOG.profile flag
            # the training child's StepTimer polls
            on_command=lambda cmd: write_profile_flag(
                self._step_log_path(), cmd),
            # a driver's preempt command -> the .preempt flag and the
            # grace watchdog (the driver already knows: no notice back)
            on_preempt=lambda cmd: self._on_preempt_notice(
                ctx_holder, cmd if isinstance(cmd, dict) else {}),
            outage_grace_s=self.conf.get_int(
                keys.TASK_DRIVER_OUTAGE_GRACE_MS, 30000) / 1000)
        heartbeater.start()

        # the preemption relay: a SIGTERM to this process while a child
        # runs (a cloud preemption, the driver's resize drain) becomes a
        # drain, so the checkpoint is at most a step boundary old.
        # Serving keeps main()'s prompt exit: its child drains itself on
        # the group's SIGTERM
        if self.framework != "serving":
            grace_ms = self.conf.get_int(keys.TASK_PREEMPT_GRACE_MS, 3000)

            def _on_term(signum, frame):
                proc = getattr(ctx_holder.get("ctx"), "child_process", None)
                if proc is None or proc.poll() is not None:
                    sys.exit(c.EXIT_KILLED)     # nothing to drain
                log.warning("SIGTERM: draining the training child "
                            "(preemption relay, %.1fs grace)",
                            grace_ms / 1000)
                self._on_preempt_notice(ctx_holder, {"grace_ms": grace_ms},
                                        notify_driver=True)
                # no exit: run() returns the child's code once it drained

            try:
                signal.signal(signal.SIGTERM, _on_term)
            except ValueError:
                # not the main thread (embedded use): the heartbeat's
                # command path still drains
                log.warning("cannot install the SIGTERM drain relay off "
                            "the main thread")

        self._clear_stale_preempt_flag()
        self._prestage(monitor)
        payload = self.register_and_get_cluster_spec()
        monitor.start()

        work_dir = self._prepare_work_dir()
        monitor.add_span("work_dir_ready")

        from .runtimes.base import TaskContext

        ctx = TaskContext(
            job_name=self.job_name,
            task_index=self.task_index,
            task_num=self.task_num,
            num_total_tasks=self.num_total_tasks,
            is_chief=self.is_chief,
            command=self.command,
            cluster_payload=payload,
            base_child_env=self._base_child_env(),
            rpc_client=self.rpc,
            conf=self.conf,
            tb_port=self.tb_port,
        )
        ctx.work_dir = work_dir
        ctx_holder["ctx"] = ctx
        monitor.set_context(ctx)
        monitor.set_step_log(self._step_log_path())

        if self.tb_port is not None:
            try:
                self.rpc.call("register_tensorboard_url",
                              url=f"http://{self.host}:{self.tb_port}")
            except Exception as e:
                log.warning("could not register tensorboard url: %s", e)

        # release ephemeral reservations just before the user process
        # starts, so it can bind them (reference TaskExecutor.java:201-233)
        self._port_res.release_before_exec()
        if self._tb_res is not None:
            self._tb_res.release_before_exec()

        timeout_ms = self.conf.get_int(
            keys.TASK_EXECUTOR_EXECUTION_TIMEOUT_MS, 0)
        if timeout_ms > 0:
            killer = threading.Timer(timeout_ms / 1000, self._kill_child,
                                     [ctx])
            killer.daemon = True
            killer.start()

        try:
            exit_code = self.adapter.run(ctx)
        except Exception:
            log.exception("runtime adapter failed")
            exit_code = 1
        finally:
            heartbeater.stop_event.set()
            monitor.add_span("child_exited")
            monitor.stop()      # final flush ships the closing span
            self._port_res.release()
            if self._tb_res is not None:
                self._tb_res.release()

        try:
            self.rpc.call("register_execution_result", task_id=self.task_id,
                          exit_code=exit_code)
        except Exception as e:
            log.warning("could not report result: %s", e)
        return exit_code

    def _kill_child(self, ctx) -> None:
        name = getattr(ctx, "container_name", None)
        if name:
            # the docker CLI process does not forward SIGKILL to the
            # container; remove the container first, then reap the CLI
            from .utils.containers import remove_container

            log.error("execution timeout: removing container %s", name)
            remove_container(name)
        proc = getattr(ctx, "child_process", None)
        if proc is not None and proc.poll() is None:
            log.error("execution timeout: killing user process")
            proc.kill()

    def _prepare_work_dir(self) -> str | None:
        """Materialize this role's resources (path[#alias][::archive]) and
        the staged src dir into a per-task working directory — reference
        Utils.extractResources (util/Utils.java:758-771)."""
        if not self.job_dir:
            return None
        work = os.path.join(self.job_dir, "workdir",
                            f"{self.job_name}_{self.task_index}")
        os.makedirs(work, exist_ok=True)
        from .utils import localization as loc

        raw = str(self.conf.get(keys.role_key(self.job_name, "resources"),
                                "") or "")
        try:
            specs = loc.parse_resources(raw.split(",")) if raw else []
            specs = [self._remap_staged(s) for s in specs]
            loc.localize_resources(specs, work)
        except (OSError, ValueError) as e:
            log.error("resource localization failed: %s", e)
        src = str(self.conf.get(keys.SRC_DIR, "") or "")
        if src and not os.path.isdir(src):
            # conf holds the client-side staged path; after archive
            # localization the copy lives under THIS job dir
            candidate = os.path.join(self.job_dir, "src")
            src = candidate if os.path.isdir(candidate) else ""
        if src and os.path.isdir(src):
            dest = os.path.join(work, "src")
            if not os.path.isdir(dest):
                import shutil

                shutil.copytree(src, dest)
        return work

    def _remap_staged(self, spec):
        """Rewrite a client-side staged resource path (<client job
        dir>/resources/<name>) to this executor's job dir when the original
        path isn't visible on this host."""
        if os.path.exists(spec.path):
            return spec
        from dataclasses import replace

        candidate = os.path.join(self.job_dir, "resources",
                                 os.path.basename(spec.path))
        return (replace(spec, path=candidate) if os.path.exists(candidate)
                else spec)

    def _step_log_path(self) -> str | None:
        """Where the training child's StepTimer writes its JSONL (the
        TONY_STEP_LOG contract); the TaskMonitor samples the newest
        record."""
        if not self.job_dir:
            return None
        return os.path.join(self.job_dir, "logs",
                            f"{self.job_name}_{self.task_index}.steps.jsonl")

    def _base_child_env(self) -> dict[str, str]:
        env = {
            c.ENV_JOB_NAME: self.job_name,
            c.ENV_TASK_PORT: str(self.port),
            c.ENV_TASK_INDEX: str(self.task_index),
            c.ENV_TASK_NUM: str(self.task_num),
            c.ENV_IS_CHIEF: str(self.is_chief).lower(),
            c.ENV_APP_ID: self.app_id,
            c.ENV_JOB_DIR: self.job_dir,
        }
        step_log = self._step_log_path()
        if step_log:
            env[c.ENV_STEP_LOG] = step_log
        return env


def main() -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s executor %(name)s: %(message)s")
    # die with the driver: the local provisioner signals our process group
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(c.EXIT_KILLED))
    executor = Executor()
    code = executor.run()
    log.info("executor %s exiting with %d", executor.task_id, code)
    return code


if __name__ == "__main__":
    sys.exit(main())
