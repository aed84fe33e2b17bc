"""Serving runtime — SlotServer fleets as a first-class job type (the
port's own copy of the JAX package's ServingDriverAdapter and
ServingTaskAdapter; its RouterTaskAdapter waits for the router's ROADMAP.md
item).

The composition PAPER.md's L4/L2 pattern was built for: the driver
(ApplicationMaster role) gang-launches N replicas of the hardened
inference server (the port's ``cli/serve.py``) as ordinary tasks.
Each replica's executor runs this adapter, which

- exports ``TONY_SERVE_PORT`` (= the task's registered rendezvous port,
  the same port the notebook runtime hands its child) so the role
  command binds a port the driver already knows;
- spawns the serve child and watches its ``/healthz``;
- on the FIRST healthy poll marks a ``serving_ready`` span on the task
  trace and advertises ``serve_port``/``metrics_port`` through the
  ``publish_ports`` RPC — they land in the cluster spec, on
  get_task_infos (where the fleet router's discovery reads them), and
  as ``driver_task_service_port`` gauges on the driver /metrics;
- converts a terminally DOWN serving loop (``/healthz`` 503 for
  ``tony.serving.healthz-down-polls`` consecutive polls after ready)
  into a container failure: kill the child, exit nonzero, and the
  driver's per-task restart budget relaunches the replica — the replica
  chain shows up in tasks.trace.jsonl like any task.

Replicas are independent servers, so the gang barrier is a formality:
``can_start_task`` always passes and each replica starts serving the
moment it is up (a fleet warms replica-by-replica instead of holding
every ready server hostage to the slowest compile).

At teardown the provisioner's SIGTERM reaches the replica's process
group and the serve child drains in-flight requests (cli/serve.py's drain
handler). Rolling restarts (the JAX package's ``roll_task``) wait for the
router's ROADMAP.md item.
"""

from __future__ import annotations

import logging
import os
import subprocess
import time
import urllib.error
import urllib.request

from .. import constants as c
from ..conf import keys
from .base import TaskAdapter, TaskContext
from .generic import GenericDriverAdapter

log = logging.getLogger(__name__)


def _kill_tree(proc: subprocess.Popen) -> None:
    """SIGKILL ``proc`` and every /proc-visible descendant. The role
    command runs under ``bash -c``: a compound command forks instead of
    exec'ing, and killing only the bash would orphan the serve
    grandchild — still bound to the old port, still answering /healthz —
    while the driver relaunches the replica. A new session/process group
    is NOT an option here: the provisioner's group SIGTERM is how the
    serve child learns to drain and how job teardown reaps it."""
    victims = {proc.pid}
    try:
        children: dict[int, list[int]] = {}
        for entry in os.listdir("/proc"):
            if not entry.isdigit():
                continue
            try:
                with open(f"/proc/{entry}/stat") as f:
                    ppid = int(f.read().split()[3])
            except (OSError, IndexError, ValueError):
                continue
            children.setdefault(ppid, []).append(int(entry))
        stack = [proc.pid]
        while stack:
            pid = stack.pop()
            for child in children.get(pid, []):
                if child not in victims:
                    victims.add(child)
                    stack.append(child)
    except OSError:
        pass        # no /proc: the direct child is the best we can do
    for pid in victims:
        try:
            os.kill(pid, 9)
        except (ProcessLookupError, PermissionError):
            pass


class ServingDriverAdapter(GenericDriverAdapter):
    """Replicas are independent: no gang barrier — a registered replica
    gets its cluster spec (and starts serving) immediately."""

    def can_start_task(self, mode, task_id: str) -> bool:
        return True


class ServingTaskAdapter(TaskAdapter):
    """Executor-side supervisor of one SlotServer replica child."""

    def need_tb_port(self) -> bool:
        return False

    def build_env(self, ctx: TaskContext) -> dict[str, str]:
        import json

        env = {
            c.ENV_CLUSTER_SPEC: json.dumps(ctx.cluster_spec),
            c.ENV_SERVE_PORT: ctx.base_child_env.get(c.ENV_TASK_PORT, ""),
        }
        flags = " ".join(part for part in (
            self._conf_serve_flags(ctx.conf),
            self._role_flags(ctx.conf, ctx.task_index)) if part)
        if flags:
            env[c.ENV_SERVE_EXTRA_FLAGS] = flags
        return env

    @staticmethod
    def _role_flags(conf, task_index) -> str:
        """Phase-tier assignment for disaggregated serving (docs/
        serving.md "Disaggregated serving"): with ``tony.serving.
        prefill-instances`` = P and ``decode-instances`` = D, the
        first P task indices launch as prefill specialists and the
        next D as decode replicas — both tiers force ``--paged-kv``
        (the KV block is the transfer unit on either side of
        /kv/import) — and the remainder stay classic ``both``
        engines. P = D = 0 (default) templates nothing: a uniform
        fleet, today's behavior."""
        if conf is None or task_index is None:
            return ""
        n_prefill = max(0, conf.get_int(keys.SERVING_PREFILL_INSTANCES, 0))
        n_decode = max(0, conf.get_int(keys.SERVING_DECODE_INSTANCES, 0))
        if not n_prefill and not n_decode:
            return ""
        idx = int(task_index)
        if idx < n_prefill:
            return "--role prefill --paged-kv"
        if idx < n_prefill + n_decode:
            return "--role decode --paged-kv"
        return "--role both"

    @staticmethod
    def _conf_serve_flags(conf) -> str:
        """Template the paged-KV serve flags from ``tony.serving.*``
        conf keys (docs/serving.md "Paged KV & admission tiers") into
        one space-separated string the child exports as
        TONY_SERVE_EXTRA_FLAGS — cli/serve.py prepends it to argv, so
        a job file flips the whole fleet to paged admission without
        editing every replica command (explicit flags still win)."""
        if conf is None:
            return ""
        flags: list[str] = []
        if conf.get_bool(keys.SERVING_PAGED_KV, False):
            flags.append("--paged-kv")
        for key, flag in (
                (keys.SERVING_KV_BLOCK, "--kv-block"),
                (keys.SERVING_KV_POOL_BLOCKS, "--kv-pool-blocks"),
                (keys.SERVING_PREFILL_INTERLEAVE,
                 "--prefill-interleave"),
                (keys.SERVING_CLASS_BUDGET_INTERACTIVE,
                 "--class-budget-interactive"),
                (keys.SERVING_CLASS_BUDGET_BATCH,
                 "--class-budget-batch")):
            val = conf.get_int(key, 0)
            if val:
                flags.extend([flag, str(val)])
        frac = conf.get(keys.SERVING_BATCH_QUEUE_FRAC, "")
        if frac:
            flags.extend(["--batch-queue-frac", str(frac)])
        return " ".join(flags)

    # ------------------------------------------------------------ health
    def _poll_healthz(self, port: int, timeout: float = 2.0) -> str:
        """One /healthz probe: "ok" (HTTP 200), "down" (HTTP 503 — the
        loop is down or draining), or "unreachable" (nothing listening /
        timed out)."""
        url = f"http://127.0.0.1:{port}/healthz"
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                return "ok" if resp.status == 200 else "down"
        except urllib.error.HTTPError as e:
            return "down" if e.code == 503 else "unreachable"
        except Exception:
            return "unreachable"

    def _publish_ports(self, ctx: TaskContext, port: int) -> None:
        """Advertise the replica's endpoints. The serve process exposes
        /generate, /stats, and /metrics on ONE port, so serve_port and
        metrics_port coincide today; both names are published so the
        contract survives a future split."""
        if ctx.rpc_client is None:
            return
        task_id = f"{ctx.job_name}:{ctx.task_index}"
        try:
            ctx.rpc_client.call(
                "publish_ports", task_id=task_id,
                ports={"serve_port": port, "metrics_port": port})
        except Exception as e:
            # the replica still serves; only discovery via the driver is
            # degraded — callers with a static endpoint list are unaffected
            log.warning("could not publish service ports: %s", e)

    def run(self, ctx: TaskContext) -> int:
        conf = ctx.conf
        interval_s = (conf.get_int(keys.SERVING_HEALTHZ_INTERVAL_MS, 1000)
                      / 1000 if conf else 1.0)
        down_polls = max(1, conf.get_int(keys.SERVING_HEALTHZ_DOWN_POLLS, 3)
                         if conf else 3)
        ready_timeout_s = (conf.get_int(keys.SERVING_READY_TIMEOUT_MS,
                                        300000) / 1000 if conf else 300.0)
        contract_env = {**ctx.base_child_env, **self.build_env(ctx)}
        try:
            serve_port = int(contract_env.get(c.ENV_SERVE_PORT, "") or 0)
        except ValueError:
            serve_port = 0
        if serve_port <= 0:
            log.error("serving adapter needs %s (the executor's task "
                      "port) in the child env", c.ENV_SERVE_PORT)
            return 1
        from ..utils import containers

        if ctx.conf is not None and containers.container_enabled(ctx.conf):
            # loudly unsupported, not silently un-containerized: the
            # health-watch/port contract below assumes a host process
            log.error("tony.docker.enabled is not supported for the "
                      "serving job type yet; run replicas bare or use "
                      "the generic runtime")
            return 1
        # the provisioner's process-group SIGTERM is how a replica learns
        # to DRAIN (teardown — see _kill_tree's docstring), so the child
        # stays in the executor's process group
        proc = subprocess.Popen(
            ["bash", "-c", ctx.command],
            env={**os.environ, **contract_env}, cwd=ctx.work_dir or None)
        ctx.child_process = proc
        ctx.note_span("child_spawned")

        ready = False
        down_streak = 0
        t0 = time.monotonic()
        while True:
            try:
                return proc.wait(timeout=interval_s)
            except subprocess.TimeoutExpired:
                pass
            state = self._poll_healthz(serve_port)
            if state == "ok":
                if not ready:
                    ready = True
                    ctx.note_span("serving_ready")
                    self._publish_ports(ctx, serve_port)
                    log.info("replica healthy on port %d after %.1fs",
                             serve_port, time.monotonic() - t0)
                down_streak = 0
            elif ready:
                # post-ready 503 = the serving loop's restart budget is
                # exhausted (or the server is draining toward exit); a
                # few unreachable polls = the HTTP server died under a
                # live process. Either way the replica is out of
                # rotation for good — hand the restart decision to the
                # driver's budget instead of hosting a zombie.
                down_streak += 1
                if down_streak >= down_polls:
                    log.error(
                        "replica /healthz %s for %d consecutive polls; "
                        "killing child for a budgeted driver restart",
                        state, down_streak)
                    _kill_tree(proc)
                    proc.wait(timeout=10)
                    return 1
            elif time.monotonic() - t0 > ready_timeout_s:
                log.error("replica never became healthy within %.0fs",
                          ready_timeout_s)
                _kill_tree(proc)
                proc.wait(timeout=10)
                return 1
