"""Framework runtime SPI (the port's own copy of the JAX package's
runtimes/base.py).

Mirrors the reference's pluggable Framework interface (Framework.java:32-71),
split the same way into a driver-side adapter (cluster-spec construction, gang
gating, config validation, health, rendezvous callbacks) and an executor-side
adapter (env building, process exec). Discovery is by registry name keyed off
``tony.application.framework`` (reference uses java.util.ServiceLoader,
FrameworkRuntimeProvider.java:30-67).
"""

from __future__ import annotations

import logging
import os
import subprocess
import time
from typing import TYPE_CHECKING, Any

from ..api import DistributedMode

if TYPE_CHECKING:
    from ..conf import TonyConf
    from ..session import Session

log = logging.getLogger(__name__)


def spawn_child(ctx: "TaskContext", contract_env: dict[str, str]) -> Any:
    """Start the user process for ``ctx`` through a shell, cold. The JAX
    package's ``spawn_or_adopt`` adopts a warm-pool standby first; the
    port's warm pool waits for its ROADMAP.md item (the driver refuses
    ``tony.warmpool.size`` at prepare), so every child is a fresh spawn
    and marks ``child_spawned``."""
    proc = subprocess.Popen(
        ["bash", "-c", ctx.command],
        env={**os.environ, **contract_env}, cwd=ctx.work_dir or None,
    )
    ctx.child_process = proc
    ctx.note_span("child_spawned")
    return proc


class DriverAdapter:
    """Driver-side behavior — reference Framework.ApplicationMasterAdapter."""

    def __init__(self) -> None:
        self.session: "Session | None" = None

    def set_session(self, session: "Session") -> None:
        self.session = session

    def validate_and_update_config(self, conf: "TonyConf") -> None:
        """Hook to inject roles / reject illegal keys before the session is
        built (reference HorovodRuntime.validateAndUpdateConfig:210-232)."""

    def can_start_task(self, mode: DistributedMode, task_id: str) -> bool:
        """The gang barrier: may `task_id` receive its cluster spec yet?
        (reference MLGenericRuntime.java:80-98)."""
        raise NotImplementedError

    def cluster_spec_payload(self, task_id: str) -> dict[str, Any]:
        """What register_worker/get_cluster_spec returns once the barrier
        opens. Base payload is the role->addresses map plus any named
        service ports tasks have published (publish_ports RPC — the
        generalization of the reference's TF_CONFIG endpoint plumbing);
        runtimes add their rendezvous data (reference
        constructClusterSpec)."""
        assert self.session is not None
        payload: dict[str, Any] = {"cluster": self.session.cluster_spec()}
        # which elastic gang formation this spec describes — bumped by
        # every resize, so an executor/tooling can tell a re-formed
        # (smaller or restored) gang from the one it first joined
        payload["gang_generation"] = self.session.gang_generation
        ports = self.session.service_ports()
        if ports:
            payload["service_ports"] = ports
        return payload

    def is_healthy(self, conf: "TonyConf") -> bool:
        """Periodic health check from the driver monitor loop (reference
        allocation-timeout deadlock breaker, MLGenericRuntime.java:110-147)."""
        return True

    def receive_callback_info(self, task_id: str, payload: dict[str, Any]) -> None:
        """Runtime rendezvous callbacks (reference receiveTaskCallbackInfo)."""


class TaskAdapter:
    """Executor-side behavior — reference Framework.TaskExecutorAdapter."""

    def need_tb_port(self) -> bool:
        return False

    def build_env(self, ctx: "TaskContext") -> dict[str, str]:
        """Map the cluster-spec payload into the env contract the user's
        training process expects."""
        raise NotImplementedError

    def run(self, ctx: "TaskContext") -> int:
        """Default: fork the user command through a shell with the built env,
        stream output, return its exit code (reference
        Utils.executeShell:299-328 — minus the hadoop-classpath preamble).
        With `tony.docker.enabled` the command runs inside the configured
        image instead (reference Docker-on-YARN, HadoopCompatibleAdapter.
        java:45-159)."""
        from .. import constants as c
        from ..utils import containers

        contract_env = {**ctx.base_child_env, **self.build_env(ctx)}
        if containers.container_enabled(ctx.conf):
            # execution-env / role-env vars reach bare tasks via os.environ
            # inheritance; containers need them forwarded explicitly
            contract_env = {
                **containers.passthrough_env(ctx.conf, ctx.job_name),
                **contract_env,
            }
            name = containers.container_name(
                ctx.base_child_env.get(c.ENV_APP_ID, "app"),
                ctx.job_name, ctx.task_index,
            )
            argv = containers.build_container_command(
                ctx.command, contract_env, ctx.conf,
                work_dir=ctx.work_dir, role=ctx.job_name,
                job_dir=ctx.base_child_env.get(c.ENV_JOB_DIR) or None,
                name=name,
            )
            ctx.container_name = name
            proc = subprocess.Popen(
                argv, env=dict(os.environ), cwd=ctx.work_dir or None)
            ctx.child_process = proc
            ctx.note_span("child_spawned")
        else:
            proc = spawn_child(ctx, contract_env)
        try:
            return proc.wait()
        finally:
            if ctx.container_name:
                # normal exit: --rm already removed it (no-op); kill paths
                # (timeout, SIGTERM teardown): the docker CLI cannot forward
                # SIGKILL, so reap the container itself
                containers.remove_container(ctx.container_name)


class TaskContext:
    """Everything an executor-side adapter may need; filled by the
    executor before run()."""

    def __init__(
        self,
        job_name: str,
        task_index: int,
        task_num: int,
        num_total_tasks: int,
        is_chief: bool,
        command: str,
        cluster_payload: dict[str, Any],
        base_child_env: dict[str, str],
        rpc_client: Any = None,
        conf: "TonyConf | None" = None,
        tb_port: int | None = None,
    ):
        self.job_name = job_name
        self.task_index = task_index
        self.task_num = task_num
        self.num_total_tasks = num_total_tasks
        self.is_chief = is_chief
        self.command = command
        self.cluster_payload = cluster_payload
        self.base_child_env = base_child_env
        self.rpc_client = rpc_client
        self.conf = conf
        self.tb_port = tb_port
        self.work_dir: str | None = None
        self.child_process: subprocess.Popen | None = None
        self.container_name: str | None = None
        # executor-side lifecycle spans ([name, unix_ts] or
        # [name, unix_ts, attrs]) — adapters mark child_spawned here; the TaskMonitor ships them to the driver,
        # which merges them into the task's TaskTrace (span attrs land
        # on the trace's attrs dict)
        self.spans: list[list] = []

    def note_span(self, name: str, attrs: dict | None = None) -> None:
        span: list = [name, time.time()]
        if attrs:
            span.append(dict(attrs))
        self.spans.append(span)

    @property
    def cluster_spec(self) -> dict[str, list[str]]:
        return self.cluster_payload.get("cluster", {})

    def global_rank(self) -> int:
        """Deterministic global rank: roles in sorted order, then index —
        every process computes the same numbering from the same spec."""
        rank = 0
        for role in sorted(self.cluster_spec):
            n = len(self.cluster_spec[role])
            if role == self.job_name:
                return rank + self.task_index
            rank += n
        return rank + self.task_index

    def world_size(self) -> int:
        return sum(len(v) for v in self.cluster_spec.values()) or self.num_total_tasks


class Runtime:
    """A named pair of adapters."""

    name: str = ""

    def driver_adapter(self) -> DriverAdapter:
        raise NotImplementedError

    def task_adapter(self) -> TaskAdapter:
        raise NotImplementedError
