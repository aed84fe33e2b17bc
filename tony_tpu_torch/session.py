"""In-driver job state: the task table, cluster spec, completion policy and
the elastic formation (detached slots, gang generations): the port's own
copy of the JAX package's session.py. ``restore_formation`` waits for
ROADMAP.md queue 1's driver recovery item.

Mirrors the reference's TonySession (tony-core/.../TonySession.java): role ->
task array, cluster-spec aggregation from registered workers
(TonySession.getClusterSpec:235-255), chief semantics (isChief:381-384),
completion/failure policy (onTaskCompleted:260-284, updateSessionStatus:293-347),
registered-task set used by the gang barrier (addRegisteredTask:616-630).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Iterable

from .api import JobStatus, TaskInfo, TaskStatus
from .conf import RoleSpec, TonyConf, keys


@dataclass
class Task:
    """One task slot — reference inner class TonyTask (TonySession.java:434-601)."""

    name: str
    index: int
    status: TaskStatus = TaskStatus.NEW
    host: str = ""
    port: int = -1
    url: str = ""
    exit_code: int | None = None
    container_id: str = ""   # provisioner-assigned handle
    # named service ports this task published over the publish_ports RPC
    # (e.g. a serving replica's {"serve_port": N, "metrics_port": N}) —
    # the generalization of the reference's single TF_CONFIG rendezvous
    # port: any task can advertise any number of named endpoints, and
    # they ride the cluster-spec payload + TaskInfo to every consumer
    ports: dict[str, int] = field(default_factory=dict)
    # how this attempt's user process came up: "adopted" (warm-pool
    # standby; the port has no warm pool), "cold" (fresh spawn), "" before
    # the executor reports either — set by the driver from the
    # child_adopted/child_spawned trace spans, cleared per attempt
    launch_path: str = ""

    @property
    def task_id(self) -> str:
        return f"{self.name}:{self.index}"

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def to_info(self) -> TaskInfo:
        return TaskInfo(
            name=self.name, index=self.index, status=self.status.value,
            host=self.host, port=self.port, url=self.url, exit_code=self.exit_code,
            ports=dict(self.ports), launch_path=self.launch_path,
        )


class Session:
    """Job state for one driver attempt. A retry builds a fresh Session with
    session_id+1 (reference ApplicationMaster.reset:611-627 sessionId++)."""

    def __init__(self, conf: TonyConf, session_id: int = 0):
        self.conf = conf
        self.session_id = session_id
        self.status = JobStatus.NEW
        self.failure_message = ""
        self._lock = threading.RLock()

        self.role_specs: dict[str, RoleSpec] = {s.name: s for s in conf.role_specs()}
        self.tasks: dict[str, list[Task]] = {
            s.name: [Task(name=s.name, index=i) for i in range(s.instances)]
            for s in self.role_specs.values()
        }
        self._registered: set[str] = set()
        # elastic resize state: which gang formation is current (bumped
        # per resize; every active task must re-register into the new
        # generation before the barrier opens) and which task slots are
        # DETACHED: lost beyond their restart budget and awaiting
        # capacity. Detached tasks are invisible to the cluster spec, the
        # gang barrier and the completion policy.
        self.gang_generation = 0
        self.detached: set[str] = set()

        self.untracked: set[str] = conf.untracked_roles()
        self.stop_on_failure: set[str] = set(
            conf.get_list(keys.APPLICATION_STOP_ON_FAILURE_JOBTYPES)
        )
        self.fail_on_worker_failure: bool = conf.get_bool(
            keys.APPLICATION_FAIL_ON_WORKER_FAILURE, False
        )

    # ----------------------------------------------------------------- lookup
    def get_task(self, name: str, index: int) -> Task | None:
        tasks = self.tasks.get(name)
        if tasks is None or not (0 <= index < len(tasks)):
            return None
        return tasks[index]

    def get_task_by_id(self, task_id: str) -> Task | None:
        name, _, idx = task_id.partition(":")
        try:
            return self.get_task(name, int(idx))
        except ValueError:
            return None

    def all_tasks(self) -> list[Task]:
        return [t for ts in self.tasks.values() for t in ts]

    def tracked_tasks(self) -> list[Task]:
        """Tasks the completion policy watches. A detached (elastically
        removed) task is excluded: the job's outcome is decided by the
        formation that is actually training."""
        return [t for t in self.all_tasks()
                if t.name not in self.untracked
                and t.task_id not in self.detached]

    def active_tasks(self) -> list[Task]:
        """Non-detached tasks: the current gang formation's membership
        (terminal tasks included; callers filter by status)."""
        return [t for t in self.all_tasks()
                if t.task_id not in self.detached]

    def task_infos(self) -> list[TaskInfo]:
        return [t.to_info() for t in self.all_tasks()]

    # ----------------------------------------------------------- registration
    def register_task(self, task_id: str, host: str, port: int) -> Task | None:
        """Worker registration — reference addRegisteredTask + setTaskHostPort.
        Idempotent for re-registration after driver retry."""
        with self._lock:
            task = self.get_task_by_id(task_id)
            if task is None:
                return None
            if task_id in self.detached:
                # a detached slot's zombie executor must not register
                # itself back into the gang
                return None
            task.host, task.port = host, port
            if not task.status.is_terminal():
                task.status = TaskStatus.RUNNING
            self._registered.add(task_id)
            return task

    def registered_count(self) -> int:
        with self._lock:
            return len(self._registered)

    def note_allocated(self, task_id: str, container_id: str) -> None:
        """Record that capacity was granted — an UPGRADE-only transition
        (NEW/REQUESTED -> ALLOCATED) taken under the session lock: a
        fast executor can register (-> RUNNING) before the driver thread
        finishes its post-launch bookkeeping, and an unconditional
        assignment would stomp RUNNING back to ALLOCATED."""
        with self._lock:
            task = self.get_task_by_id(task_id)
            if task is None:
                return
            task.container_id = container_id
            if task.status in (TaskStatus.NEW, TaskStatus.REQUESTED):
                task.status = TaskStatus.ALLOCATED

    # ------------------------------------------------------- elastic resize
    def begin_generation(self) -> int:
        """Start a new gang formation: every active task must re-register
        before the barrier opens again (the driver drains and relaunches
        the survivors around this). -> the new generation."""
        with self._lock:
            self.gang_generation += 1
            self._registered.clear()
            return self.gang_generation

    def detach_task(self, task_id: str) -> bool:
        """Remove a lost task from the gang without failing the job: it
        leaves the cluster spec, the barrier predicate and the tracked
        set until capacity returns (reattach_task)."""
        with self._lock:
            if self.get_task_by_id(task_id) is None:
                return False
            self.detached.add(task_id)
            self._registered.discard(task_id)
            return True

    def reattach_task(self, task_id: str) -> bool:
        """Bring a detached slot back into the gang (capacity returned);
        the caller relaunches it and bumps the generation."""
        with self._lock:
            if task_id not in self.detached:
                return False
            self.detached.discard(task_id)
            return True

    # ---------------------------------------------------------- service ports
    def set_task_ports(self, task_id: str, ports: dict[str, int]) -> bool:
        """Merge named service ports a task published (publish_ports RPC).
        Values must be ints in the TCP port range — a task must not be able
        to poison the cluster spec with arbitrary payloads."""
        clean = {}
        for name, port in (ports or {}).items():
            if not isinstance(name, str) or not name:
                raise ValueError(f"bad service-port name: {name!r}")
            port = int(port)
            if not 0 < port < 65536:
                raise ValueError(f"bad service port {name}={port}")
            clean[name] = port
        with self._lock:
            task = self.get_task_by_id(task_id)
            if task is None:
                return False
            task.ports.update(clean)
            return True

    def service_ports(self) -> dict[str, dict[str, int]]:
        """task_id -> published named service ports, for every task that
        advertised any — the cluster-spec payload's ``service_ports``."""
        with self._lock:
            return {t.task_id: dict(t.ports)
                    for t in self.all_tasks() if t.ports}

    def all_registered(self, roles: Iterable[str] | None = None) -> bool:
        """The gang barrier predicate (reference MLGenericRuntime.java:80-98:
        every instance of every role must have registered)."""
        with self._lock:
            names = set(roles) if roles is not None else set(self.tasks)
            for name in names:
                for task in self.tasks.get(name, []):
                    if task.task_id in self.detached:
                        continue    # elastically removed: not gang-gated
                    if task.task_id not in self._registered:
                        return False
            return True

    def unregistered_tasks(self) -> list[str]:
        with self._lock:
            return [
                t.task_id for t in self.all_tasks() if t.task_id not in self._registered
            ]

    # -------------------------------------------------------------- cluster spec
    def cluster_spec(self) -> dict[str, list[str]]:
        """role -> ["host:port", ...] for every registered task, ordered by
        index — reference getClusterSpec (TonySession.java:235-255)."""
        with self._lock:
            spec: dict[str, list[str]] = {}
            for name, tasks in self.tasks.items():
                addrs = [t.address for t in tasks if t.task_id in self._registered]
                if addrs:
                    spec[name] = addrs
            return spec

    def registered_tasks(self, role: str) -> list[Task]:
        """The registered tasks of one role in index order — the
        identity-preserving companion of cluster_spec(): a resized gang's
        address list is compacted (detached slots removed), so position in
        it is not the task index, and rank assignment keys off real task
        ids (runtimes/torch_runtime.py)."""
        with self._lock:
            return [t for t in self.tasks.get(role, [])
                    if t.task_id in self._registered]

    # --------------------------------------------------------------- completion
    def is_chief(self, name: str, index: int) -> bool:
        """chief:0, or worker:0 when no chief role exists — reference
        TonySession.isChief (TonySession.java:381-384)."""
        if "chief" in self.tasks:
            return name == "chief" and index == 0
        return name == "worker" and index == 0

    def on_task_completed(self, name: str, index: int, exit_code: int) -> None:
        """Record task exit and apply the short-circuit failure policy —
        reference onTaskCompleted (TonySession.java:260-284)."""
        with self._lock:
            task = self.get_task(name, index)
            if task is None or task.status.is_terminal():
                return
            task.exit_code = exit_code
            task.status = TaskStatus.SUCCEEDED if exit_code == 0 else TaskStatus.FAILED
            if exit_code == 0:
                return
            if task.task_id in self.detached:
                # an elastically removed slot's late container exit is
                # already accounted for by the resize: no short-circuit
                return
            # Failure short-circuits:
            if name in self.untracked:
                self._fail(f"untracked task {task.task_id} failed (exit {exit_code})")
            elif self.is_chief(name, index):
                self._fail(f"chief task {task.task_id} failed (exit {exit_code})")
            elif name in self.stop_on_failure:
                self._fail(
                    f"task {task.task_id} of stop-on-failure role failed (exit {exit_code})"
                )
            elif self.fail_on_worker_failure:
                self._fail(f"task {task.task_id} failed and fail-on-worker-failure is set")

    def _fail(self, msg: str) -> None:
        if not self.status.is_terminal():
            self.status = JobStatus.FAILED
            self.failure_message = msg

    def update_status(self) -> JobStatus:
        """Roll up task states into a job status — reference updateSessionStatus
        (TonySession.java:293-347): job succeeds when all tracked tasks are done
        and at least the policy-critical ones succeeded; 'succeed if not all
        workers failed' semantics when fail_on_worker_failure is off."""
        with self._lock:
            if self.status.is_terminal():
                return self.status
            tracked = self.tracked_tasks()
            if not tracked:
                return self.status
            if not all(t.status.is_terminal() for t in tracked):
                self.status = JobStatus.RUNNING
                return self.status
            succeeded = [t for t in tracked if t.status == TaskStatus.SUCCEEDED]
            if len(succeeded) == len(tracked):
                self.status = JobStatus.SUCCEEDED
            elif not succeeded:
                self._fail("all tracked tasks failed")
            else:
                # partial failure tolerated unless policy already failed us
                # ("succeed if not all workers failed", TonySession.java:293-347)
                self.status = JobStatus.SUCCEEDED
            return self.status

    def kill_all(self, reason: str = "killed") -> None:
        with self._lock:
            for t in self.all_tasks():
                if not t.status.is_terminal():
                    t.status = TaskStatus.KILLED
            if not self.status.is_terminal():
                self.status = JobStatus.KILLED
                self.failure_message = reason
