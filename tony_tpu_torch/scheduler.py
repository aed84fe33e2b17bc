"""Role-DAG scheduler: stage task requests respecting inter-role dependencies
(the port's own copy of the JAX package's scheduler.py).

Mirrors the reference's TaskScheduler (tony-core/.../TaskScheduler.java):
builds a dependency graph from <role>.depends-on plus prepare-stage /
training-stage conveniences, rejects cycles (isDAG:141-177), requests roots
immediately (scheduleTasks:54-72), and releases dependents when all instances
of a dependency complete (registerDependencyCompleted:117-139).
"""

from __future__ import annotations

import threading
from typing import Callable

from .conf import RoleSpec, TonyConf, keys


class DependencyCycleError(ValueError):
    pass


def build_dependency_graph(conf: TonyConf, specs: list[RoleSpec]) -> dict[str, set[str]]:
    """role -> set of roles it depends on. prepare-stage roles become implicit
    dependencies of training-stage roles (reference Utils.java:377-401)."""
    deps: dict[str, set[str]] = {s.name: set(s.depends_on) for s in specs}
    prepare = conf.get_list(keys.APPLICATION_PREPARE_STAGE)
    training = conf.get_list(keys.APPLICATION_TRAINING_STAGE)
    for t in training:
        if t in deps:
            deps[t].update(p for p in prepare if p in deps)
    known = set(deps)
    for role, ds in deps.items():
        unknown = ds - known
        if unknown:
            raise ValueError(f"role {role} depends on unknown role(s): {sorted(unknown)}")
    return deps


def check_dag(deps: dict[str, set[str]]) -> list[str]:
    """Topological order; raises DependencyCycleError on a cycle
    (reference isDAG, TaskScheduler.java:141-177)."""
    order: list[str] = []
    remaining = {r: set(ds) for r, ds in deps.items()}
    while remaining:
        ready = sorted(r for r, ds in remaining.items() if not ds)
        if not ready:
            raise DependencyCycleError(
                f"dependency cycle among roles: {sorted(remaining)}"
            )
        for r in ready:
            order.append(r)
            del remaining[r]
        for ds in remaining.values():
            ds.difference_update(ready)
    return order


class TaskScheduler:
    """Drives request_fn(spec) for each role when its dependencies are done."""

    def __init__(
        self,
        conf: TonyConf,
        specs: list[RoleSpec],
        request_fn: Callable[[RoleSpec], None],
    ):
        self._specs = {s.name: s for s in specs}
        self._deps = build_dependency_graph(conf, specs)
        check_dag(self._deps)  # fail fast on cycles
        self._request_fn = request_fn
        self._completed_instances: dict[str, int] = {s.name: 0 for s in specs}
        self._scheduled: set[str] = set()
        self._lock = threading.Lock()

    def schedule(self) -> None:
        """Request all roles with no pending dependencies (roots)."""
        with self._lock:
            ready = [
                r for r, ds in self._deps.items()
                if r not in self._scheduled and not ds
            ]
            for r in ready:
                self._scheduled.add(r)
        for r in sorted(ready, key=lambda n: self._specs[n].priority):
            self._request_fn(self._specs[r])

    def dependency_pending(self, role: str) -> bool:
        with self._lock:
            return role not in self._scheduled

    def on_task_completed(self, role: str, succeeded: bool) -> None:
        """One instance of `role` finished. When every instance of `role` has
        finished successfully, drop it from dependents' pending sets and
        schedule newly-unblocked roles (reference
        registerDependencyCompleted:117-139 — a failed dependency never
        releases dependents; the session failure policy handles the job)."""
        release = False
        with self._lock:
            if role not in self._specs:
                return
            if succeeded:
                self._completed_instances[role] += 1
                if self._completed_instances[role] >= self._specs[role].instances:
                    for ds in self._deps.values():
                        ds.discard(role)
                    release = True
        if release:
            self.schedule()

    def unscheduled_roles(self) -> list[str]:
        with self._lock:
            return sorted(set(self._specs) - self._scheduled)
