"""Shared GANG/FCFS gating + allocation-timeout health check (the port's
own copy of the JAX package's runtimes/generic.py).

Mirrors MLGenericRuntime.java: in GANG mode no task gets its cluster spec
until every instance of every role has registered (:80-98); the allocation
-timeout health check breaks gang deadlocks when capacity never arrives
(:110-147, reference issue #573).
"""

from __future__ import annotations

import time
from typing import Any

from ..api import DistributedMode
from ..conf import TonyConf, keys
from .base import DriverAdapter, TaskAdapter, TaskContext


class GenericDriverAdapter(DriverAdapter):
    def __init__(self) -> None:
        super().__init__()
        self._first_request_ms: float | None = None

    def note_requests_submitted(self) -> None:
        if self._first_request_ms is None:
            self._first_request_ms = time.time() * 1000

    def can_start_task(self, mode: DistributedMode, task_id: str) -> bool:
        assert self.session is not None
        if mode == DistributedMode.FCFS:
            return True
        return self.session.all_registered()

    def is_healthy(self, conf: TonyConf) -> bool:
        timeout_ms = conf.get_int(keys.AM_ALLOCATION_TIMEOUT_MS, 0)
        if timeout_ms <= 0 or self._first_request_ms is None or self.session is None:
            return True
        # Unhealthy iff some requested task never got capacity within the
        # timeout while the gang waits.
        from ..api import TaskStatus

        waiting = [
            t for t in self.session.all_tasks()
            if t.status in (TaskStatus.NEW, TaskStatus.REQUESTED)
        ]
        if not waiting:
            return True
        return (time.time() * 1000 - self._first_request_ms) < timeout_ms


class GenericTaskAdapter(TaskAdapter):
    """Exports the generic contract: CLUSTER_SPEC JSON + rank/world —
    enough for any framework that can read a phone book."""

    def build_env(self, ctx: TaskContext) -> dict[str, str]:
        import json

        from .. import constants as c

        env = {
            c.ENV_CLUSTER_SPEC: json.dumps(ctx.cluster_spec),
            c.ENV_GANG_GENERATION: str(
                ctx.cluster_payload.get("gang_generation", 0)),
        }
        if ctx.tb_port is not None:
            env[c.ENV_TB_PORT] = str(ctx.tb_port)
        return env


class StandaloneDriverAdapter(GenericDriverAdapter):
    """Single-task mode: no cluster spec, no gang (reference
    StandaloneRuntime.java:69-99 — rejects multi-instance configs)."""

    def validate_and_update_config(self, conf: TonyConf) -> None:
        specs = conf.role_specs()
        total = sum(s.instances for s in specs)
        if total != 1:
            raise ValueError(
                f"standalone runtime requires exactly 1 task, got {total}"
            )

    def can_start_task(self, mode: DistributedMode, task_id: str) -> bool:
        return True

    def cluster_spec_payload(self, task_id: str) -> dict[str, Any]:
        return {"cluster": {}}


class StandaloneTaskAdapter(TaskAdapter):
    def build_env(self, ctx: TaskContext) -> dict[str, str]:
        return {}
