"""The externally visible surfaces (the port's own copy of the JAX
package's api/ modules).

This module holds the control plane's data model, as plain dataclasses
serializable to JSON for the wire and the event log: ``TaskStatus``,
``JobStatus``, ``DistributedMode``, ``TaskInfo`` and ``now_ms``, field for
field the JAX package's, so the two packages' clients, drivers and
history files read each other's payloads. The serving front door's
pieces are submodules: ``stream`` (the per-request token channel and SSE
framing) and ``openai`` (the /v1 payload mapping and the text codec).
"""

from __future__ import annotations

import enum
import time
from dataclasses import asdict, dataclass, field
from typing import Any


class TaskStatus(str, enum.Enum):
    """A task's lifecycle."""

    NEW = "NEW"
    REQUESTED = "REQUESTED"
    ALLOCATED = "ALLOCATED"
    RUNNING = "RUNNING"        # registered with the driver, user process live
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    KILLED = "KILLED"

    def is_terminal(self) -> bool:
        return self in (TaskStatus.SUCCEEDED, TaskStatus.FAILED,
                        TaskStatus.KILLED)


class JobStatus(str, enum.Enum):
    """The whole application's status."""

    NEW = "NEW"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    KILLED = "KILLED"

    def is_terminal(self) -> bool:
        return self in (JobStatus.SUCCEEDED, JobStatus.FAILED,
                        JobStatus.KILLED)


class DistributedMode(str, enum.Enum):
    """GANG: no task starts before all register. FCFS: start as they
    come."""

    GANG = "GANG"
    FCFS = "FCFS"


@dataclass
class TaskInfo:
    """Wire-visible task state."""

    name: str            # role, e.g. "worker"
    index: int
    status: str = TaskStatus.NEW.value
    host: str = ""
    port: int = -1
    url: str = ""        # log location
    exit_code: int | None = None
    # named service ports the task published (publish_ports RPC), e.g. a
    # serving replica's {"serve_port": N, "metrics_port": N}
    ports: dict[str, int] = field(default_factory=dict)
    # how the attempt's user process came up; the port spawns every child
    # cold ("cold"), "" before the executor reported
    launch_path: str = ""

    @property
    def task_id(self) -> str:
        return f"{self.name}:{self.index}"

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TaskInfo":
        return cls(**d)


def now_ms() -> int:
    return int(time.time() * 1000)


__all__ = ["DistributedMode", "JobStatus", "TaskInfo", "TaskStatus",
           "now_ms"]
