"""Job event schema (the port's own copy of the JAX package's
events/types.py) — reference avro/Event.avsc + EventType.avsc + payload schemas
(ApplicationInited, ApplicationFinished, TaskStarted, TaskFinished with
per-task metrics array)."""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Any

from ..api import now_ms


class EventType(str, enum.Enum):
    APPLICATION_INITED = "APPLICATION_INITED"
    APPLICATION_FINISHED = "APPLICATION_FINISHED"
    TASK_STARTED = "TASK_STARTED"
    TASK_FINISHED = "TASK_FINISHED"
    # one serving request's lifecycle spans (observability.RequestTrace);
    # normally a sibling JSONL file (events/trace.py), but embeddable in
    # a jhist stream when a job wants request traces in its history
    REQUEST_TRACE = "REQUEST_TRACE"
    # one task's lifecycle spans (observability.TaskTrace): emitted by the
    # driver when the trace seals, so the jhist stream alone reconstructs
    # the gang-launch waterfall (the sibling tasks.trace.jsonl carries the
    # same records for the portal's high-rate read path)
    TASK_TRACE = "TASK_TRACE"


@dataclass
class Event:
    type: EventType
    payload: dict[str, Any] = field(default_factory=dict)
    timestamp: int = field(default_factory=now_ms)

    def to_json(self) -> str:
        return json.dumps(
            {"type": self.type.value, "payload": self.payload, "timestamp": self.timestamp}
        )

    @classmethod
    def from_json(cls, line: str) -> "Event":
        d = json.loads(line)
        return cls(
            type=EventType(d["type"]),
            payload=d.get("payload", {}),
            timestamp=d.get("timestamp", 0),
        )


def application_inited(app_id: str, num_tasks: int, host: str) -> Event:
    return Event(EventType.APPLICATION_INITED,
                 {"app_id": app_id, "num_tasks": num_tasks, "host": host})


def application_finished(app_id: str, status: str, failed_tasks: int,
                         message: str = "") -> Event:
    return Event(EventType.APPLICATION_FINISHED,
                 {"app_id": app_id, "status": status,
                  "num_failed_tasks": failed_tasks, "message": message})


def task_started(task_id: str, host: str, url: str = "") -> Event:
    """url: the task's log location (reference prints each container's log
    URL while monitoring, util/Utils.java:220-235)."""
    return Event(EventType.TASK_STARTED,
                 {"task_id": task_id, "host": host, "url": url})


def task_finished(task_id: str, status: str, exit_code: int,
                  metrics: list[dict[str, Any]] | None = None) -> Event:
    return Event(EventType.TASK_FINISHED,
                 {"task_id": task_id, "status": status, "exit_code": exit_code,
                  "metrics": metrics or []})


def request_trace(trace: dict[str, Any]) -> Event:
    """``trace`` is a RequestTrace.to_dict() record (id, spans, attrs)."""
    return Event(EventType.REQUEST_TRACE, {"trace": trace})


def task_trace(trace: dict[str, Any]) -> Event:
    """``trace`` is a TaskTrace.to_dict() record (id = 'role:index')."""
    return Event(EventType.TASK_TRACE, {"trace": trace})
