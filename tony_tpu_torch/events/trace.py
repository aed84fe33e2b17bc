"""Request-trace and task-trace JSONL (the port's own copy of the JAX
package's events/trace.py writer and reader).

A driver writes one line per sealed task trace (observability.py
``TaskTrace``) to ``tasks.trace.jsonl`` beside the job's history.

One line per terminated request: its ``RequestTrace.to_dict()``
(observability.py), ``{"id", "spans": [[name, t], ...], "attrs": {...}}``,
written by ``json.dumps`` exactly as the JAX package writes it, so either
framework's tools read the other's file. Span instants are host
``time.monotonic()`` values, meaningful relative to each other within one
server process and anchored to the wall clock by ``attrs.submitted_unix``;
a restarted server appends with a fresh monotonic epoch and request-id
counter, so order records across restarts by ``submitted_unix``.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path

log = logging.getLogger(__name__)

TRACE_FILE = "requests.trace.jsonl"
TASK_TRACE_FILE = "tasks.trace.jsonl"


class TraceWriter:
    """Append-only JSONL sink for trace records; thread-safe and best
    effort (a failed write is logged, never raised: telemetry must not take
    down the serving loop)."""

    def __init__(self, job_dir: str | Path, filename: str = TRACE_FILE):
        self._dir = Path(job_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self.path = self._dir / filename
        self._lock = threading.Lock()
        self._f = open(self.path, "a")

    def write(self, record: dict) -> None:
        try:
            line = json.dumps(record)
            with self._lock:
                self._f.write(line + "\n")
                self._f.flush()
        except Exception:
            log.exception("failed writing trace record")

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except Exception:
                log.exception("failed closing trace file")


def read_traces(path: str | Path) -> list[dict]:
    """Parse a trace JSONL file; malformed lines are skipped (a record torn
    by a crash must not hide every other request's trace)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                log.warning("skipping malformed trace line in %s", path)
    return out


__all__ = ["TASK_TRACE_FILE", "TRACE_FILE", "TraceWriter", "read_traces"]
