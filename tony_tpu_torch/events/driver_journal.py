"""Durable control-plane journal: what a restarted driver must remember
to re-adopt a running job instead of killing it (the port's own copy of
the JAX package's events/driver_journal.py).

The reference survives ApplicationMaster death because YARN preserves the
running task containers across AM attempts
(``keep-containers-across-application-attempts``) and the new attempt
re-registers them. The driver owns that ledger itself: every piece of
authoritative control-plane state — the task registry and attempt
chains, launch handles (pids), registrations, the restart budget
already spent, published service ports, and the RPC auth root — is
appended here as it changes. The port's driver writes the journal as the
JAX driver does (the JAX package's ``load_state`` reads it); a
replacement driver that replays it (``Driver.recover``) waits for
ROADMAP.md queue 1's driver-recovery item, with the journal's reader.

File discipline mirrors ``events/journal.py`` (the serving request
journal): append-only JSONL flushed per record, torn/malformed trailing
lines skipped on read (a record torn by SIGKILL must not hide the
rest). Journal writes are best-effort on the control-plane hot path (a
failed write is logged and counted, never raised: durability must not
take down the driver).

The journal holds the job's RPC auth ROOT token (the recovered driver
must derive the same per-role keys or the surviving executors' signed
heartbeats would all fail verification). The job dir is already the
trust boundary holding ``driver.json`` and the frozen config; the
journal adds no new exposure beyond it.

Record vocabulary (one JSON object per line; the JAX driver's journal has
these and its elastic, autoscaler and SLO ops besides)::

    {"op": "meta", "app_id": ..., "token": ..., "session_id": 0,
     "rpc_port": 4xxxx, "driver_generation": 0}
    {"op": "launch", "task": "worker:0", "attempt": 1,
     "container_id": ..., "pid": 12345, "host": ..., "t": wall,
     "log_path": ...}
    {"op": "register", "task": "worker:0", "host": ..., "port": N}
    {"op": "restarts", "task": "worker:0", "used": 1}
    {"op": "ports", "task": "replica:0", "ports": {"serve_port": N}}
    {"op": "terminal", "task": "worker:0", "status": "SUCCEEDED",
     "exit_code": 0}

A ``launch`` op starts a fresh attempt; ``meta`` takes last-wins.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path

log = logging.getLogger(__name__)


class DriverJournal:
    """Append-only writer over the journal file. Thread-safe: records
    come from RPC threads, provisioner watcher threads, and the monitor
    loop. Every write is flushed — the journal's whole point is
    surviving an unclean death."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._lock = threading.Lock()
        self.write_errors = 0
        self._f = None
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a")
        except OSError:
            self.write_errors += 1
            log.exception("could not open driver journal %s", self.path)

    def record(self, op: str, **fields) -> None:
        """Best-effort append of one op (never raises)."""
        if self._f is None:
            return
        try:
            line = json.dumps({"op": op, **fields})
        except (TypeError, ValueError):
            self.write_errors += 1
            log.exception("unserializable journal record %s", op)
            return
        with self._lock:
            try:
                self._f.write(line + "\n")
                self._f.flush()
            except Exception:
                self.write_errors += 1
                log.exception("driver journal write failed")

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None
