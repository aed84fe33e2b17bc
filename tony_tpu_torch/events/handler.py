"""EventHandler: queue-draining writer thread with inprogress->final rename.

Mirrors events/EventHandler.java:38-156: events are emitted from driver
threads into a queue; one writer thread appends them to
``<app_id>-...jhist.inprogress``; on stop the file is flushed and renamed to
its final name embedding end-time and status.
"""

from __future__ import annotations

import logging
import queue
import threading
from pathlib import Path

from ..api import now_ms
from .history import history_file_name
from .types import Event

log = logging.getLogger(__name__)

_SENTINEL = object()


class EventHandler:
    def __init__(self, intermediate_dir: str, app_id: str, user: str = ""):
        self._dir = Path(intermediate_dir) / app_id
        self._dir.mkdir(parents=True, exist_ok=True)
        self._app_id = app_id
        self._user = user
        self._start_ms = now_ms()
        self._path = self._dir / (
            history_file_name(app_id, self._start_ms, user=user) + ".inprogress"
        )
        self._queue: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._stopped = threading.Event()

    @property
    def job_dir(self) -> Path:
        return self._dir

    @property
    def path(self) -> Path:
        return self._path

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._drain, name="event-writer", daemon=True
        )
        self._thread.start()

    def emit(self, event: Event) -> None:
        if not self._stopped.is_set():
            self._queue.put(event)

    def _drain(self) -> None:
        with open(self._path, "a") as f:
            while True:
                item = self._queue.get()
                if item is _SENTINEL:
                    f.flush()
                    return
                try:
                    f.write(item.to_json() + "\n")
                    f.flush()
                except Exception:
                    log.exception("failed writing event")

    def stop(self, status: str) -> Path:
        """Flush and rename to final name with end-time + status
        (reference EventHandler.java:137-155)."""
        self._stopped.set()
        self._queue.put(_SENTINEL)
        if self._thread is not None:
            self._thread.join(timeout=10)
        final = self._dir / history_file_name(
            self._app_id, self._start_ms, end_ms=now_ms(),
            user=self._user, status=status,
        )
        try:
            self._path.rename(final)
        except FileNotFoundError:
            final.touch()
        return final


def read_events(path: str | Path) -> list[Event]:
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(Event.from_json(line))
    return events
