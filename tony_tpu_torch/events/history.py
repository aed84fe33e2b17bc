"""History file naming (the port's own copy of the JAX package's
events/history.py codec; its mover and purger serve the history portal,
which waits for ROADMAP.md queue 1's portal item).

Filename codec mirrors util/HistoryFileUtils.java:12-32:
``<app_id>-<start_ms>[-<end_ms>]-<user>[-<STATUS>].jhist``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

SUFFIX = ".jhist"

_NAME_RE = re.compile(
    r"^(?P<app>.+?)-(?P<start>\d+)(?:-(?P<end>\d+))?-(?P<user>[^-]*)"
    r"(?:-(?P<status>[A-Z]+))?\.jhist$"
)


def history_file_name(
    app_id: str,
    start_ms: int,
    end_ms: int | None = None,
    user: str = "",
    status: str = "",
) -> str:
    parts = [app_id, str(start_ms)]
    if end_ms is not None:
        parts.append(str(end_ms))
    parts.append(user or "anonymous")
    if status:
        parts.append(status.upper())
    return "-".join(parts) + SUFFIX


@dataclass
class HistoryFileMeta:
    app_id: str
    start_ms: int
    end_ms: int | None
    user: str
    status: str


def parse_history_file_name(name: str) -> HistoryFileMeta | None:
    m = _NAME_RE.match(name)
    if not m:
        return None
    return HistoryFileMeta(
        app_id=m.group("app"),
        start_ms=int(m.group("start")),
        end_ms=int(m.group("end")) if m.group("end") else None,
        user=m.group("user"),
        status=m.group("status") or "",
    )
