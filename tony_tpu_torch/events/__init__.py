"""Events: the serving request journal and traces, and the job history.

Serving: ``journal`` (the durable request journal) and ``trace`` (request
and task trace JSONL). Jobs (the port's own copy of the JAX package's
events/): ``types`` and ``handler`` (the jhist event stream a driver
writes, JSON lines renamed from ``.jhist.inprogress`` to ``.jhist`` with
its end time and status), ``history`` (the file-name codec) and
``driver_journal`` (the control-plane journal a driver appends as its
task table changes).
"""

from .handler import EventHandler
from .history import history_file_name, parse_history_file_name
from .journal import JOURNAL_FILE, JournalEntry, RequestJournal, read_journal
from .trace import TASK_TRACE_FILE, TRACE_FILE, TraceWriter, read_traces
from .types import Event, EventType

__all__ = ["JOURNAL_FILE", "JournalEntry", "RequestJournal", "read_journal",
           "TASK_TRACE_FILE", "TRACE_FILE", "TraceWriter", "read_traces",
           "Event", "EventType", "EventHandler", "history_file_name",
           "parse_history_file_name"]
