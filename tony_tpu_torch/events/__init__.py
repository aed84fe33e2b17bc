"""Serving events: the durable request journal and the request traces."""

from .journal import JOURNAL_FILE, JournalEntry, RequestJournal, read_journal
from .trace import TRACE_FILE, TraceWriter, read_traces

__all__ = ["JOURNAL_FILE", "JournalEntry", "RequestJournal", "read_journal",
           "TRACE_FILE", "TraceWriter", "read_traces"]
