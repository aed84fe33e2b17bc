"""Serving events: the durable request journal."""

from .journal import JOURNAL_FILE, JournalEntry, RequestJournal, read_journal

__all__ = ["JOURNAL_FILE", "JournalEntry", "RequestJournal", "read_journal"]
