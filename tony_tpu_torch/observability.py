"""Distributed-trace identity for the serving front door (the port's own
copy of the JAX package's ``TraceContext``, observability.py:198-287).

A sender stamps ``X-Tony-Trace: <trace_id>:<span_id>`` on an outbound hop;
the receiver adopts the trace_id, records the sender's span_id as its
parent and mints a fresh span_id for its own work. ``serve`` echoes
``X-Tony-Trace-Id: <trace_id>`` on its buffered responses and puts the
trace_id on a stream's closing frame, and journals ``as_dict()`` with the
request, so a replayed or recovered request stays in its trace.

Request traces, the serving telemetry and its exposition are not ported
yet (ROADMAP.md queue 1, the rest of serving: serving telemetry).
"""

from __future__ import annotations

import hashlib
import os
import re

__all__ = ["TRACE_HEADER", "TRACE_ID_RESPONSE_HEADER", "TraceContext"]

TRACE_HEADER = "X-Tony-Trace"
TRACE_ID_RESPONSE_HEADER = "X-Tony-Trace-Id"

_TRACE_TOKEN = re.compile(r"^[0-9a-f]{8,32}$")


class TraceContext:
    """One hop's identity inside a distributed trace: ``trace_id`` names
    the whole request across tiers, ``span_id`` this process's work on it,
    ``parent_span_id`` the span that caused it (None at the root). It
    travels between processes as the ``X-Tony-Trace`` header and inside
    durable records (the journal's entries) as ``as_dict()``."""

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_span_id: str | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id

    @staticmethod
    def _new_id() -> str:
        return os.urandom(8).hex()

    @classmethod
    def mint(cls) -> "TraceContext":
        """A fresh root context, for a request that came without a trace
        header."""
        return cls(cls._new_id(), cls._new_id(), None)

    @classmethod
    def for_request_id(cls, request_id: str) -> "TraceContext":
        """A root context whose trace_id derives from the client's
        idempotency key, so two front doors that never exchanged a byte
        put one client request into one trace."""
        digest = hashlib.sha256(
            b"tony-trace:" + request_id.encode("utf-8", "replace"))
        return cls(digest.hexdigest()[:16], cls._new_id(), None)

    @classmethod
    def from_header(cls, value: str | None) -> "TraceContext | None":
        """The RECEIVER's context from an inbound ``X-Tony-Trace`` header:
        the same trace, the sender's span as parent, a fresh span_id. None
        for an absent or malformed header (the caller mints a root): a
        garbled proxy header never fails the request."""
        if not value:
            return None
        trace_id, sep, span_id = value.strip().partition(":")
        if not sep or not _TRACE_TOKEN.match(trace_id) \
                or not _TRACE_TOKEN.match(span_id):
            return None
        return cls(trace_id, cls._new_id(), span_id)

    @classmethod
    def from_dict(cls, d: dict | None) -> "TraceContext | None":
        """A context persisted by ``as_dict()``, with the SAME span
        identity (a recovered request continues the dead attempt's span);
        None for anything else."""
        if not isinstance(d, dict):
            return None
        trace_id, span_id = d.get("trace_id"), d.get("span_id")
        if not isinstance(trace_id, str) or not isinstance(span_id, str):
            return None
        parent = d.get("parent_span_id")
        return cls(trace_id, span_id,
                   parent if isinstance(parent, str) else None)

    def child(self) -> "TraceContext":
        """The context a downstream hop runs under: the same trace, this
        span as parent, a fresh span_id."""
        return type(self)(self.trace_id, self._new_id(), self.span_id)

    def to_header(self) -> str:
        return f"{self.trace_id}:{self.span_id}"

    def as_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_span_id": self.parent_span_id}
