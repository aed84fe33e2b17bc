"""Per-request token emission channel and SSE framing (the port's own copy
of the JAX package's api/stream.py).

``TokenStream`` is the delivery half of streaming serving: the engine
(``SlotServer``) feeds it the host-known tokens at every PROCESSED decode
block, the same instant the request journal advances, so what a client has
been streamed is exactly what a replay resumes from; one HTTP handler
thread drains it into SSE frames.

- **The serving loop never blocks on a slow client.** ``feed()`` runs
  under the serving lock; it appends and returns. The queue is bounded in
  CHUNK count, not tokens: when a consumer cannot drain, the new tokens
  coalesce into the newest chunk (no token is dropped) and the stall is
  counted. Memory stays bounded by the request's ``max_new_tokens``.
- **Feeds are absolute, so replay dedupes itself.** The engine feeds the
  request's whole emitted list (resume prefix included); the stream
  appends only ``emitted[n_fed:]``. A replay that re-emits the prefix
  delivers each token once.
- **Every stream terminates.** Each engine terminal (a Completion, a
  reset loss, the app's failure path) finishes or fails the stream, so a
  consumer iterating ``events()`` always ends on a ``done`` or ``error``
  event.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from urllib.parse import parse_qs, urlparse

__all__ = ["TokenStream", "sse_frame", "parse_last_event_id",
           "read_json_body", "begin_sse", "stream_requested",
           "SSE_HEADERS", "SSE_DONE"]


# the Content-Type and anti-buffering headers of every streaming response
SSE_HEADERS = (
    ("Content-Type", "text/event-stream"),
    ("Cache-Control", "no-cache"),
    ("X-Accel-Buffering", "no"),
)

# the OpenAI stream terminator (literal, not JSON)
SSE_DONE = b"data: [DONE]\n\n"


def sse_frame(obj, event_id: str | None = None) -> bytes:
    """One ``data:`` SSE frame; ``obj`` is JSON-serialized unless it is a
    string already. ``event_id`` prepends an ``id:`` line, the cursor a
    client echoes back as ``Last-Event-ID`` to resume the stream."""
    data = obj if isinstance(obj, str) else json.dumps(obj)
    head = (b"id: " + str(event_id).encode() + b"\n"
            if event_id is not None else b"")
    return head + b"data: " + data.encode() + b"\n\n"


def parse_last_event_id(value) -> tuple[int, int] | None:
    """A client's ``Last-Event-ID`` header, ``"<rid>:<n>"`` (request id and
    absolute delivered-token count), as ``(rid, n)``; None when absent or
    malformed: a bad header degrades to a fresh request, never a 4xx."""
    if not value:
        return None
    try:
        rid, n = str(value).split(":", 1)
        return int(rid), max(0, int(n))
    except ValueError:
        return None


def read_json_body(handler) -> dict:
    """One HTTP request's JSON object body; a non-object body is a
    ValueError the caller answers with 400."""
    n = int(handler.headers.get("Content-Length", "0"))
    payload = json.loads(handler.rfile.read(n) or b"{}")
    if not isinstance(payload, dict):
        raise ValueError("request body must be a JSON object")
    return payload


def begin_sse(handler) -> None:
    """Send the SSE response head on a BaseHTTPRequestHandler."""
    handler.send_response(200)
    for k, v in SSE_HEADERS:
        handler.send_header(k, v)
    handler.send_header("Connection", "close")
    handler.end_headers()


def stream_requested(payload: dict, path: str) -> bool:
    """The /generate stream opt-in: ``"stream": true`` in the payload
    (a JSON boolean, else ValueError) or ``?stream=true`` in the query."""
    want = payload.get("stream")
    if want is not None and not isinstance(want, bool):
        raise ValueError("stream must be a JSON boolean")
    return bool(want) or (
        parse_qs(urlparse(path).query).get("stream", ["false"])[0]
        .lower() in ("1", "true", "yes"))


class TokenStream:
    """Bounded per-request token channel between the serving loop and one
    consumer thread. The producer side (``feed``/``finish``/``fail``) is
    called under the serving lock; the consumer side (``take``/``events``)
    holds only the stream's own condition."""

    def __init__(self, max_chunks: int = 64):
        self._cond = threading.Condition()
        self._chunks: collections.deque[list[int]] = collections.deque()
        self.max_chunks = max(2, int(max_chunks))
        self.n_fed = 0          # tokens accepted from the engine (absolute)
        self.stalls = 0         # feeds that found the chunk queue full
        self.finish_reason: str | None = None
        self.error: str | None = None
        # the engine's instant of the last feed that carried tokens (the
        # inter-token clock of the serving telemetry)
        self.last_feed_t: float | None = None

    # -------------------------------------------------------- producer side

    def feed(self, emitted) -> tuple[int, bool]:
        """Append the new suffix of ``emitted`` (the request's absolute
        emitted-token list) -> ``(n_new, stalled)``; ``stalled`` when the
        consumer was ``max_chunks`` behind and the tokens joined the newest
        chunk instead of a fresh one."""
        new = [int(t) for t in emitted[self.n_fed:]]
        if not new:
            return 0, False
        with self._cond:
            self.n_fed += len(new)
            stalled = len(self._chunks) >= self.max_chunks
            if stalled and self._chunks:
                self.stalls += 1
                self._chunks[-1].extend(new)
            else:
                self._chunks.append(new)
            self._cond.notify_all()
        return len(new), stalled

    def finish(self, reason: str) -> None:
        """Seal the stream at its terminal (the first terminal wins: a
        finish after a fail stays failed)."""
        with self._cond:
            if self.finish_reason is None:
                self.finish_reason = str(reason)
            self._cond.notify_all()

    def fail(self, message: str) -> None:
        """Terminal error: the request ended without a Completion (the
        restart budget spent, a drain timeout, a loss to a reset with
        replay off). The consumer gets one ``error`` event."""
        with self._cond:
            if self.finish_reason is None:
                self.finish_reason = "failed"
                self.error = str(message)
            self._cond.notify_all()

    # -------------------------------------------------------- consumer side

    def take(self, timeout: float = 0.25):
        """One consumer beat: ``("tokens", [ints])`` when a chunk is ready,
        ``("done", finish_reason)`` or ``("error", message)`` at the
        terminal (once every chunk is drained), ``("wait", None)`` when
        ``timeout`` passed with nothing new: the caller's chance to check
        its deadline and its client."""
        with self._cond:
            if not self._chunks and self.finish_reason is None:
                self._cond.wait(timeout)
            if self._chunks:
                return "tokens", self._chunks.popleft()
            if self.finish_reason is not None:
                if self.error is not None:
                    return "error", self.error
                return "done", self.finish_reason
            return "wait", None

    def events(self, poll_s: float = 0.25):
        """``take()`` until the terminal event, which is yielded last;
        ``wait`` beats are yielded too."""
        while True:
            kind, payload = self.take(timeout=poll_s)
            yield kind, payload
            if kind in ("done", "error"):
                return

    def drain_all(self, timeout: float = 60.0):
        """Block until the terminal -> ``(tokens, finish_reason or None,
        error or None)``; TimeoutError past ``timeout``."""
        out: list[int] = []
        deadline = time.monotonic() + timeout
        for kind, payload in self.events(poll_s=0.05):
            if kind == "tokens":
                out.extend(payload)
            elif kind == "done":
                return out, payload, None
            elif kind == "error":
                return out, None, payload
            elif time.monotonic() > deadline:
                raise TimeoutError("stream never terminated")
