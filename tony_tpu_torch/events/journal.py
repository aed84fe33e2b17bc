"""Durable request journal: what a serving process must remember to
finish a request it did not start cleanly (the port's own copy of the JAX
package's events/journal.py, which the port does not import).

The state needed for an exact continuation of an in-flight request is
tiny and host-side: the prompt, the sampling parameters and the tokens
emitted so far. Teacher-forcing that prefix through the chunked-prefill
path rebuilds the interrupted request's cache, and greedy decoding
resumes with the same tokens (at float32; sampled continuations restart
the generator, so only their prefix is exact).

``RequestJournal`` is that record: one entry per live request, opened at
submit, appended per processed decode block, dropped at the terminal.
In-memory by default (enough for ``SlotServer.reset()`` replay: the host
survives a loop crash); ``path=`` makes it file-backed (``serve
--trace-dir`` does), so it also survives process death: ``recover()``
reads the previous process's unfinished entries and a restarted replica
finishes them.

The file is append-only JSONL, flushed per record; torn or malformed
lines are skipped on read (a record torn by SIGKILL must not hide every
other entry), and compaction rewrites through tmp+rename so a crash
mid-compaction leaves the previous journal intact. The record shapes are
the JAX package's, field for field, so a file written by either framework
recovers in the other::

    {"op": "submit", "id": 3, "prompt": [...], "max_new_tokens": 64,
     "temperature": null, "top_k": null, "cache_prompt": null,
     "seed": 0, "model": null, "stop": null, "logprobs": 0,
     "priority": "interactive", "trace": null}
    {"op": "emit", "id": 3, "tokens": [7, 9]}
    {"op": "end", "id": 3}

``trace`` is the request's ``TraceContext.as_dict()`` (observability.py).
Journal writes are best-effort on the serving hot path (a failed write is
logged, never raised: durability must not take down the loop), but every
failure is counted so silent non-durability is visible.
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import dataclass, field
from pathlib import Path

log = logging.getLogger(__name__)

# sibling of requests.trace.jsonl under serve --trace-dir
JOURNAL_FILE = "requests.journal.jsonl"


@dataclass
class JournalEntry:
    """One live request's replay state. ``emitted`` is the prefix of
    the output stream the host has PROCESSED (it may lag the device by
    the pipeline depth — replay from any true prefix is exact, the lag
    only costs re-decode latency). ``deadline`` is the in-process
    monotonic deadline; it never survives into a file record (another
    process's monotonic clock is meaningless)."""
    id: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float | None = None
    top_k: int | None = None
    cache_prompt: bool | None = None
    seed: int | None = None
    emitted: list[int] = field(default_factory=list)
    deadline: float | None = None
    # which model served this request, so recovery resubmits it to the
    # right engine (None = the process's default/only model)
    model: str | None = None
    # per-request stop sequences (list of token-id lists; None = only
    # the server-wide stop_tokens apply) — replayed so a resumed
    # continuation honors the same early-stop contract
    stop: list | None = None
    # requested top-k logprobs (0 = off): replayed so the continuation
    # still carries per-token logprobs (the teacher-forced prefix gets
    # None placeholders — those rows died with the old process)
    logprobs: int = 0
    # admission tier ("interactive" | "batch"): replayed so a resumed
    # request keeps its class budget/shedding behavior — every
    # pre-priority journal record reads back as interactive
    priority: str = "interactive"
    # distributed-trace identity, ``TraceContext.as_dict()``: a recovery
    # resubmits with the same span identity
    trace: dict | None = None


class RequestJournal:
    """Keyed store of live requests' replay state, optionally mirrored
    to an append-only JSONL file. Thread-safe (the serving loop writes
    under the serving lock, but recovery/stats readers may not hold
    it). The file self-compacts in steady state: once
    ``compact_every`` requests have been sealed since the last
    rewrite, the live entries are rewritten via tmp+rename — a
    long-lived replica's journal stays proportional to its IN-FLIGHT
    set, not its request history."""

    # sealed-entry count that triggers an in-place file compaction
    COMPACT_EVERY = 512

    def __init__(self, path: str | Path | None = None,
                 compact_every: int | None = None):
        self._lock = threading.Lock()
        self._entries: dict[int, JournalEntry] = {}
        self.path = Path(path) if path is not None else None
        self.write_errors = 0
        self.compactions = 0
        self._compact_every = (self.COMPACT_EVERY if compact_every is None
                               else max(1, int(compact_every)))
        self._dead_since_compact = 0
        self._f = None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a")

    # ------------------------------------------------------------- writes

    def _append(self, record: dict) -> None:
        if self._f is None:
            return
        try:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()
        except Exception:
            self.write_errors += 1
            log.exception("journal write failed")

    def submit(self, rid: int, prompt, max_new_tokens: int, *,
               temperature=None, top_k=None, cache_prompt=None,
               seed=None, deadline=None,
               emitted: list[int] | None = None,
               model: str | None = None,
               stop: list | None = None,
               logprobs: int = 0,
               priority: str = "interactive",
               trace: dict | None = None) -> None:
        """Open an entry for a newly accepted request. ``emitted``
        pre-seeds the record for resumed requests (a failover resume or
        journal recovery) so a second failure replays from the full
        known prefix, not just the tokens THIS process produced."""
        prompt = [int(t) for t in prompt]
        emitted = [int(t) for t in (emitted or [])]
        stop = ([[int(t) for t in seq] for seq in stop]
                if stop else None)
        entry = JournalEntry(
            id=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
            temperature=temperature, top_k=top_k, cache_prompt=cache_prompt,
            seed=seed, emitted=emitted, deadline=deadline, model=model,
            stop=stop, logprobs=int(logprobs or 0),
            priority=str(priority or "interactive"),
            trace=dict(trace) if trace else None)
        with self._lock:
            self._entries[rid] = entry
        self._append({"op": "submit", "id": rid, "prompt": prompt,
                      "max_new_tokens": int(max_new_tokens),
                      "temperature": temperature, "top_k": top_k,
                      "cache_prompt": cache_prompt, "seed": seed,
                      "model": model, "stop": stop,
                      "logprobs": int(logprobs or 0),
                      "priority": str(priority or "interactive"),
                      "trace": entry.trace})
        if emitted:
            self._append({"op": "emit", "id": rid, "tokens": emitted})

    def emit(self, rid: int, tokens) -> None:
        """Append newly processed output tokens to a live entry. This
        is the per-request durability point: the serving engine calls
        it with the host-processed tokens of each decode block, so what
        a replay or a failover resumes from is always a true prefix."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            return
        with self._lock:
            entry = self._entries.get(rid)
            if entry is None:       # already terminal (cancel races)
                return
            entry.emitted.extend(tokens)
        self._append({"op": "emit", "id": rid, "tokens": tokens})

    def finish(self, rid: int) -> None:
        """Seal an entry at its terminal (idempotent): the request needs
        no replay — it completed, was cancelled/expired, or was failed
        deliberately. Every ``compact_every`` seals, the file is
        rewritten down to its live entries (dead submit/emit/end
        records would otherwise grow it for the life of the process)."""
        with self._lock:
            entry = self._entries.pop(rid, None)
        if entry is None:
            return
        self._append({"op": "end", "id": rid})
        if self._f is None:
            return
        self._dead_since_compact += 1
        if self._dead_since_compact >= self._compact_every:
            self._compact()

    def _compact(self) -> None:
        """Rewrite the file to the LIVE entries via tmp+rename (a crash
        mid-compaction leaves the previous journal intact — same
        discipline as recover()). Best-effort like every other write."""
        try:
            with self._lock:
                live = sorted(self._entries.values(), key=lambda e: e.id)
                tmp = self.path.with_suffix(self.path.suffix + ".tmp")
                with open(tmp, "w") as f:
                    for e in live:
                        f.write(json.dumps(
                            {"op": "submit", "id": e.id,
                             "prompt": e.prompt,
                             "max_new_tokens": e.max_new_tokens,
                             "temperature": e.temperature,
                             "top_k": e.top_k,
                             "cache_prompt": e.cache_prompt,
                             "seed": e.seed,
                             "model": e.model,
                             "stop": e.stop,
                             "logprobs": e.logprobs,
                             "priority": e.priority,
                             "trace": e.trace}) + "\n")
                        if e.emitted:
                            f.write(json.dumps(
                                {"op": "emit", "id": e.id,
                                 "tokens": list(e.emitted)}) + "\n")
                tmp.rename(self.path)
                self._f.close()
                self._f = open(self.path, "a")
                self._dead_since_compact = 0
                self.compactions += 1
        except Exception:
            self.write_errors += 1
            log.exception("journal compaction failed")

    # -------------------------------------------------------------- reads

    def get(self, rid: int) -> JournalEntry | None:
        with self._lock:
            return self._entries.get(rid)

    def unfinished(self) -> list[JournalEntry]:
        with self._lock:
            return sorted(self._entries.values(), key=lambda e: e.id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except Exception:
                    log.exception("journal close failed")
                self._f = None

    # ----------------------------------------------------------- recovery

    def compact(self) -> None:
        """Rewrite the file down to the LIVE entries now (also runs
        automatically every ``compact_every`` seals). Recovery calls
        this AFTER resubmitting the dead process's entries — never
        before: truncating first would open a window where a second
        crash (mid-restart) silently loses every recovered request.
        The post-resubmission compaction instead leaves a window where
        a second crash can replay a request TWICE — wasted work, never
        lost requests."""
        if self._f is not None:
            self._compact()

    @classmethod
    def recover(cls, path: str | Path
                ) -> tuple["RequestJournal", list[JournalEntry]]:
        """Read a previous process's journal, return a journal APPENDING
        to the same file plus that process's unfinished entries (its
        in-flight and queued requests at death — resubmit them with
        ``SlotServer.recover_journal``, which then ``compact()``s the
        file down to the resubmitted live set). The dead records are
        deliberately NOT dropped here: until the resubmission's own
        submit records are durable, the old ones are the only copy —
        a crash in the gap must double-replay, not lose (see
        ``compact``)."""
        path = Path(path)
        entries = read_journal(path) if path.exists() else []
        return cls(path=path), entries


def read_journal(path: str | Path) -> list[JournalEntry]:
    """Parse a journal file into its unfinished entries. Malformed /
    torn lines (SIGKILL mid-write) and emits for unknown ids are
    skipped — one torn record must not hide the rest."""
    entries: dict[int, JournalEntry] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                op, rid = rec["op"], int(rec["id"])
                if op == "submit":
                    entries[rid] = JournalEntry(
                        id=rid,
                        prompt=[int(t) for t in rec["prompt"]],
                        max_new_tokens=int(rec["max_new_tokens"]),
                        temperature=rec.get("temperature"),
                        top_k=rec.get("top_k"),
                        cache_prompt=rec.get("cache_prompt"),
                        seed=rec.get("seed"),
                        model=rec.get("model"),
                        stop=rec.get("stop"),
                        logprobs=int(rec.get("logprobs", 0) or 0),
                        priority=str(rec.get("priority")
                                     or "interactive"),
                        trace=(rec.get("trace")
                               if isinstance(rec.get("trace"), dict)
                               else None))
                elif op == "emit":
                    entry = entries.get(rid)
                    if entry is not None:
                        entry.emitted.extend(int(t) for t in rec["tokens"])
                elif op == "end":
                    entries.pop(rid, None)
            except (ValueError, KeyError, TypeError):
                log.warning("skipping malformed journal line in %s", path)
    return sorted(entries.values(), key=lambda e: e.id)
