"""The rank-replicated serving loop: one ``SlotServer`` a rank, kept in step.

The JAX package serves a mesh from one SPMD process. The port runs one
process a card (parallel/spmd.py), so every rank runs its own engine on its
blocks and the ranks must make the same host decisions in the same order:
the same admissions, the same dispatches, the same reads. This module keeps
them so.

- **Rank 0 leads.** It owns HTTP, admission, the journal, traces and
  streams: ``Leader`` wraps its engine and records every host operation
  that changes what the engine dispatches (a submit, refused or not, with
  rank 0's clock: a full queue sweeps its expired requests before it
  sheds; a cancel, a reset and the queue it left, ``fail_queued``,
  ``pause_admission``). Once a turn it
  sends them in one message with its ``now`` (every time-based decision:
  queue deadlines) and whether the turn is a journal checkpoint. Every
  rank applies them in order through the same ``SlotServer`` methods, then
  runs the same turn (``run_turn``).
- **The message travels on a gloo side group made once**
  (``dist.new_group(backend="gloo")``), never on NCCL, so nothing in
  dispatch or admission waits for the card.
- **The host state stays alike on every rank.** Each message carries rank
  0's ``SlotServer.host_digest()`` (slot -> request id, the allocator's
  free blocks, the queue's length); a follower whose own differs raises
  ``LockstepMismatch``, naming the first difference, and tells rank 0,
  which goes down.
- **A failure on any rank is seen by every rank.** The exchange carries
  each rank's status, so it is a gather, not a broadcast. After a failed
  turn no rank steps; rank 0 resets its engine (the serving loop's
  recovery), and its journal's replays reach the followers as the reset's
  queue in the next message. The chaos hooks' mid-decode crash is raised
  at the end of the step (``SlotServer.defer_faults``), so a crashing rank
  never leaves the others waiting in a collective it skipped. A sticky
  CUDA fault still ends serving: there is no retry loop.
"""

from __future__ import annotations

import collections
import copy
import time

import torch.distributed as dist


class LockstepMismatch(RuntimeError):
    """A follower's host state is not rank 0's."""


class RankFailure(RuntimeError):
    """A turn failed on some rank (the serving loop resets every rank)."""


def run_turn(engines: dict, ckpt_due: bool) -> tuple:
    """One scheduling turn over the engines, the same on every rank ->
    (busy, the completions drained, the first step's exception and its
    engine). Each busy engine steps; completions drain when ready, or at a
    journal checkpoint after ``checkpoint_progress``. One engine's failure
    does not stop the engines after it."""
    busy, done = False, {}
    exc = failed = None
    for eng in engines.values():
        if eng.idle:
            continue
        busy = True
        try:
            eng.step()
            # in predictive mode drain_completed reads the device, so
            # drain only when something is known to be finished
            if eng.completions_ready:
                done.update(eng.drain_completed())
            elif ckpt_due:
                eng.checkpoint_progress()
                if eng.completions_ready:
                    done.update(eng.drain_completed())
        except Exception as e:
            if exc is None:
                exc, failed = e, eng
    return busy, done, exc, failed


def first_difference(want: dict, got: dict) -> str | None:
    """The first key whose values differ, with both values, or None."""
    for key in want:
        if want[key] != got.get(key):
            return f"{key!r}: rank 0 has {want[key]!r}, this rank {got.get(key)!r}"
    return None


class Lockstep:
    """The ranks' turn exchange over a gloo side group (module docstring).
    ``exchange_s`` keeps each exchange's host seconds."""

    def __init__(self):
        # made once, by every rank of the job
        self.group = dist.new_group(backend="gloo")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.ops: list = []
        self.turns = 0
        self.exchange_s: collections.deque = collections.deque(maxlen=4096)

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def record(self, op: str, *args) -> None:
        """Rank 0: a host operation for the next message."""
        self.ops.append((op, args))

    def exchange(self, msg: dict) -> list:
        """Every rank's message, in rank order (rank 0's carries the ops
        recorded since the last exchange)."""
        if self.leader:
            msg = dict(msg, ops=self.ops)
            self.ops = []
        t0 = time.perf_counter()
        out = [None] * self.world
        dist.all_gather_object(out, msg, group=self.group)
        self.exchange_s.append(time.perf_counter() - t0)
        self.turns += 1
        return out

    def lead(self, engine, now: float, ckpt_due: bool) -> None:
        """Rank 0's side of a turn: send the ops, ``now``, the checkpoint
        flag and the digest. Raises ``RankFailure`` when a rank's last turn
        failed, ``LockstepMismatch`` when a follower's state diverged."""
        msgs = self.exchange({"now": now, "ckpt_due": ckpt_due,
                              "digest": engine.host_digest()})
        fatal = [m["fatal"] for m in msgs[1:] if m.get("fatal")]
        if fatal:
            raise LockstepMismatch("; ".join(fatal))
        failed = [f"rank {r}: {m['status']}" for r, m in enumerate(msgs)
                  if m.get("status")]
        if failed:
            raise RankFailure("a serving turn failed on " + "; ".join(failed))
        engine.turn_now = now

    def close(self, reason: str = "") -> None:
        """Rank 0: the last message; the followers stop."""
        self.exchange({"stop": True, "reason": reason})

    def stats(self) -> dict:
        xs = sorted(self.exchange_s)
        return {"world": self.world, "turns": self.turns,
                "exchange_s_p50": xs[len(xs) // 2] if xs else None,
                "exchange_s_max": xs[-1] if xs else None}


def _apply(engine, op: str, args) -> None:
    """A follower applies one of rank 0's host operations."""
    if op == "submit":
        # rank 0's clock for the queue's deadlines (a full queue sweeps
        # before it sheds), and what its submit raised: a refusal can
        # still have changed the queue, so every rank runs it alike
        request, now, raised = args
        engine.turn_now = now
        try:
            engine.submit(request)
        except Exception as e:
            if type(e).__name__ != raised:
                raise
        else:
            if raised is not None:
                raise LockstepMismatch(
                    f"rank 0's submit of request {request.id} raised "
                    f"{raised}; this rank's did not")
    elif op == "cancel":
        engine.cancel(args[0])
    elif op == "reset":
        engine.reset()
        engine._queue = collections.deque(args[0])
        # the completions rank 0's reset delivered from its journal
        engine._done = {rid: None for rid in args[1]}
    elif op == "queue":
        engine._queue = collections.deque(args[0])
    elif op == "fail_queued":
        engine.fail_queued()
    elif op == "pause":
        engine.pause_admission = args[0]
    else:
        raise LockstepMismatch(f"unknown lockstep operation {op!r}")


def follow(engine, lockstep: Lockstep) -> str:
    """A follower's serving loop: rank 0's ops, then the same turn, until
    rank 0 stops -> the reason it gave. The engine's completions are
    dropped (rank 0 answers the requests)."""
    engine.defer_faults = True
    status = None
    while True:
        msgs = lockstep.exchange({"status": status})
        lead = msgs[0]
        if lead.get("stop"):
            return lead.get("reason", "")
        failed_here = status is not None
        status = None
        err = None
        try:
            for op, args in lead["ops"]:
                _apply(engine, op, args)
        except LockstepMismatch as e:
            err = e
        except Exception as e:
            status = f"{type(e).__name__}: {e}"
            continue
        if err is None and (failed_here or any(
                m.get("status") or m.get("fatal") for m in msgs)):
            continue        # rank 0 resets (or stops) every rank next
        diff = None if err else first_difference(lead["digest"],
                                                 engine.host_digest())
        if diff is not None:
            err = LockstepMismatch(
                f"rank {lockstep.rank}'s host state differs from rank 0's "
                f"at {diff}")
        if err is not None:
            lockstep.exchange({"fatal": str(err)})
            lockstep.exchange({})           # rank 0's last message
            raise err
        engine.turn_now = lead["now"]
        *_, exc, _ = run_turn({"engine": engine}, lead["ckpt_due"])
        if exc is not None:
            status = f"{type(exc).__name__}: {exc}"


class Leader:
    """Rank 0's engine as ``ServeApp`` sees it: the ``SlotServer``, with
    every call that changes what it dispatches recorded for the followers
    (module docstring). Everything else passes through."""

    _OWN = ("_engine", "_lockstep")

    def __init__(self, engine, lockstep: Lockstep):
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "_lockstep", lockstep)
        engine.defer_faults = True
        # what the engine holds before serving (a recovered journal's
        # resubmissions) reaches the followers with the first message
        if engine._queue:
            lockstep.record("queue", list(engine._queue))

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __setattr__(self, name, value):
        if name == "pause_admission":
            self._lockstep.record("pause", value)
        setattr(self._engine, name, value)

    def submit(self, request) -> int:
        """The submit, recorded whether or not it raises: a shed request
        (``QueueFullError``) first sweeps the expired requests out of the
        queue, and the followers must sweep them too."""
        snap = copy.copy(request)
        if self._engine.turn_now is None:       # before the first turn
            self._engine.turn_now = time.monotonic()
        now, raised = self._engine.turn_now, None
        try:
            return self._engine.submit(request)
        except Exception as e:
            raised = type(e).__name__
            raise
        finally:
            self._lockstep.record("submit", snap, now, raised)

    def cancel(self, request_id: int) -> bool:
        self._lockstep.record("cancel", request_id)
        return self._engine.cancel(request_id)

    def reset(self) -> list:
        lost = self._engine.reset()
        self._lockstep.record("reset", list(self._engine._queue),
                              list(self._engine._done))
        return lost

    def fail_queued(self) -> list:
        self._lockstep.record("fail_queued")
        return self._engine.fail_queued()


__all__ = ["Lockstep", "Leader", "LockstepMismatch", "RankFailure",
           "run_turn", "follow", "first_difference"]
