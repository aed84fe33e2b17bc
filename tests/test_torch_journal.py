"""The port's request journal (tony_tpu_torch.events.journal) against the
JAX package's (tony_tpu.events.journal), mirroring tests/test_events.py's
journal tests, plus files written by one framework read by the other: the
on-disk JSONL schema is shared, field for field, so a journal written by
either recovers in the other."""

import dataclasses

import pytest

from tony_tpu.events import journal as jJ
from tony_tpu_torch.events import journal as J


def test_request_journal_roundtrip_and_torn_line(tmp_path):
    """submit/emit/end round-trip through the file, a crash-torn tail line
    is skipped, an emit for an unknown id is skipped, and a finished
    request's entry never comes back."""
    path = tmp_path / J.JOURNAL_FILE
    j = J.RequestJournal(path)
    j.submit(1, [5, 6, 7], 8, temperature=0.5, top_k=3, seed=42)
    j.submit(2, [9], 4)
    j.emit(1, [10, 11])
    j.emit(1, [12])
    j.emit(999, [1])            # unknown id: ignored in memory too
    j.finish(2)                 # delivered: sealed
    j.finish(2)                 # idempotent
    assert len(j) == 1
    entry = j.get(1)
    assert entry.emitted == [10, 11, 12] and entry.prompt == [5, 6, 7]
    assert j.get(2) is None
    j.close()
    with open(path, "a") as f:
        f.write('{"op": "emit", "id": 1, "tok')      # crash-torn tail
    entries = J.read_journal(path)
    assert [e.id for e in entries] == [1]
    e = entries[0]
    assert (e.prompt, e.emitted, e.max_new_tokens) == ([5, 6, 7],
                                                       [10, 11, 12], 8)
    assert (e.temperature, e.top_k, e.seed) == (0.5, 3, 42)
    # the JAX package's reader sees the same entries in the port's file
    assert [dataclasses.asdict(x) for x in jJ.read_journal(path)] == \
        [dataclasses.asdict(x) for x in entries]


def test_request_journal_steady_state_compaction(tmp_path):
    """Every compact_every sealed entries the file is rewritten down to
    the live set (tmp+rename), and the compacted file still round-trips,
    a live entry's emitted prefix included."""
    path = tmp_path / J.JOURNAL_FILE
    j = J.RequestJournal(path, compact_every=8)
    j.submit(1000, [1, 2, 3], 16)       # stays live across compactions
    j.emit(1000, [4, 5])
    for rid in range(20):               # 20 sealed -> 2 compactions
        j.submit(rid, [7] * 4, 4)
        j.emit(rid, [9, 9])
        j.finish(rid)
    assert j.compactions == 2 and j.write_errors == 0
    text = path.read_text()
    assert text.count('"op": "submit"') <= 1 + (20 % 8) * 1 + 1, (
        "dead records must not survive a compaction")
    # appends after the handle swap still land
    j.emit(1000, [6])
    j.close()
    live = {e.id: e for e in J.read_journal(path)}
    assert live[1000].emitted == [4, 5, 6]
    assert all(rid not in live for rid in range(20))


def test_request_journal_recover_never_loses_then_compacts(tmp_path):
    """recover() hands back the dead process's unfinished entries but
    keeps their records until the resubmission is journaled (a crash in
    the gap replays twice, never loses); compact() then rewrites the file
    down to the live set. An in-memory journal takes the same calls."""
    path = tmp_path / J.JOURNAL_FILE
    j = J.RequestJournal(path)
    j.submit(7, [1, 2], 6)
    j.emit(7, [3])
    j.close()                   # simulated process death
    j2, entries = J.RequestJournal.recover(path)
    assert [(e.id, e.emitted) for e in entries] == [(7, [3])]
    _, still_there = J.RequestJournal.recover(path)
    assert [(e.id, e.emitted) for e in still_there] == [(7, [3])]
    j2.submit(0, entries[0].prompt, entries[0].max_new_tokens,
              emitted=entries[0].emitted)
    assert j2.get(0).emitted == [3]
    j2.compact()
    j2.close()
    _, again = J.RequestJournal.recover(path)
    assert [(e.id, e.emitted) for e in again] == [(0, [3])]
    mem = J.RequestJournal()
    mem.submit(1, [4], 2)
    mem.emit(1, [5])
    assert mem.get(1).emitted == [5] and mem.path is None
    mem.finish(1)
    mem.compact()               # no file: a no-op, never an error
    assert len(mem) == 0


def _write(mod, path):
    """The same records through one framework's RequestJournal, every
    field of the schema set on one entry; two entries stay live."""
    j = mod.RequestJournal(path, compact_every=2)
    j.submit(3, [1, 2, 3], 10, temperature=0.7, top_k=5, cache_prompt=True,
             seed=11, model="default", stop=[[4, 5], [6]], logprobs=2,
             priority="batch", trace={"trace_id": "ab", "span_id": "cd"},
             deadline=123.0)
    j.submit(4, [9, 8], 6, emitted=[7])
    j.submit(5, [1], 3)
    j.emit(3, [8, 9])
    j.emit(5, [2])
    j.finish(5)
    j.submit(6, [2], 2)
    j.finish(6)                 # the second seal compacts
    j.emit(3, [10])
    j.close()
    return j.compactions


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_files_cross_frameworks(tmp_path, writer):
    """A file written by one framework's journal reads back in the other's
    read_journal into equal entries (deadline never reaches the file), and
    the line bytes the two write are the same."""
    w_mod, r_mod = (jJ, J) if writer == "jax" else (J, jJ)
    path = tmp_path / J.JOURNAL_FILE
    assert _write(w_mod, path) == 1
    got = r_mod.read_journal(path)
    mine = w_mod.read_journal(path)
    assert [dataclasses.asdict(e) for e in got] == \
        [dataclasses.asdict(e) for e in mine]
    assert [(e.id, e.emitted) for e in got] == [(3, [8, 9, 10]), (4, [7])]
    e = got[0]
    assert (e.temperature, e.top_k, e.cache_prompt, e.seed, e.model,
            e.stop, e.logprobs, e.priority, e.trace, e.deadline) == (
        0.7, 5, True, 11, "default", [[4, 5], [6]], 2, "batch",
        {"trace_id": "ab", "span_id": "cd"}, None)
    other = tmp_path / "other.jsonl"
    _write(r_mod, other)
    assert other.read_bytes() == path.read_bytes()
    # the reader's own recover() resumes the writer's file and compacts it
    j, entries = r_mod.RequestJournal.recover(path)
    for x in entries:
        j.submit(x.id + 100, x.prompt, x.max_new_tokens, emitted=x.emitted)
    j.compact()
    j.close()
    assert [(x.id, x.emitted) for x in w_mod.read_journal(path)] == \
        [(103, [8, 9, 10]), (104, [7])]
