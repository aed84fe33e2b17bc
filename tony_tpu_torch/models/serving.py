"""Continuous batching: a slot-pool server over the static KV cache (port of
the JAX package's models/serving.py, the ring engine on one device).

``generate()`` serves one fixed batch to completion; a live service gets
requests at different times with different lengths. The ``SlotServer``
keeps S cache slots and admits each request into whichever slot frees up,
while the other slots keep decoding.

- **Fixed slot pool, ring-aligned.** The KV cache is allocated once as
  [layers, S, kvH, max_len, D]; ``cache.length`` is an [S] int32 tensor of
  logical lengths. Each slot's buffer is a ring: logical position p lives
  at index (p + offset_slot) mod max_len, the offset chosen at admission
  so that every active slot's next write lands at one shared cursor index
  (a host int). The decode write is then one slice assignment for all
  slots, and only the attention mask maps indices to logical positions.
  Active rows advance one position a step exactly as the cursor does, so
  a live row never wraps onto its own data.
- **One decode block for all slots.** A block runs ``block_size``
  single-token steps over all S slots, active or not; per-row masks freeze
  finished rows (their length stops, their fed token stops changing).
  Inactive rows compute values nobody reads.
- **Chunked prefill.** A request's prompt (all but its last token) is fed
  in ``prefill_chunk``-sized chunks whose K/V are written at the slot's
  ring indices; only the valid positions of a chunk are written (the pad
  tail is written nowhere: wrapped, it would overwrite the slot's own
  earliest positions). The final chunk also commits the slot's decode
  state. The prompt's last token is not prefilled: it is the slot's first
  fed token, so the first sampled token falls out of the decode step.
  ``batched_admission`` (default) feeds chunk round r of every admitted
  request in one ``_prefill_batch`` call.
- **The device never waits on the host** in predictive mode (no stop
  tokens): the per-slot state stays on the device and each block consumes
  the previous block's tensors in stream order; admission vectors reach
  the card through pinned memory and asynchronous copies; the host
  schedules from an exact model of the slots and reads a block's packed
  result only when it needs the tokens. With stop tokens, blocks are read
  in bursts behind a ``pipeline_depth`` lag.
- **Chunk-aligned prefix cache** (``prefix_cache_blocks=N``): a host trie
  keyed on ``prefill_chunk``-sized token blocks whose nodes own KV blocks
  in a device pool (``PrefixPool``). Admission walks the trie for the
  longest cached chunk-aligned prefix of each prompt body, copies its
  blocks into the slot's ring (``_copy_prefix_blocks``, one call a burst),
  prefills only the suffix, then copies the burst's new full chunks out of
  the rings into fresh pool blocks (``_insert_prefix_blocks``, right after
  the suffix prefill: a frozen slot's ring keeps taking the decode blocks'
  writes at the cursor, so the prompt may be overwritten by the time its
  completion is processed). Lookups see the trie as of the burst's start,
  so sharing begins one burst after a prefix first appears. A request
  holds a reference on its matched path from admission until its
  completion (or cancellation) is processed; unreferenced leaves are
  evicted least recently used first when the pool is full. K/V at
  position p depends only on tokens up to p, so a copied block holds the
  bytes a cold prefill would write (int8 values and scales included) and
  completions are the same with the cache on or off.
- **Request journal and replay** (``journal=``, ``replay=True``): every
  accepted request opens a ``RequestJournal`` entry (its prompt, sampling
  parameters and the tokens processed so far, appended at each processed
  block). ``reset()`` after a loop failure re-queues the journaled
  in-flight requests with ``resume_tokens``: the prompt plus the journaled
  prefix is teacher-forced through the chunked prefill and only the rest
  of the budget decodes, so a greedy request completes with the tokens of
  an uninterrupted run (at float32). A file-backed journal survives the
  process: ``recover_journal`` resubmits a dead process's entries.
- **Token streams** (``attach_stream``): a request's ``api.stream.
  TokenStream`` is fed at every processed block, right after the journal
  advances, and sealed at every terminal (a Completion, a loss to
  ``reset()`` with replay off, ``fail_queued``). Predictive mode processes
  blocks only at a completion, a 64-block backlog or ServeApp's journal
  checkpoint, so a stream's frames come at that cadence; EOS mode
  processes every block behind the pipeline lag.
- **Chaos hooks** (``TONY_TEST_SERVING_*``, constants.py): a seeded
  per-turn failure rate and step delay, a crash at given decode-block
  ordinals and a SIGKILL at one, read once at construction.
- **Paged KV** (``paged=True``): no slots x max_len ring. K/V lives in
  one pool of ``kv_block``-row blocks (``kv_pool_blocks`` of them plus a
  pad block that stays zero), each slot holds a table of block ids, and
  a ``BlockAllocator`` refcounts the blocks (a slot table entry and a
  trie node each hold one). Every dispatch gathers a transient
  ring-ordered view of the pool (``_gather_paged_view``: the ring
  engine's ``[L, S, kvH, M, D]`` layout, slot s's logical position p at
  index (p + offset_s) mod M), runs the ring engine's own program on it,
  and commits back only the rows that program wrote
  (``_scatter_paged_rows``), so completions are the ring engine's.
  Admission allocates every block a request can write up front, all or
  nothing and within its priority class's budget (``class_budgets``), and
  defers when the pool is short, after reclaiming unshared trie leaves:
  an admitted request never fails for want of KV. Its prefill runs slot
  by slot, chunk by chunk, through ``_pending_prefill``; with
  ``prefill_interleave=N`` at most N prompt tokens a decode block, so a
  burst of long prompts no longer stalls running streams. The prefix
  trie then shares the pool's blocks (``PrefixCache(allocator=)``): a
  hit maps the cached blocks into the slot's table and copies nothing.
- **Reading a block's result.** Right after a decode block is enqueued,
  its packed result starts copying into pinned host memory and a CUDA
  event is recorded; processing waits only on the events of the blocks it
  reads, so a read of old blocks never waits for the newest ones.

The attention of every program here is the einsum formulation of
``_cached_attention`` (per-row lengths and ring offsets), as in the JAX
package, whose decode-kernel gate excludes both: the serving path
launches none of the port's CUDA kernels.

Exactness: a request's greedy tokens equal a solo ``generate()`` run and
the JAX package's ``SlotServer`` at float32 (tests/test_torch_serving.py).

A Python exception in the loop (the chaos hook, a host bug) leaves the
CUDA context usable and ``reset()`` re-arms the engine. A sticky CUDA
fault (an illegal address, a device-side assert) poisons the context:
``reset()`` then raises itself, and only a new process recovers the
requests, from a file-backed journal.

- **Telemetry** (``telemetry``, ``trace_sink=``): every request gets a
  ``RequestTrace`` at submit, marked ``admitted`` and ``prefill_done``
  where admission dispatches its prefill, ``first_token`` where a
  processed block first shows its tokens (after that block's pinned read,
  never in dispatch), ``replayed`` when ``reset()`` re-queues it, and one
  terminal. The sealed trace feeds ``ServingTelemetry``'s histograms,
  rides ``Completion.trace`` and goes to ``trace_sink`` (a failing sink
  is logged, never raised). A slot-freeing terminal feeds the service-time
  EWMA behind ``estimate_retry_after()``, which every ``QueueFullError``
  carries. Every mark is a host clock reading: nothing waits for the card.
- **Device time** (``dispatch_tracker``, an ``observability.
  DispatchTracker``): every device program the engine enqueues (prefill
  chunks and rounds, decode blocks, prefix copies and inserts, paged
  scatters) registers a fence, a CUDA event recorded right behind it (a
  decode block's is the event behind its pinned read). The tracker's
  reaper thread waits on them in dispatch order, off the serving thread,
  and ``_process`` subtracts a block's ready instant from the instant the
  host reads it: ``device_lag_s`` (the histogram, and the traces'
  ``device_lag_s`` and ``device_lag_first_token_s``). ``stats()["device"]``
  is the tracker's snapshot. Recording an event waits for nothing.
- **Disaggregated roles** (``role=``): ``"prefill"`` (paged only) runs
  admission and the chunked prefill, then completes the request
  ``"prefilled"`` with no tokens, frees its slot and blocks, and keeps a
  transfer payload for ``export_blocks``; ``"decode"`` and ``"both"`` serve
  normally and ``import_blocks`` installs another replica's payload into
  this pool and resumes the decode, as a local final prefill chunk would.
  The wire format (``serialize_kv_blocks``) is the JAX package's, byte for
  byte, so a payload crosses frameworks. The export enqueues a copy of the
  blocks into pinned memory behind a CUDA event and serializes only when
  the payload is asked for, so nothing in dispatch waits for the card.
  On a mesh a payload is still the one-device pool's (every kv head in
  its head order, the blocks in table order, int8 scales split along the
  same head axis): each rank holding a slice of the request's heads
  (``join_kv_heads`` / ``split_kv_heads``) snapshots it, a follower's
  slice travels to rank 0 on the lockstep's gloo group at a later turn,
  once its copy's event is done (``take_export_parts``), and rank 0
  assembles them in ``export_blocks``. An import hands every rank the
  whole payload; each writes its own heads, on a batch-split mesh only
  the ranks of the share that owns the slot. So any topology hands off
  to any other.

``weight_dtype="int8"`` (w8a16): the decode blocks run the int8 fused
matrices (models/generate.py), the prefill programs the cast weights, as
the JAX package's engines do.

- **Model registry** (``registry=``, ``model=``; models/registry.py):
  the server serves one named entry; a (params, cfg) pair is registered
  under ``model``. ``stats()["registry"]`` lists the names.
- **Speculative serving** (``draft=``: a registry entry's name, or
  weights with ``draft_cfg=``; greedy only): the draft keeps its own ring
  (or, paged, a mirror pool on the same tables) at the target's per-row
  lengths, admission prefills both (the prefix trie's blocks mirrored into
  a draft-shaped pool), and every dispatch is one round for all slots
  (``_spec_block``): gamma+1 draft steps, one gamma+1-wide verify
  forward, the longest agreeing prefix plus the target's correction. Each
  request's tokens are the spec-off server's. Speculative rings sit at
  offset 0 (a round advances each slot by its own count, so there is no
  shared cursor) and each row's writes stop at its target. The window
  gamma is the ``spec_gamma`` pin or autotuned from each slot's acceptance
  EWMA to a power of two up to ``spec_gamma_max``; ``stats()
  ["speculative"]`` has the counters. A round's result is read as a
  decode block's is: dispatch and admission wait for nothing.

- **MoE** (``n_experts > 0``): both engines, with or without a draft,
  serve it through the same programs; the server's config routes
  drop-free (``moe_dropfree``), so a token's MLP output depends on it
  alone and padded or batched prefill rows change nothing.

- **Tensor-parallel serving** (``mesh=``, ``rules=``, or weights from
  ``prepare_decode(mesh=)``; the JAX package's serving.py:1692-1816): one
  process a card, each rank running this engine on its blocks
  (parallel/spmd.py ``Plan``; the forward's collectives as
  models/generate.py's). The ring cache holds the rank's kv heads, and
  with the batch axes wider than one the rank's ``slots / t_batch`` slots
  (the per-slot state too): the prefill programs run the rank's rows, a
  decode block samples the whole pool's draws and keeps its rows, and its
  packed result is gathered over the batch axes where the host reads it.
  The prefix and paged pools split their block axis over the batch axes
  as the ring splits its slots. The paged allocator gives a slot blocks
  of its own rank's share, and a slot's trie hits stop at another share's
  block, so the paged gather and scatter stay on the rank; the prefix
  pool's copies into and out of another rank's blocks go through
  ``Plan.from_owners`` (a gather over the batch axes). The host state
  (queue, trie, allocator, tables) is the whole pool's and the same on
  every rank; parallel/lockstep.py keeps the ranks in step. A MoE
  model's experts split over the ``expert`` axis (``EP_RULES`` merged
  into the rules) through ``transformer._mlp``'s plan. Speculation is
  refused, int8 weights under a sharded tensor axis too.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import hashlib
import itertools
import logging
import math
import os
import random
import signal
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import constants as c
from ..device import resolve_device
from ..events.journal import RequestJournal
from ..observability import (
    DispatchTracker,
    Histogram,
    RequestTrace,
    ServiceRateEstimator,
    ServingTelemetry,
    TraceContext,
)
from . import transformer
from ..parallel.spmd import rule_size
from .generate import (
    DecodeWeights,
    KVCache,
    PrefixPool,
    _attn_out,
    _cached_attention,
    _cast_decode_params,
    _forward_with_cache,
    _replicated_kv_heads,
    _quantize_kv,
    _validate_decode_mesh,
    init_cache,
    init_prefix_pool,
    moe_dropfree,
    prepare_decode,
    sample_token,
)
from .registry import ModelRegistry
from .transformer import TransformerConfig, layer_params, rms_norm

log = logging.getLogger(__name__)

# What a delivered Completion.finish_reason can say (the JAX package's
# serving.py:173-180); "shed" is a queued batch-tier request displaced by
# an interactive arrival, "prefilled" ends a prefill-role request whose
# KV went out for another replica to decode. "failed" ends a request with
# no Completion.
COMPLETION_FINISH_REASONS = ("stop", "length", "cancelled", "expired",
                             "shed", "prefilled")
FINISH_REASONS = COMPLETION_FINISH_REASONS + ("failed",)

# Admission tiers, best first: "batch" sheds at a lower queue threshold
# and is displaced by interactive arrivals under a full queue.
PRIORITY_CLASSES = ("interactive", "batch")

# per-request logprobs cap: a decode block carries this many top entries
# whenever any busy slot asked for logprobs
LOGPROBS_MAX = 8

def _normalize_stop(stop) -> list[tuple[int, ...]]:
    """Validate/normalize Request.stop: a list of token-id sequences
    (a flat int list reads as ONE sequence). Raises ValueError on
    empty sequences or non-ints."""
    if not isinstance(stop, (list, tuple)) or not stop:
        raise ValueError("stop must be a non-empty list")
    if all(isinstance(t, (int, np.integer)) for t in stop):
        stop = [stop]
    out = []
    for seq in stop:
        if not isinstance(seq, (list, tuple)) or not seq:
            raise ValueError("each stop sequence must be a non-empty "
                             "list of token ids")
        out.append(tuple(int(t) for t in seq))
    if len(out) > 16:
        raise ValueError("at most 16 stop sequences per request")
    return out


def _stop_match_end(tokens, stop_seqs, start: int = 0) -> int | None:
    """Earliest end index (exclusive) of a stop-sequence match that
    ENDS after ``start`` — tokens before ``start`` were already
    delivered and are never retracted, but a match may BEGIN inside
    them (sequences span block boundaries). None = no match."""
    best = None
    n = len(tokens)
    for seq in stop_seqs or ():
        m = len(seq)
        if m == 0 or n < m:
            continue
        lo = max(0, start - m + 1)
        for i in range(lo, n - m + 1):
            end = i + m
            if end <= start:
                continue
            if tuple(int(t) for t in tokens[i:end]) == tuple(seq):
                if best is None or end < best:
                    best = end
                break       # earliest match of THIS sequence found
    return best


@dataclass
class Request:
    """One generation request. ``prompt`` is a token-id sequence (>= 1
    token); ``max_new_tokens`` bounds the emission; stop tokens end it
    early (the stop token itself is included in the output, matching
    generate()). ``temperature`` and ``top_k`` override the server
    defaults per request (temperature 0 = greedy, top_k 0 = unfiltered).

    ``deadline`` is an absolute ``time.monotonic()`` instant: a request
    still queued past it is never admitted and completes "expired".
    ``stop`` is a per-request list of stop SEQUENCES, matched on the host
    when a block is processed; the match is included in the output.
    ``logprobs`` (0 = off, <= LOGPROBS_MAX) asks for the top-k
    log-probabilities of every emitted token. ``cache_prompt`` overrides
    the server's ``cache_prompts`` default: whether this prompt's body
    chunks go into the prefix cache at admission (None = the server's
    default).

    ``trace`` is the request's ``TraceContext`` (or its ``as_dict()``): the
    journal records it, so a replay or a recovery stays in its trace.

    ``resume_tokens`` teacher-forces an already-emitted prefix: the server
    admits with the effective context ``prompt + resume_tokens`` (through
    the chunked prefill, prefix-cache lookup included), decodes only the
    remaining ``max_new_tokens - len(resume_tokens)``, and the Completion's
    tokens are ``resume_tokens`` + the continuation (for a greedy request,
    the uninterrupted stream). It is what ``reset()`` replay and journal
    recovery resubmit. A prefix that already satisfies the request (budget
    reached, a stop token or a stop sequence) completes at submit without
    taking a slot. With logprobs, the prefix's positions carry
    ``logprob: None`` (they were prefilled, not decoded)."""
    prompt: Any
    max_new_tokens: int
    temperature: float | None = None
    top_k: int | None = None
    cache_prompt: bool | None = None
    deadline: float | None = None
    resume_tokens: list | None = None
    stop: list | None = None
    logprobs: int = 0
    model: str | None = None
    priority: str = "interactive"
    trace: Any = None
    id: int = field(default_factory=itertools.count().__next__)


@dataclass
class Completion:
    id: int
    tokens: list[int]
    finish_reason: str      # one of COMPLETION_FINISH_REASONS
    # the request's sealed lifecycle trace (RequestTrace.to_dict())
    trace: dict | None = None
    # per emitted token (Request.logprobs > 0): {"token", "logprob",
    # "top": [[ids], [logprobs]]}, in stream order
    logprobs: list | None = None


class QueueFullError(RuntimeError):
    """Admission refused: the wait queue is at ``max_queue``. The shed
    request was never accepted; the caller should surface backpressure
    (HTTP 429 + Retry-After). ``submit`` sets ``retry_after_s``, the
    engine's estimate at the shed, and ``priority``, the refused request's
    class."""


@dataclass
class _Admission:
    """One (slot, request) pair of an admission burst, with the layout
    decisions made at collection time: ring offset, budget target,
    sampling overrides, the chunk starts the prefill will feed (from the
    cached prefix's end, ``prefix_len``), and the matched prefix-cache
    trie path ([] without a hit)."""
    slot: int
    req: Request
    body: np.ndarray
    offset: int
    target: int
    temp: float
    topk: int
    chunk_starts: list
    last: int = 0               # the first fed token: the prompt's last
    prefix_len: int = 0
    hit_path: list = field(default_factory=list)


@dataclass
class _SlotState:
    """The device-carried per-slot decode state, one [S] tensor each."""
    tokens: torch.Tensor        # next fed token, int32
    active: torch.Tensor        # bool
    target: torch.Tensor        # logical length at which the slot stops
    offsets: torch.Tensor       # ring offset, int32
    temps: torch.Tensor         # float32
    topks: torch.Tensor         # int32


def _stage(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a wait for the card: through
    pinned memory and an asynchronous copy (a copy from pageable memory
    waits for the stream). The caching host allocator keeps the pinned
    block until the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


# ------------------------------------------------------------ device programs

@torch.no_grad()
def _prefill_batch(params, cfg: TransformerConfig, cache: KVCache,
                   state: _SlotState, tokens, slots, starts, offsets,
                   n_valids, last_tokens, targets, temps, topks, fin, *,
                   plan=None, slot_range=None) -> None:
    """Feed chunk tokens [K, C] into K slots' cache rows, in place: row r
    writes slot ``slots[r]`` at logical positions ``starts[r]..`` (ring
    index (offset + p) mod M), only its first ``n_valids[r]`` positions;
    each row's length becomes ``starts[r] + n_valids[r]``. Rows with
    ``fin`` (the request's last chunk, a zero-valid chunk for a 1-token
    prompt included) also commit the slot's decode state: fed token,
    active, budget target, ring offset, temperature and top-k.

    Every argument after ``state`` is a host (numpy) array; they reach the
    device in three asynchronous copies. Attention reads each row's own
    slot ([kvH, M, D], gathered after this layer's writes) through the
    per-row-length, ring-offset einsum path (the JAX package's
    serving.py:829). The JAX package pads K to a power of two and
    diverts the writes of padding rows and pad tails out of bounds; here
    rows are only the requests that have a chunk this round, and only the
    valid (row, position) pairs are written.

    ``plan``: a mesh rank's heads (module docstring); ``slot_range`` =
    (first, count) of the slots a batch-split rank holds: the rows of other
    slots are dropped and the rest address the rank's local rows."""
    if slot_range is not None:
        lo, n = slot_range
        sl = np.asarray(slots, np.int64)
        keep = (sl >= lo) & (sl < lo + n)
        if not keep.any():
            return
        tokens, slots = np.asarray(tokens)[keep], sl[keep] - lo
        starts, offsets, n_valids, last_tokens, targets, temps, topks, fin = (
            np.asarray(a)[keep] for a in (starts, offsets, n_valids,
                                          last_tokens, targets, temps,
                                          topks, fin))
    dev, dt = cache.k.device, cfg.dtype
    # final rows first, so the commit below is a slice of the row table
    order = np.argsort(~np.asarray(fin, bool), kind="stable")
    n_fin = int(np.count_nonzero(fin))
    k_rows, l = tokens.shape
    m_cap = cache.k.shape[3]
    cols = [np.asarray(a, np.int64)[order] for a in
            (slots, starts, offsets, np.asarray(starts) + n_valids,
             last_tokens, targets, topks)]
    table = _stage(np.concatenate(
        [np.asarray(tokens, np.int64)[order], np.stack(cols, 1)], 1), dev)
    n_valids = np.asarray(n_valids)[order]
    pair_row, pair_j = np.nonzero(np.arange(l)[None, :] < n_valids[:, None])
    slots_h, starts_h, offsets_h = cols[0], cols[1], cols[2]
    pairs = _stage(np.stack([
        pair_row, pair_j, slots_h[pair_row],
        (offsets_h[pair_row] + starts_h[pair_row] + pair_j) % m_cap]), dev)
    temps_d = _stage(np.asarray(temps, np.float32)[order], dev)
    tok = table[:, :l]
    slots_d, starts_d, offsets_d, new_len, lasts, targs, topks_d = \
        table[:, l:].unbind(1)
    p_row, p_j, p_slot, p_ring = pairs.unbind(0)

    positions = starts_d[:, None] + torch.arange(l, device=dev)
    x = transformer._embed(params, tok, cfg, plan)
    int8_cache = cache.k.dtype == torch.int8
    for i in range(cfg.n_layers):
        lp = layer_params(params, i, plan, cfg)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = transformer._qkv(cfg, h, positions, lp, plan)
        kv_sel = _replicated_kv_heads(cfg, plan, q.shape[2], dev)
        k_hm, v_hm = k.transpose(1, 2), v.transpose(1, 2)   # [K, kvH, C, D]
        ck, cv = cache.k[i], cache.v[i]
        row_ks = row_vs = None
        if int8_cache:
            k_hm, ks = _quantize_kv(k_hm)
            v_hm, vs = _quantize_kv(v_hm)
            cache.k_scale[i][p_slot, :, p_ring] = ks[p_row, :, p_j]
            cache.v_scale[i][p_slot, :, p_ring] = vs[p_row, :, p_j]
            row_ks, row_vs = cache.k_scale[i][slots_d], \
                cache.v_scale[i][slots_d]
        ck[p_slot, :, p_ring] = k_hm[p_row, :, p_j].to(ck.dtype)
        cv[p_slot, :, p_ring] = v_hm[p_row, :, p_j].to(cv.dtype)
        rk, rv = ck[slots_d], cv[slots_d]
        if kv_sel is not None:          # every kv head cached, heads split
            rk, rv = rk.index_select(1, kv_sel), rv.index_select(1, kv_sel)
            if row_ks is not None:
                row_ks = row_ks.index_select(1, kv_sel)
                row_vs = row_vs.index_select(1, kv_sel)
        attn = _cached_attention(cfg, q, rk, rv, starts_d, l, row_ks, row_vs,
                                 ring_offsets=offsets_d)
        x = x + _attn_out(attn, lp["wo"], cfg, plan)
        hh = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        mlp_out, _ = transformer._mlp(cfg, hh, lp, plan)
        x = x + mlp_out
    # tensor values and index_fill_ only: a Python scalar assigned through
    # a tensor index reaches the card by a copy that waits for it
    cache.length[slots_d] = new_len.to(torch.int32)
    done = slots_d[:n_fin]
    state.tokens[done] = lasts[:n_fin].to(torch.int32)
    state.active.index_fill_(0, done, True)
    state.target[done] = targs[:n_fin].to(torch.int32)
    state.offsets[done] = offsets_d[:n_fin].to(torch.int32)
    state.temps[done] = temps_d[:n_fin]
    state.topks[done] = topks_d[:n_fin].to(torch.int32)


def _prefill_chunk(params, cfg: TransformerConfig, cache: KVCache,
                   state: _SlotState, tokens, slot: int, start: int,
                   offset: int, n_valid: int, last_token: int, target: int,
                   temp: float, topk: int, *, finalize: bool, plan=None,
                   slot_range=None) -> None:
    """One slot's chunk ([C] host tokens, valid up to ``n_valid``): the
    one-row case of ``_prefill_batch`` (the JAX package's
    serving.py:721)."""
    _prefill_batch(params, cfg, cache, state, np.asarray(tokens)[None],
                   [slot], [start], [offset], [n_valid], [last_token],
                   [target], [temp], [topk], [finalize], plan=plan,
                   slot_range=slot_range)


@torch.no_grad()
def _decode_block(params, fused, cfg: TransformerConfig, cache: KVCache,
                  state: _SlotState, cursor: int, generator, *, block: int,
                  stop_arr, pad_id: int, top_k: int, per_row_topk: bool,
                  all_greedy: bool, lp_k: int = 0, plan=None, rows=None):
    """``block`` single-token decode steps for ALL slots -> (cache, packed).
    The cache's K/V are written in place; ``state.tokens`` and
    ``state.active`` are rebound to the block's final values. Per-row
    masks freeze finished slots: their length stops advancing and their
    fed token stops changing (the K/V an idle row writes at the cursor is
    never read: re-admission rewrites the slot).

    ``packed`` [S, block+2] int32, a fresh tensor, is the emitted token
    matrix (pad past a slot's stop) with the final lengths and active mask
    as its last two columns: one device-to-host copy per processed block.
    ``lp_k`` > 0 widens it to [S, block+2+block*(2*lp_k+1)]: each step's
    chosen-token logprob (float32 bits as int32), the top-``lp_k`` ids and
    their logprobs (bits), read off the same logits row the token was
    sampled from (the JAX package's serving.py:937).

    ``plan``: a mesh rank's heads; ``rows`` = (first slot, slots) of a
    batch-split rank: its draws are its rows of the whole pool's, and
    ``packed`` is gathered over the batch axes (the whole pool's)."""
    m_cap = cache.k.shape[3]
    tokens, active = state.tokens, state.active
    emitted, chosen, top_ids, top_vals = [], [], [], []
    for _ in range(block):
        logits, new_cache = _forward_with_cache(
            params, cfg, tokens[:, None], cache, fused,
            ring=(cursor, state.offsets), plan=plan)
        nxt = sample_token(logits, generator,
                           0.0 if all_greedy else state.temps,
                           state.topks if per_row_topk else top_k, rows)
        emitted.append(torch.where(active, nxt, pad_id).to(torch.int32))
        if lp_k:
            # the model's own distribution, before temperature and top-k
            lp_full = torch.log_softmax(logits.float(), dim=-1)
            vals, ids = torch.topk(lp_full, lp_k, dim=-1)
            top_vals.append(vals)
            top_ids.append(ids.to(torch.int32))
            chosen.append(lp_full.gather(-1, nxt[:, None].long())[:, 0])
        # only rows active this step advance (ring-aligned with the cursor)
        new_len = torch.where(active, new_cache.length, cache.length)
        cache = dataclasses.replace(new_cache, length=new_len)
        still = active & (new_len < state.target)
        if stop_arr is not None:
            still &= ~(nxt[:, None] == stop_arr).any(dim=-1)
        tokens = torch.where(still, nxt, tokens)
        active = still
        cursor = (cursor + 1) % m_cap
    state.tokens, state.active = tokens, active
    cols = [torch.stack(emitted, 1), cache.length[:, None],
            active.to(torch.int32)[:, None]]
    if lp_k:
        s = tokens.shape[0]
        cols += [torch.stack(chosen, 1).float().view(torch.int32),
                 torch.stack(top_ids, 1).reshape(s, block * lp_k),
                 torch.stack(top_vals, 1).float().reshape(s, block * lp_k)
                 .view(torch.int32)]
    packed = torch.cat(cols, dim=1)
    if rows is not None:
        packed = plan.gather_batch(packed).reshape(rows[1], -1)
    return cache, packed


def _spec_rows_forward(params, cfg: TransformerConfig, tokens, cache: KVCache,
                       lens, offsets, active, cap):
    """Forward L new tokens a row (rows = slots) at per-row logical
    positions ``lens[r]..lens[r]+L-1``, each row's K/V written into its own
    ring in place -> all-position logits [S, L, V] float32 (the JAX
    package's serving.py:1052). The building block of a speculative round.

    Writes land only for ``active`` rows at positions below ``cap[r]``
    (the row's target): a verify window past the target would otherwise
    wrap onto the row's own earliest prompt K/V, and no delivered token
    needs K/V at or past the target. The JAX package diverts those writes
    out of bounds and drops them; here each row's L ring indices are
    distinct (L <= max_len), so every (row, index) pair is written once,
    with the new value where the write lands and the value read back where
    it is dropped: no index leaves the buffer and nothing races.

    Raw (cast) weights, as the prefill programs use: exactness against the
    plain decode path needs the prefill's numerics."""
    dt = cfg.dtype
    s, l = tokens.shape
    m_cap = cache.k.shape[3]
    dev = tokens.device
    positions = lens[:, None].long() + torch.arange(l, device=dev)  # [S, L]
    ok = (active[:, None] & (positions < cap[:, None]))[:, None, :]
    ring_idx = (offsets[:, None].long() + positions) % m_cap
    rows = torch.arange(s, device=dev)[:, None]
    int8_cache = cache.k.dtype == torch.int8

    def put(buf, new):
        # buf [S, kvH, M(, D)], new [S, kvH, L(, D)]: keep what is there
        # where the write drops
        old = buf[rows, :, ring_idx].transpose(1, 2)     # [S, kvH, L(, D)]
        keep = ok if new.dim() == 3 else ok[..., None]
        buf[rows, :, ring_idx] = torch.where(keep, new.to(buf.dtype),
                                             old).transpose(1, 2)

    x = params["embed"].to(dt)[tokens]
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = transformer._qkv(cfg, h, positions, lp)
        k_hm, v_hm = k.transpose(1, 2), v.transpose(1, 2)    # [S, kvH, L, D]
        if int8_cache:
            k_hm, ks = _quantize_kv(k_hm)
            v_hm, vs = _quantize_kv(v_hm)
            put(cache.k_scale[i], ks)
            put(cache.v_scale[i], vs)
        put(cache.k[i], k_hm)
        put(cache.v[i], v_hm)
        attn = _cached_attention(cfg, q, cache.k, cache.v, lens, l,
                                 cache.k_scale, cache.v_scale,
                                 ring_offsets=offsets, layer_idx=i)
        x = x + torch.einsum("blhk,hkd->bld", attn, lp["wo"].to(dt))
        hh = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        mlp_out, _ = transformer._mlp(cfg, hh, lp)
        x = x + mlp_out
    x_out = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bld,dv->blv", x_out,
                        params["unembed"].to(dt)).float()


@torch.no_grad()
def _spec_block(params, draft_params, cfg: TransformerConfig,
                draft_cfg: TransformerConfig, cache: KVCache,
                draft_cache: KVCache, state: _SlotState, *, gamma: int,
                stop_arr, pad_id: int):
    """One speculative round for ALL slots -> (cache, draft_cache, packed)
    (the JAX package's serving.py:1131). The draft proposes ``gamma``
    tokens a row in gamma+1 single-token steps (the extra step ingests the
    last proposal, so the draft cache is one ahead when all are accepted),
    the target verifies every row's gamma+1 positions in one forward, and
    each row accepts its longest matching draft prefix plus the target's
    own correction (or bonus) token, clamped by its remaining budget and
    cut after its first stop token: where the plain decode block freezes
    the row. So each request's tokens are the plain path's, for any
    draft.

    Rollback is a length write: both caches' entries past the accepted
    prefix are overwritten by the next round's fed tokens before any query
    reads them. ``state.tokens`` and ``state.active`` are rebound to the
    round's results; both caches come back with the new lengths.

    ``packed`` [S, gamma+4] int32, a fresh tensor: the emitted tokens (pad
    past each row's count), the raw acceptance count, the final length and
    the active flag; the host slices it by length delta as it does a
    decode block's."""
    s = cache.k.shape[1]
    dev = cache.k.device
    len0, active, tok = cache.length, state.active, state.tokens
    cap = state.target
    dlen = draft_cache.length
    fed = [tok]
    for _ in range(gamma + 1):
        lg = _spec_rows_forward(draft_params, draft_cfg, fed[-1][:, None],
                                draft_cache, dlen, state.offsets, active,
                                cap)
        fed.append(lg[:, 0].argmax(dim=-1).to(torch.int32))
        dlen = dlen + 1
    d = torch.stack(fed[1:gamma + 1], dim=1)                # [S, gamma]
    lg = _spec_rows_forward(params, cfg, torch.cat([tok[:, None], d], 1),
                            cache, len0, state.offsets, active, cap)
    t_pred = lg.argmax(dim=-1).to(torch.int32)              # [S, gamma+1]
    n_acc = torch.cumprod((d == t_pred[:, :gamma]).to(torch.int32),
                          dim=1).sum(dim=1).to(torch.int32)
    idx = torch.arange(gamma + 1, device=dev)[None, :]
    correction = t_pred.gather(1, n_acc[:, None].long())
    d_ext = torch.cat([d, torch.zeros((s, 1), dtype=torch.int32,
                                      device=dev)], dim=1)
    # the row's next n_acc + 1 greedy tokens: accepted drafts, then the
    # target's correction (a mismatch) or bonus (all accepted)
    cand = torch.where(idx == n_acc[:, None], correction, d_ext)
    room = (cap - len0).clamp_min(0)
    n_budget = torch.minimum(n_acc + 1, room)
    if stop_arr is not None:
        hit = (cand[..., None] == stop_arr).any(dim=-1)
        stop_idx = torch.where(hit & (idx < n_budget[:, None]), idx,
                               gamma + 1).amin(dim=1)
        stop_hit = active & (stop_idx < n_budget)
        n_emit = torch.where(stop_hit, stop_idx + 1, n_budget)
    else:
        stop_hit = torch.zeros_like(active)
        n_emit = n_budget
    n_emit = torch.where(active, n_emit, 0).to(torch.int32)
    new_len = (len0 + n_emit).to(torch.int32)
    still = active & ~stop_hit & (new_len < cap)
    # the next fed token: the last emitted one (read only while the row
    # is still active, when it is the unwritten correction or bonus)
    nxt = cand.gather(1, (n_emit - 1).clamp_min(0)[:, None].long())[:, 0]
    state.tokens = torch.where(still, nxt, tok)
    state.active = still
    emitted = torch.where(idx < n_emit[:, None], cand, pad_id)
    packed = torch.cat([emitted.to(torch.int32), n_acc[:, None],
                        new_len[:, None], still.to(torch.int32)[:, None]],
                       dim=1)
    return (dataclasses.replace(cache, length=new_len),
            dataclasses.replace(draft_cache, length=new_len.clone()), packed)


class _BatchShard:
    """A mesh whose batch axes are wider than one splits the slot pool and
    the KV pools' block axes in contiguous shares, in batch-rank order:
    this rank holds slots [lo, lo + s_n) and, of a pool of N blocks,
    blocks [rank * N / n, (rank + 1) * N / n). ``exchange`` moves what
    other ranks hold in the prefix pool: every rank offers its candidates
    for the items and each item comes from its owner
    (``Plan.from_owners``). The paged pool needs no exchange: its slots'
    blocks are their own rank's (``BlockAllocator`` shares)."""

    def __init__(self, plan, slots: int):
        self.plan = plan
        self.n, self.rank = plan.batch_size, plan.batch_rank
        self.s_n = slots // self.n
        self.lo = self.rank * self.s_n

    def mine(self, slots) -> np.ndarray:
        slots = np.asarray(slots, np.int64)
        return (slots >= self.lo) & (slots < self.lo + self.s_n)

    def exchange(self, t: torch.Tensor, owner: torch.Tensor, dim: int):
        """``t`` with each index along ``dim`` from the rank ``owner``
        [size of dim] names."""
        view = [1] * t.dim()
        view[dim] = -1
        return self.plan.from_owners(t, owner.view(view))


def _pool_tensors(pool) -> list:
    return [t for t in (pool.k, pool.v, pool.k_scale, pool.v_scale)
            if t is not None]


def _with_tensors(pool, ts: list):
    """``pool`` (a PrefixPool or a KVCache) over the tensors ``ts``, in
    ``_pool_tensors`` order."""
    names = ("k", "v", "k_scale", "v_scale")[:len(ts)]
    return dataclasses.replace(pool, **dict(zip(names, ts)))


class _Fence:
    """What ``DispatchTracker`` waits on for one dispatch: a CUDA event
    recorded right behind it, or nothing on the CPU, where the work is
    done when the call returns. The event is made with ``blocking=True``:
    a thread waiting on it sleeps (PyTorch releases the interpreter lock
    around the wait) instead of spinning on a core the host-bound serving
    loop needs."""
    __slots__ = ("event",)

    def __init__(self, event=None):
        self.event = event

    def block_until_ready(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def _event(device: torch.device):
    """A blocking CUDA event recorded now on the current stream, or None
    off the card. Recording waits for nothing."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(blocking=True)
    ev.record()
    return ev


def _start_read(packed: torch.Tensor):
    """Start a decode block's packed result on its way to the host ->
    (host tensor, CUDA event or None). On the card: a non-blocking copy
    into pinned memory (PyTorch's host allocator caches the blocks and
    keeps each until its copy has run) and an event behind it, so a
    reader waits for this block only, not for the blocks enqueued after
    it (the event is also the block's fence for the dispatch tracker). On
    the CPU the result is host memory already."""
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    return host, _event(packed.device)


def _cancel_slot(active: torch.Tensor, slot: int) -> None:
    """Deactivate one slot's device-carried active flag, in stream order:
    every block dispatched before still decodes the slot, every block
    after treats it as an idle row (the JAX package's serving.py:1037).
    A fill of a one-element view: no copy from the host, no wait."""
    active[slot:slot + 1].fill_(False)


@torch.no_grad()
def _write_pool_blocks(pool: PrefixPool, ids, k, v, ks, vs) -> None:
    """Install imported blocks (host tensors in the pool's layout, pinned
    on the card: the copies wait for nothing) at the pool's block ids
    ``ids``, in place: one ``index_copy_`` a tensor."""
    dev = pool.k.device
    idx = _stage(np.asarray(ids, np.int64), dev)
    pairs = [(pool.k, k), (pool.v, v)]
    if pool.k_scale is not None:
        pairs += [(pool.k_scale, ks), (pool.v_scale, vs)]
    for dst, src in pairs:
        dst.index_copy_(1, idx, src.to(dev, non_blocking=True))


@torch.no_grad()
def _activate_slot(state: _SlotState, lens: torch.Tensor, slot: int,
                   token: int, target: int, offset: int, length: int,
                   temp: float, topk: int) -> None:
    """Write one slot's decode state as a final prefill chunk's commit
    does (fed token, active, budget target, ring offset, length,
    temperature, top-k), from one staged host row: a Python scalar
    assigned through a tensor index would reach the card by a copy that
    waits for it."""
    dev = lens.device
    row = _stage(np.asarray([slot, token, target, offset, length, topk],
                            np.int64), dev)
    temp_d = _stage(np.asarray([temp], np.float32), dev)
    at = row[0:1]
    state.tokens[at] = row[1:2].to(torch.int32)
    state.active.index_fill_(0, at, True)
    state.target[at] = row[2:3].to(torch.int32)
    state.offsets[at] = row[3:4].to(torch.int32)
    lens[at] = row[4:5].to(torch.int32)
    state.temps[at] = temp_d
    state.topks[at] = row[5:6].to(torch.int32)


# ---------------------------------------------------------- prefix cache

class _PrefixNode:
    """One trie node: one ``prefill_chunk``-sized token block owning one
    pool block. ``refs`` counts the admitted requests whose matched path
    runs through it (admission to processed completion), plus a transient
    insert reference that protects a just-allocated node until its copy
    into the pool is dispatched; ``tick`` is the LRU clock."""
    __slots__ = ("children", "parent", "key", "block", "refs", "tick")

    def __init__(self, parent, key, block):
        self.children: dict[bytes, _PrefixNode] = {}
        self.parent = parent
        self.key = key
        self.block = block
        self.refs = 0
        self.tick = 0


class PrefixCache:
    """The host side of the prefix pool (the JAX package's
    serving.py:427): a trie keyed on chunk-sized token blocks and a block
    allocator with LRU eviction of unreferenced leaves. A host data
    structure only (the SlotServer dispatches the device copies), so its
    reference counts and eviction are testable without a model.

    Invariants: every trie node owns exactly one pool block and free
    blocks are owned by nobody; eviction takes only a leaf with no
    references (an interior node's children are unreachable without it,
    and a referenced node's block may still be copied into an admitted
    slot). ``alloc`` returns None when every block is taken and nothing is
    evictable; the caller then inserts less.

    With ``allocator=`` (paged KV) the trie keeps no free list of its own:
    its blocks are the paged pool's, each node holds one allocator
    reference on its block, and a block is freed when its last holder (a
    node or a slot table) lets go. A block enters the trie only once
    fully written (``adopt``) and nothing writes it again, so sharing it
    needs no copy. Eviction then takes only leaves the trie alone holds
    (refcount 1): a block still in a slot's table is being read.
    ``n_blocks`` stays as a cap on the trie's size."""

    def __init__(self, n_blocks: int, chunk: int, allocator=None):
        if n_blocks < 1:
            raise ValueError(f"prefix cache needs >= 1 block, got {n_blocks}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.n_blocks = n_blocks
        self.chunk = chunk
        self.root = _PrefixNode(None, b"", -1)
        self._allocator = allocator
        self._free = ([] if allocator is not None
                      else list(range(n_blocks - 1, -1, -1)))
        self._owned: set[_PrefixNode] = set()
        self._tick = 0
        self.hits = 0           # admissions matching >= 1 chunk
        self.misses = 0         # admissions matching none
        self.evictions = 0
        self.inserted_blocks = 0

    @property
    def blocks_used(self) -> int:
        return len(self._owned)

    def _touch(self, node: _PrefixNode) -> None:
        self._tick += 1
        node.tick = self._tick

    def lookup(self, body: np.ndarray, share: int | None = None
               ) -> list[_PrefixNode]:
        """The longest cached chunk-aligned prefix of ``body`` -> its node
        path (blocks in ``node.block``). Counts a hit or a miss and touches
        the path's LRU clocks; takes no references (``acquire`` does).
        ``share`` (paged, a batch-split mesh): the path stops at a block
        outside the allocator's ``share``, which the slot cannot read."""
        node, path = self.root, []
        c = self.chunk
        for c0 in range(0, len(body) - c + 1, c):
            child = node.children.get(body[c0:c0 + c].tobytes())
            if child is None or not self._in(child.block, share):
                break
            path.append(child)
            node = child
        for n in path:
            self._touch(n)
        if path:
            self.hits += 1
        else:
            self.misses += 1
        return path

    def acquire(self, path) -> None:
        for n in path:
            n.refs += 1

    def release(self, path) -> None:
        for n in path:
            if n.refs <= 0:
                raise RuntimeError("prefix-cache reference underflow")
            n.refs -= 1

    def _in(self, block: int, share: int | None) -> bool:
        return share is None or self._allocator.share_of(block) == share

    def _evict_one(self, share: int | None = None) -> int | None:
        """Free the least recently used unreferenced leaf's block (ticks
        are unique, so the choice is deterministic). With an allocator the
        node's reference on the block passes to the caller (reuse or
        ``reclaim``), and a leaf whose block a slot table also holds is
        skipped; ``share``: a leaf whose block is in the share."""
        victim = None
        for node in self._owned:
            if node.children or node.refs > 0 or not self._in(node.block,
                                                              share):
                continue
            if (self._allocator is not None
                    and self._allocator.refs[node.block] > 1):
                continue
            if victim is None or node.tick < victim.tick:
                victim = node
        if victim is None:
            return None
        del victim.parent.children[victim.key]
        self._owned.discard(victim)
        self.evictions += 1
        return victim.block

    def alloc(self) -> int | None:
        if self._allocator is not None:
            block = self._allocator.take()
            if block is not None:
                return block
            return self._evict_one()
        if self._free:
            return self._free.pop()
        return self._evict_one()

    def reclaim(self, n: int, share: int | None = None) -> int:
        """Paged mode: give up to ``n`` blocks (of ``share``) back to the
        allocator by evicting unreferenced leaves the trie alone holds ->
        how many. An admission short of pool blocks calls it: cached
        prefixes yield to live requests."""
        if self._allocator is None:
            raise RuntimeError("reclaim needs an allocator")
        got = 0
        while got < n:
            block = self._evict_one(share)
            if block is None:
                break
            self._allocator.unref(block)
            got += 1
        return got

    def reclaimable(self, share: int | None = None) -> int:
        """How many blocks ``reclaim`` could give back now, evicting
        nothing: the nodes (of ``share``) whose whole subtree is
        unreferenced and held by the trie alone."""
        count = 0

        def free_subtree(node) -> bool:
            nonlocal count
            ok = all([free_subtree(ch) for ch in node.children.values()])
            if node is self.root:
                return False
            if (ok and node.refs == 0 and self._in(node.block, share)
                    and self._allocator.refs[node.block] <= 1):
                count += 1
                return True
            return False

        free_subtree(self.root)
        return count

    def adopt(self, body: np.ndarray, blocks: dict) -> int:
        """Paged mode's insert, with no device copy: record a slot's own
        freshly prefilled blocks in the trie. ``blocks`` maps a chunk
        index to its pool block for the full chunks the slot prefilled
        itself; each new node takes an allocator reference, so the block
        is shared by the slot's table and the trie. Existing nodes win (a
        burst-mate adopted the chunk first); the walk stops at the size
        cap or at a chunk with no block -> the nodes added."""
        if self._allocator is None:
            raise RuntimeError("adopt needs an allocator")
        node, adopted = self.root, 0
        c = self.chunk
        for c0 in range(0, len(body) - c + 1, c):
            key = body[c0:c0 + c].tobytes()
            child = node.children.get(key)
            if child is None:
                block = blocks.get(c0 // c)
                if block is None or len(self._owned) >= self.n_blocks:
                    break
                child = _PrefixNode(node, key, block)
                node.children[key] = child
                self._owned.add(child)
                self._allocator.ref(block)
                self.inserted_blocks += 1
                adopted += 1
            self._touch(child)
            node = child
        return adopted

    def insert(self, body: np.ndarray) -> list[tuple[int, _PrefixNode]]:
        """Add ``body``'s full chunks to the trie, reusing existing nodes
        (the first writer wins: a burst-mate may have made them) and
        allocating blocks for new ones -> the NEW (chunk index, node)
        pairs, whose blocks need the device copy. Each new node carries an
        insert reference the caller releases once that copy is dispatched,
        so a later insert cannot evict a block not yet filled. Stops early
        (still a valid prefix chain) when no block can be had."""
        node, created = self.root, []
        c = self.chunk
        for c0 in range(0, len(body) - c + 1, c):
            key = body[c0:c0 + c].tobytes()
            child = node.children.get(key)
            if child is None:
                block = self.alloc()
                if block is None:
                    break
                child = _PrefixNode(node, key, block)
                node.children[key] = child
                self._owned.add(child)
                child.refs = 1          # insert reference
                created.append((c0 // c, child))
                self.inserted_blocks += 1
            self._touch(child)
            node = child
        return created


def _prefix_ring(pool: PrefixPool, cache: KVCache, rows: torch.Tensor):
    """[4, T] rows (slot, block, chunk index, ring offset) -> slots,
    blocks [T] and the ring indices [T, C] of each row's logical positions
    chunk_idx*C + arange(C), mod the ring's capacity (a prefix across the
    ring's end wraps as the prefill's writes do)."""
    slots, blocks, chunk_idx, offsets = rows.unbind(0)
    c = pool.k.shape[3]
    pos = chunk_idx[:, None] * c + torch.arange(c, device=rows.device)
    return slots, blocks, (offsets[:, None] + pos) % cache.k.shape[3]


@torch.no_grad()
def _copy_prefix_blocks(pool: PrefixPool, cache: KVCache,
                        rows: torch.Tensor) -> None:
    """The hit path, in place: row t copies pool block ``blocks[t]`` into
    slot ``slots[t]``'s ring at its logical positions [chunk_idx[t]*C,
    +C) (the JAX package's serving.py:622). Data movement only: the int8
    pool's quantized values and scales are copied as they are. Rows are
    the real (slot, block) pairs only, and no two write the same (slot,
    ring index), so the index-put is deterministic."""
    slots, blocks, ring = _prefix_ring(pool, cache, rows)
    sel = (slice(None), slots[:, None], slice(None), ring)
    # the pool's [L, T, kvH, C(, D)] -> the update's [T, C, L, kvH(, D)]
    cache.k[sel] = pool.k[:, blocks].permute(1, 3, 0, 2, 4)
    cache.v[sel] = pool.v[:, blocks].permute(1, 3, 0, 2, 4)
    if pool.k_scale is not None:
        cache.k_scale[sel] = pool.k_scale[:, blocks].permute(1, 3, 0, 2)
        cache.v_scale[sel] = pool.v_scale[:, blocks].permute(1, 3, 0, 2)


@torch.no_grad()
def _insert_prefix_blocks(pool: PrefixPool, cache: KVCache,
                          rows: torch.Tensor) -> None:
    """The insert path, in place: row t copies slot ``slots[t]``'s ring at
    logical [chunk_idx[t]*C, +C) into pool block ``blocks[t]`` (the JAX
    package's serving.py:668). Dispatched right after the suffix prefill
    that wrote those positions and before any later decode block. Blocks
    are fresh allocations, unique within a call."""
    slots, blocks, ring = _prefix_ring(pool, cache, rows)
    sel = (slice(None), slots[:, None], slice(None), ring)
    # the ring's [T, C, L, kvH(, D)] -> the pool's [L, T, kvH, C(, D)]
    pool.k[:, blocks] = cache.k[sel].permute(2, 0, 3, 1, 4)
    pool.v[:, blocks] = cache.v[sel].permute(2, 0, 3, 1, 4)
    if pool.k_scale is not None:
        pool.k_scale[:, blocks] = cache.k_scale[sel].permute(2, 0, 3, 1)
        pool.v_scale[:, blocks] = cache.v_scale[sel].permute(2, 0, 3, 1)


# ------------------------------------------------------------ paged KV

class BlockAllocator:
    """The host's authority over the paged-KV pool (the JAX package's
    serving.py:1239): a free list, a refcount a block and the blocks each
    priority class holds. Host bookkeeping only (the device sees block
    tables), so its invariants are testable without a model.

    A block's refcount counts its holders: each slot table entry that
    points at it and each trie node that owns it; it is freed when the
    last one lets go. Shared blocks are never written again (a prefill
    chunk is immutable once complete, and decode writes only a slot's own
    tail blocks), so sharing is refcounting alone.

    ``class_budgets`` caps the blocks a class may hold exclusively at once
    (``alloc_for`` debits, ``credit`` returns); blocks shared through the
    trie are free to every class. A class over its budget defers at
    admission instead of starving the other tier of blocks.

    ``shares`` > 1 (a batch-split mesh, whose ranks each hold a contiguous
    share of the pool's blocks, the pad block last in the last share):
    a free list a share, and a slot's blocks come from its rank's share
    (``alloc_for(share=)``), so a rank reads and writes its slots' blocks
    without asking another rank."""

    def __init__(self, n_blocks: int, class_budgets: dict | None = None,
                 shares: int = 1):
        if n_blocks < 1:
            raise ValueError(f"paged KV pool needs >= 1 block, "
                             f"got {n_blocks}")
        self.n_blocks = n_blocks
        self.per_share = -(-(n_blocks + 1) // shares)
        # each share's list pops its lowest block first
        self._free_by = [
            list(range(min((s + 1) * self.per_share, n_blocks) - 1,
                       s * self.per_share - 1, -1)) for s in range(shares)]
        self.refs = np.zeros(n_blocks, np.int32)
        self.class_budgets: dict[str, int] = {}
        for cls, cap in (class_budgets or {}).items():
            if cls not in PRIORITY_CLASSES:
                raise ValueError(
                    f"unknown priority class {cls!r} in class_budgets "
                    f"(valid: {PRIORITY_CLASSES})")
            self.class_budgets[cls] = int(cap)
        self.class_used = {cls: 0 for cls in PRIORITY_CLASSES}
        self.peak_used = 0

    @property
    def _free(self) -> list:
        """Every free block (the shares' lists, in share order)."""
        return [b for free in self._free_by for b in free]

    @property
    def free_blocks(self) -> int:
        return sum(len(free) for free in self._free_by)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - self.free_blocks

    def share_of(self, block: int) -> int:
        return block // self.per_share

    def free_in(self, share: int) -> int:
        return len(self._free_by[share])

    def take(self) -> int | None:
        """One block debited to no class (the trie's growth), refcount 1."""
        if not self._free_by[0]:
            return None
        block = self._free_by[0].pop()
        self.refs[block] = 1
        self.peak_used = max(self.peak_used, self.used_blocks)
        return block

    def alloc_for(self, cls: str, n: int, share: int = 0) -> list | None:
        """``n`` fresh blocks (refcount 1 each) of ``share`` debited to
        class ``cls``, all or nothing: None when the share's free list or
        the class's budget is short (the caller defers the admission;
        nothing is half-admitted)."""
        budget = self.class_budgets.get(cls)
        if budget is not None and self.class_used.get(cls, 0) + n > budget:
            return None
        free = self._free_by[share]
        if len(free) < n:
            return None
        blocks = [free.pop() for _ in range(n)]
        for block in blocks:
            self.refs[block] = 1
        if cls in self.class_used:
            self.class_used[cls] += n
        self.peak_used = max(self.peak_used, self.used_blocks)
        return blocks

    def ref(self, block: int) -> None:
        if self.refs[block] < 1:
            raise RuntimeError(f"ref on free paged-KV block {block}")
        self.refs[block] += 1

    def unref(self, block: int) -> None:
        if self.refs[block] < 1:
            raise RuntimeError("paged-KV block refcount underflow")
        self.refs[block] -= 1
        if self.refs[block] == 0:
            self._free_by[self.share_of(block)].append(block)

    def credit(self, cls: str, n: int) -> None:
        """Give ``n`` exclusively held blocks back to ``cls``'s budget (the
        refcounts are separate: a credited block may live on in the
        trie)."""
        if cls in self.class_used:
            self.class_used[cls] = max(0, self.class_used[cls] - n)

    def check(self) -> None:
        """Raise unless every block is either free with refcount 0 or
        held with refcount >= 1: no orphan, no double free, no free block
        still referenced."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise RuntimeError("duplicate blocks on the free list")
        if any(self.share_of(b) != sh for sh, lst in enumerate(self._free_by)
               for b in lst):
            raise RuntimeError("a block on another share's free list")
        for block in range(self.n_blocks):
            if (block in free) != (self.refs[block] == 0) \
                    or self.refs[block] < 0:
                raise RuntimeError(
                    f"block {block}: refcount {self.refs[block]}, "
                    f"{'free' if block in free else 'allocated'}")


def _paged_rows(tables: np.ndarray, offsets: np.ndarray, kv_block: int,
                ring_ids: np.ndarray) -> tuple:
    """Host: where ring index ``ring_ids[s, j]`` of slot s lives in the
    pool -> (logical positions, blocks, rows within the block), each
    shaped like ``ring_ids``. Ring index i holds logical position
    (i - offsets[s]) mod M, which is row p % B of table entry p // B."""
    m_cap = tables.shape[1] * kv_block
    p = (ring_ids - offsets[:, None].astype(np.int64)) % m_cap
    blk = np.take_along_axis(tables.astype(np.int64), p // kv_block, axis=1)
    return p, blk, p % kv_block


def _pool_row_index(pool: PrefixPool, base: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """Flat row indices [L, *base.shape[:-1], kvH, base.shape[-1]] into a
    [L, N, kvH, R(, D)] tensor viewed as rows of D (R = ``n_rows``, the
    rows a block or a ring holds): row (l, ..., h, i) is l*N*kvH*R + h*R +
    base[..., i], where ``base`` already holds the block (or slot) term."""
    n_layers, n, kvh = pool.k.shape[:3]
    dev = base.device
    lay = torch.arange(n_layers, device=dev) * (n * kvh * n_rows)
    head = torch.arange(kvh, device=dev) * n_rows
    lead = (n_layers,) + (1,) * (base.dim() - 1) + (1, 1)
    return (lay.view(lead) + head.view(-1, 1)
            + base.unsqueeze(-2).unsqueeze(0))


@torch.no_grad()
def _gather_paged_view(pool: PrefixPool, base: torch.Tensor,
                       lens) -> KVCache:
    """The pool as a ring-ordered slot-pool view (the JAX package's
    serving.py:1343): ``base`` [S, M] int64, from the host, is
    block * kvH * B + row of the pool row that holds view index (s, i),
    slot s's logical position (i - offset_s) mod M (``_paged_rows``). The
    result is the ring engine's ``KVCache`` layout [L, S, kvH, M, D] with
    length ``lens``, made in one pass: one ``index_select`` of D-wide rows
    straight into that order (int8 scales alike), so the ring engine's
    programs run on it unchanged. Table entries at the pad block read its
    zeros, where a ring holds stale values: positions the attention mask
    weighs 0 either way. The view is transient (gather, program,
    scatter)."""
    n_layers, _, kvh, b_rows, d = pool.k.shape
    s, m = base.shape
    idx = _pool_row_index(pool, base, b_rows).reshape(-1)
    shape = (n_layers, s, kvh, m)
    k = pool.k.view(-1, d).index_select(0, idx).view(*shape, d)
    v = pool.v.view(-1, d).index_select(0, idx).view(*shape, d)
    ks = vs = None
    if pool.k_scale is not None:
        ks = pool.k_scale.view(-1).index_select(0, idx).view(shape)
        vs = pool.v_scale.view(-1).index_select(0, idx).view(shape)
    return KVCache(k=k, v=v, length=lens, k_scale=ks, v_scale=vs)


@torch.no_grad()
def _scatter_paged_rows(pool: PrefixPool, view: KVCache,
                        rows: torch.Tensor) -> None:
    """Commit a program's written view rows into the pool, in place (the
    JAX package's serving.py:1382). ``rows`` [2, T] int64, from the host,
    is the exact commit list: view row s * kvH * M + ring index, and pool
    row block * kvH * B + row. The host drops every write the reference
    diverts out of bounds (a column past the slot's ``n_valid``, a
    logical position below its floor, a pad-block target), so no index is
    out of range and no target repeats: one ``index_copy_`` a tensor,
    deterministic."""
    n_layers, s, kvh, m, d = view.k.shape
    b_rows = pool.k.shape[3]
    view_rows = PrefixPool(k=view.k, v=view.v)
    src = _pool_row_index(view_rows, rows[0], m).reshape(-1)
    dst = _pool_row_index(pool, rows[1], b_rows).reshape(-1)
    for dst_t, src_t in ((pool.k, view.k), (pool.v, view.v)):
        dst_t.view(-1, d).index_copy_(
            0, dst, src_t.view(-1, d).index_select(0, src))
    if pool.k_scale is not None:
        for dst_t, src_t in ((pool.k_scale, view.k_scale),
                             (pool.v_scale, view.v_scale)):
            dst_t.view(-1).index_copy_(0, dst, src_t.view(-1)
                                       .index_select(0, src))


@torch.no_grad()
def _commit_spec_window(pool: PrefixPool, view: KVCache, len0: torch.Tensor,
                        tables: torch.Tensor, floors: torch.Tensor,
                        width: int) -> None:
    """A paged speculative round's commit, in place: each slot's ``width``
    view rows from its length before the round, ``len0`` (a device tensor:
    the host does not know it until the round is read), into the pool.
    Speculation's rings are offset 0, so ring index == logical position p,
    which is row p % B of table entry p // B. A row past the ring, below
    the slot's floor or at the pad block is not committed: it writes zeros
    into the pad block, which stays zero (those rows may repeat; every
    committed row is a distinct row of a block its slot holds alone).
    ``tables`` [S, M/B] and ``floors`` [S] are the host's, staged with
    this round."""
    n_layers, s, kvh, m, d = view.k.shape
    b_rows = pool.k.shape[3]
    pad = pool.k.shape[1] - 1
    dev = len0.device
    p = len0[:, None].long() + torch.arange(width, device=dev)     # [S, W]
    inside = p < m
    p = torch.where(inside, p, 0)
    blk = tables.gather(1, p // b_rows)
    keep = inside & (p >= floors[:, None]) & (blk < pad)
    row = p % b_rows
    src = torch.arange(s, device=dev)[:, None] * (kvh * m) + p
    dst = torch.where(keep, blk, pad) * (kvh * b_rows) + row
    src_i = _pool_row_index(PrefixPool(k=view.k, v=view.v), src.reshape(-1),
                            m).reshape(-1)
    dst_i = _pool_row_index(pool, dst.reshape(-1), b_rows).reshape(-1)
    keep_i = keep.reshape(1, 1, -1).expand(n_layers, kvh, -1).reshape(-1)
    pairs = [(pool.k, view.k), (pool.v, view.v)]
    if pool.k_scale is not None:
        pairs += [(pool.k_scale, view.k_scale), (pool.v_scale, view.v_scale)]
    for dst_t, src_t in pairs:
        flat = src_t.reshape(-1, d) if src_t.dim() == 5 else src_t.reshape(-1)
        vals = flat.index_select(0, src_i)
        mask = keep_i if vals.dim() == 1 else keep_i[:, None]
        out = dst_t.view(-1, d) if dst_t.dim() == 5 else dst_t.view(-1)
        out.index_copy_(0, dst_i, torch.where(mask, vals,
                                              torch.zeros_like(vals)))


# ------------------------------------------------------------ KV transfer
# (the JAX package's serving.py:1436-1575). Pool blocks hold KV rows in
# logical order: position p lives at table entry p // B, row p % B,
# whatever the slot's ring offset, so a block's bytes mean the same in any
# replica. A prefill-role replica exports the blocks covering [0,
# body_len) with the request's journal entry (if the transfer dies, the
# prompt re-prefills anywhere); a decode replica writes them into blocks
# of its own pool and decodes as if it had prefilled them. The bytes are
# the JAX package's: the pool layout [L, n, kvH, B, D] (int8 scales [L,
# n, kvH, B]), C order, base64, and a sha256 over K, V, then the scales,
# with the dtypes spelled as numpy spells them.

KV_TRANSFER_VERSION = 1

# every key a /kv/import payload carries
KV_IMPORT_KEYS = (
    "version", "model", "kv_block", "kv_dtype", "body_len", "n_blocks",
    "block_shape", "dtype", "scale_dtype", "blocks_k", "blocks_v",
    "scales_k", "scales_v", "checksum", "entry",
)

# the journal fields inside payload["entry"]: the replay state minus the
# process-local deadline; "trace" is the prefill leg's TraceContext dict
KV_ENTRY_KEYS = (
    "id", "prompt", "max_new_tokens", "temperature", "top_k",
    "cache_prompt", "seed", "emitted", "model", "stop", "logprobs",
    "priority", "trace",
)

# numpy's dtype names (what the JAX package writes) <-> torch dtypes;
# numpy has no bfloat16 without ml_dtypes, so bytes decode in torch
_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int8": torch.int8}
_WIRE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def _wire_bytes(t: torch.Tensor) -> np.ndarray:
    """A host tensor's C-order bytes, as a uint8 array (no copy for a
    contiguous tensor)."""
    return t.contiguous().view(torch.uint8).numpy()


def _b64(buf) -> str:
    return base64.b64encode(buf).decode("ascii")


def _transfer_checksum(*bufs) -> str:
    h = hashlib.sha256()
    for b in bufs:
        h.update(b)
    return h.hexdigest()


@dataclass
class _KVSnapshot:
    """Pool blocks on their way to the host: [k, v] (+ [k_scale,
    v_scale]) gathered in table order and copied into pinned memory
    behind ``ready`` (None on the CPU: already there)."""
    host: list
    ready: Any = None

    def wait(self) -> list:
        if self.ready is not None:
            self.ready.synchronize()
        return self.host


def _snapshot_kv_blocks(pool: PrefixPool, ids) -> _KVSnapshot:
    """Enqueue a copy of pool blocks ``ids`` (table order) to the host,
    waiting for nothing: one ``index_select`` a tensor into a fresh
    buffer, then a non-blocking copy into pinned memory and an event.
    The caller may free and reuse the blocks at once: every later write
    to them is enqueued after this copy, so stream order runs it on the
    bytes as they are now."""
    dev = pool.k.device
    idx = _stage(np.asarray(ids, np.int64), dev)
    parts = [pool.k, pool.v]
    if pool.k_scale is not None:
        parts += [pool.k_scale, pool.v_scale]
    host = []
    for t in parts:
        g = t.index_select(1, idx)
        if dev.type == "cuda":
            h = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
            h.copy_(g, non_blocking=True)
            g = h
        host.append(g)
    return _KVSnapshot(host, _event(dev))


def _payload(host: list, *, model, kv_block, kv_dtype, body_len,
             entry) -> dict:
    """The transfer payload of host blocks [k, v(, ks, vs)]."""
    k = host[0]
    bufs = [_wire_bytes(t) for t in host]
    scaled = len(host) == 4
    return {
        "version": KV_TRANSFER_VERSION,
        "model": model,
        "kv_block": int(kv_block),
        "kv_dtype": str(kv_dtype),
        "body_len": int(body_len),
        "n_blocks": int(k.shape[1]),
        "block_shape": [int(d) for d in k.shape],
        "dtype": _WIRE_NAMES[k.dtype],
        "scale_dtype": _WIRE_NAMES[host[2].dtype] if scaled else None,
        "blocks_k": _b64(bufs[0]),
        "blocks_v": _b64(bufs[1]),
        "scales_k": _b64(bufs[2]) if scaled else None,
        "scales_v": _b64(bufs[3]) if scaled else None,
        "checksum": _transfer_checksum(*bufs),
        "entry": dict(entry),
    }


def serialize_kv_blocks(pool: PrefixPool, ids, *, model, kv_block,
                        kv_dtype, body_len, entry) -> dict:
    """Snapshot pool blocks ``ids`` (table order) into a JSON-able
    transfer payload, waiting for the copy (the JAX package's
    serving.py:1493). ``entry`` is the request's journal replay state,
    which the receiver resubmits from if the KV is unusable. The engine
    splits this in two: the copy at the prefill's end
    (``_snapshot_kv_blocks``), the encoding in ``export_blocks``."""
    return _payload(_snapshot_kv_blocks(pool, ids).wait(), model=model,
                    kv_block=kv_block, kv_dtype=kv_dtype,
                    body_len=body_len, entry=entry)


def _from_wire(raw: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    """Decoded bytes as a CPU tensor of ``shape`` (read-only memory: the
    tensor is copied before anything writes)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "buffer is not writable"
        return torch.frombuffer(raw, dtype=dtype).reshape(shape)


def deserialize_kv_blocks(payload: dict) -> tuple:
    """Decode and verify a transfer payload -> CPU tensors (k, v, k_scale,
    v_scale), the scales None for a native pool (the JAX package's
    serving.py:1533). Any damage raises ValueError: a wrong version,
    missing keys, truncated buffers, a checksum mismatch."""
    try:
        version = int(payload["version"])
        shape = tuple(int(d) for d in payload["block_shape"])
        dtype = _WIRE_DTYPES[payload["dtype"]]
        raw_k = base64.b64decode(payload["blocks_k"], validate=True)
        raw_v = base64.b64decode(payload["blocks_v"], validate=True)
        checksum = payload["checksum"]
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed KV transfer payload: {e}") from None
    if version != KV_TRANSFER_VERSION:
        raise ValueError(
            f"KV transfer version {version} != {KV_TRANSFER_VERSION}")
    if len(shape) != 5 or shape[1] != int(payload.get("n_blocks", -1)):
        raise ValueError("KV transfer block_shape/n_blocks mismatch")
    expect = int(np.prod(shape)) * dtype.itemsize
    if len(raw_k) != expect or len(raw_v) != expect:
        raise ValueError(
            f"truncated KV transfer payload: expected {expect} bytes "
            f"per buffer, got k={len(raw_k)} v={len(raw_v)}")
    bufs = [raw_k, raw_v]
    ks = vs = None
    if payload.get("scales_k") is not None:
        try:
            sdtype = _WIRE_DTYPES[payload["scale_dtype"]]
            raw_ks = base64.b64decode(payload["scales_k"], validate=True)
            raw_vs = base64.b64decode(payload["scales_v"], validate=True)
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(
                f"malformed KV transfer scales: {e}") from None
        s_expect = int(np.prod(shape[:4])) * sdtype.itemsize
        if len(raw_ks) != s_expect or len(raw_vs) != s_expect:
            raise ValueError("truncated KV transfer scale payload")
        bufs += [raw_ks, raw_vs]
        ks = _from_wire(raw_ks, sdtype, shape[:4])
        vs = _from_wire(raw_vs, sdtype, shape[:4])
    if _transfer_checksum(*bufs) != checksum:
        raise ValueError("KV transfer payload checksum mismatch")
    return (_from_wire(raw_k, dtype, shape), _from_wire(raw_v, dtype, shape),
            ks, vs)


def split_kv_heads(bufs: list, part: int, n_parts: int) -> list:
    """Slice ``part`` of ``n_parts`` of transfer buffers [k, v(, k_scale,
    v_scale)] along their kv-head axis (dim 2 of [L, n, kvH, B(, D)]): the
    heads a rank of a kv axis of ``n_parts`` holds, in the one-device
    pool's head order. Views; the whole buffers when ``n_parts`` is 1."""
    if n_parts == 1:
        return list(bufs)
    heads = bufs[0].shape[2]
    if heads % n_parts:
        raise ValueError(f"{heads} kv heads do not split over {n_parts} "
                         "ranks")
    w = heads // n_parts
    return [t.narrow(2, part * w, w) for t in bufs]


def join_kv_heads(parts: list) -> list:
    """The inverse of ``split_kv_heads``: each rank's buffers, in kv-rank
    order -> the one-device pool's buffers (every head, in order)."""
    if len(parts) == 1:
        return list(parts[0])
    return [torch.cat(ts, dim=2) for ts in zip(*parts)]


@dataclass
class _Export:
    """A prefilled request's payload on its way out: its metadata, the
    rank parts (kv-rank -> ``_KVSnapshot``) that have arrived, and how
    many make the whole."""
    meta: dict
    parts: dict
    n_parts: int


@dataclass
class _KVImport:
    """A payload decoded, verified against an engine and staged in host
    memory (pinned on the card), ready for ``import_blocks`` to install
    under the serving lock without touching its bytes again."""
    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor | None
    vs: torch.Tensor | None
    entry: dict
    prompt: list
    max_new: int
    emitted: list
    n_blocks: int


# ------------------------------------------------------------------ server

class SlotServer:
    """Continuous-batching server: S cache slots, requests admitted into
    freed slots while other slots keep decoding (the JAX package's
    models/serving.py:1603, the ring engine on one device).

    >>> srv = SlotServer(params, cfg, slots=8, max_len=2048)
    >>> srv.submit(Request(prompt=[1, 5, 7], max_new_tokens=64))
    >>> done = srv.run_until_drained()          # {id: Completion}

    For a live service, call ``submit()`` from the request handler and
    ``step()`` on the serving loop; ``drain_completed()`` hands back
    finished requests. The server ``temperature`` and ``top_k`` are the
    defaults a request's own override (sampling is per row, so greedy and
    sampled requests share one pool).

    ``params`` may be raw parameters or a ``prepare_decode`` result, on
    ``device`` (None means the card; the CPU only when named).
    ``batched_admission`` (default True) admits a burst of freed slots
    with one prefill call per chunk round instead of one per chunk per
    slot; completions are the same either way.
    ``max_queue=N`` bounds the wait queue (0 = unbounded): ``submit``
    raises ``QueueFullError`` past it (batch-tier requests past
    ``batch_queue_frac`` of it). ``cancel(request_id)`` stops a request
    wherever it is. ``reset()`` re-arms every serving buffer (the prefix
    pool and trie included) after a loop failure, without touching the
    weights: queued requests survive, and the admitted ones replay from
    the journal (module docstring). ``journal`` is a ``RequestJournal``
    (None: an in-memory one); ``replay=False`` turns the journal off and
    ``reset()`` returns the admitted ids as lost, for the caller to fail.

    ``prefix_cache_blocks=N`` enables the chunk-aligned prefix cache
    (module docstring): N ``prefill_chunk``-sized blocks in a device pool
    (N x layers x kvH x chunk x head_dim x the KV dtype's bytes, twice for
    K and V). ``cache_prompts`` is the default for inserting admitted
    prompts' chunks into it; ``Request.cache_prompt`` overrides it per
    request. ``stats()["prefix_cache"]`` reports its counters.

    ``paged=True`` swaps the slots x max_len ring for one pool of
    ``kv_block``-row blocks (default: ``block_size`` rows) and a block
    table a slot (module docstring): ``kv_pool_blocks`` blocks (default:
    the ring's bytes, slots x max_len / kv_block) plus the pad block.
    ``max_len`` and ``prefill_chunk`` must be multiples of ``kv_block``.
    Admission is gated on free pool blocks; ``class_budgets`` (a priority
    class -> the blocks it may hold exclusively) and ``prefill_interleave``
    (prompt tokens prefilled a decode block, 0 = whole prompts at
    admission) need ``paged``. With the prefix cache on, the trie shares
    the pool's blocks (``prefix_cache_blocks`` caps its nodes, each
    ``kv_block`` tokens). ``stats()["paged_kv"]`` reports the pool.

    ``trace_sink`` (a callable) gets every sealed trace's dict (``serve
    --trace-dir`` passes ``events.trace.TraceWriter.write``);
    ``telemetry`` holds the latency histograms (``stats()["latency"]``),
    which ``reset()`` keeps; ``dispatch_tracker`` the device time
    (``stats()["device"]``; its thread stops at ``shutdown()``).

    ``role`` is ``"both"`` (default), ``"prefill"`` (needs ``paged``: each
    request ends ``"prefilled"`` once its prompt is in the pool, and
    ``export_blocks(id)`` pops its transfer payload, kept for the newest
    64) or ``"decode"`` (advisory, as ``"both"``; the router sends it the
    payloads). ``import_blocks(payload)`` resumes another replica's
    prefilled request here."""

    def __init__(self, params=None, cfg: TransformerConfig | None = None, *,
                 slots: int = 8,
                 max_len: int = 2048, block_size: int = 16,
                 prefill_chunk: int = 128, kv_dtype: str = "native",
                 weight_dtype: str = "native", temperature: float = 0.0,
                 top_k: int = 0, stop_tokens: tuple = (), pad_id: int = 0,
                 seed: int = 0, pipeline_depth: int = 2,
                 batched_admission: bool = True,
                 prefix_cache_blocks: int = 0, cache_prompts: bool = True,
                 max_queue: int = 0, batch_queue_frac: float = 0.5,
                 model: str = "default", journal: RequestJournal | None = None,
                 replay: bool = True, paged: bool = False, kv_block: int = 0,
                 kv_pool_blocks: int = 0, class_budgets: dict | None = None,
                 prefill_interleave: int = 0, trace_sink=None,
                 role: str = "both", registry: ModelRegistry | None = None,
                 draft=None, draft_cfg: TransformerConfig | None = None,
                 spec_gamma: int = 0, spec_gamma_max: int = 4, device=None,
                 mesh=None, rules=None):
        # the model registry (models/registry.py): this server serves one
        # named entry (its slot pool has that entry's shapes), and a
        # speculative pair is two entries. A (params, cfg) pair is
        # registered under ``model``, so every server has a registry.
        if registry is not None:
            self.registry = registry
            # the default name means "the registry's first entry"; any
            # other unregistered name raises, naming the entries
            if model in registry or model != "default":
                entry = registry.get(model)
            else:
                entry = registry.default
            self.model = entry.name
            params, cfg = entry.weights, entry.cfg
            if draft is None and entry.draft is not None:
                draft = entry.draft
        else:
            if params is None or cfg is None:
                raise ValueError(
                    "SlotServer needs (params, cfg) or registry=/model=")
            self.registry = ModelRegistry()
            self.registry.register(str(model), params, cfg)
            self.model = str(model)
        if not cfg.causal:
            raise ValueError("serving requires a causal model")
        self.device = resolve_device(device)
        if isinstance(params, DecodeWeights):
            if params.mesh is not None:
                if mesh is not None and mesh != params.mesh:
                    raise ValueError(
                        "mesh mismatch: the prepared weights were built for "
                        "a different mesh than the SlotServer's")
                mesh = params.mesh
                if rules is None:
                    rules = params.rules
            elif mesh is not None:
                raise ValueError(
                    "prepared weights were built without a mesh but the "
                    "SlotServer got one — rebuild with "
                    "prepare_decode(..., mesh=...)")
            prepared = params
            weight_dtype = params.weight_dtype
        else:
            prepared = prepare_decode(params, cfg, weight_dtype=weight_dtype,
                                      mesh=mesh, rules=rules)
            rules = prepared.rules
        if prepared.params["embed"].device.type != self.device.type:
            raise ValueError(
                f"the weights are on {prepared.params['embed'].device}, the "
                f"server on {self.device}")
        self._params, self._fused = prepared.params, prepared.fused
        self.cfg = moe_dropfree(cfg)
        self._init_mesh(mesh, rules, slots)
        self._init_draft(draft, draft_cfg, weight_dtype, temperature)
        self.slots = slots
        self.max_len = max_len
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        self.temperature = temperature
        self.top_k = top_k
        self.stop_tokens = tuple(int(t) for t in stop_tokens)
        self.pad_id = int(pad_id)
        self.pipeline_depth = pipeline_depth
        self.batched_admission = batched_admission
        self.max_queue = int(max_queue)
        self.batch_queue_frac = float(batch_queue_frac)
        self._paged = bool(paged)
        self.kv_block = int(kv_block or 0)
        self.kv_pool_blocks = int(kv_pool_blocks or 0)
        self.prefill_interleave = max(0, int(prefill_interleave))
        self._class_budgets = dict(class_budgets or {})
        if self._paged:
            if not self.kv_block:
                self.kv_block = int(block_size)
            if max_len % self.kv_block:
                raise ValueError(
                    f"max_len={max_len} must be a multiple of "
                    f"kv_block={self.kv_block} (a slot's table has "
                    f"max_len/kv_block entries)")
            if prefill_chunk % self.kv_block:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} must be a multiple of "
                    f"kv_block={self.kv_block} (chunk boundaries land on "
                    f"block boundaries, so the trie adopts whole blocks)")
            if not self.kv_pool_blocks:
                # the ring's device bytes
                self.kv_pool_blocks = slots * (max_len // self.kv_block)
            if self._shard is not None:
                # the block axis splits over the batch axes as the slots
                # do: round up so the blocks and the pad block divide (a
                # default pool then holds every rank's slots in its share)
                t_b = self._shard.n
                self.kv_pool_blocks = -(-(self.kv_pool_blocks + 1)
                                        // t_b) * t_b - 1
        elif self.prefill_interleave:
            raise ValueError("prefill_interleave requires paged=True (the "
                             "ring engine prefills whole admissions)")
        elif self._class_budgets:
            raise ValueError("class_budgets requires paged=True (budgets "
                             "count pool blocks)")
        self.role = str(role or "both")
        if self.role not in ("prefill", "decode", "both"):
            raise ValueError(f"unknown serving role {role!r} (expected "
                             "'prefill', 'decode' or 'both')")
        if self.role == "prefill" and not self._paged:
            raise ValueError("role='prefill' requires paged=True (the "
                             "transfer unit is the paged KV block)")
        if self.role == "prefill" and self._spec:
            raise ValueError(
                "role='prefill' is incompatible with speculative serving (a "
                "prefill replica never decodes, so a draft has nothing to "
                "propose against)")
        # a prefill role's finished payloads awaiting pickup, oldest
        # evicted first (an unclaimed one costs the decode side a
        # re-prefill, never a request); the stash and the counters are
        # shared with the HTTP threads that export and import, and a
        # waiting export is woken when a follower's part arrives. A mesh
        # follower keeps only its own parts until they travel
        self._exports: collections.OrderedDict[int, _Export] = \
            collections.OrderedDict()
        self._exports_cap = 64
        self._parts_out: collections.OrderedDict[int, tuple] = \
            collections.OrderedDict()
        self._transfer_lock = threading.Condition()
        self.kv_exports = 0             # payloads snapshot
        self.kv_imports = 0             # payloads installed
        self.kv_import_rejects = 0      # damaged or unfit payloads refused
        self._seed = int(seed)          # journaled with every request
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # built once: a tensor made from a list on the card waits for it
        self._stop_arr = (torch.tensor(self.stop_tokens, dtype=torch.int32,
                                       device=self.device)
                          if self.stop_tokens else None)
        # without stop tokens every completion is deterministic, so the
        # host schedules open-loop from an exact model of the slots. A
        # speculative round advances each slot by an accepted count only
        # its packed result shows, so speculation runs the EOS mode's
        # pipelined reads
        self._predictive = not self.stop_tokens and not self._spec
        # the speculative window: pinned by spec_gamma, else autotuned
        # from each slot's acceptance EWMA (_current_gamma)
        self._spec_gamma_pin = max(0, int(spec_gamma))
        self.spec_gamma_max = max(1, int(spec_gamma_max))
        if self._spec_gamma_pin:
            self.spec_gamma_max = max(self.spec_gamma_max,
                                      self._spec_gamma_pin)
        self._spec_ewma_alpha = 0.2
        self._accept_ewma = np.full((slots,), 0.6, np.float64)
        self.spec_rounds = 0            # verify rounds dispatched
        self.spec_proposed_tokens = 0   # proposals verified (processed)
        self.spec_accepted_tokens = 0   # ... that the target accepted
        self.draft_prefill_tokens_reused = 0    # draft prefill skipped by
        #                                         prefix hits
        self.spec_accept_hist = Histogram(lo=0.01, hi=1.0)
        self.spec_rounds_hist = Histogram(lo=1.0, hi=512.0, per_decade=4)
        self.admission_dispatches = 0   # prefill calls
        self.prefill_tokens_computed = 0
        self.prefill_tokens_reused = 0  # copied from the prefix pool
        self.prefix_copy_dispatches = 0
        self.prefix_insert_dispatches = 0
        self.blocks_dispatched = 0
        self.shed_requests = 0
        self.shed_by_class = {cls: 0 for cls in PRIORITY_CLASSES}
        self.cancelled_requests = 0
        self.expired_requests = 0
        self.resets = 0
        self.admission_defers = 0       # paged: short of blocks or budget
        self.paged_gather_dispatches = 0
        self.paged_scatter_dispatches = 0
        self.prefill_chunks_interleaved = 0     # pumps cut by the interleave
        # request durability: the journal records every accepted request's
        # replay state, and reset() replays the journaled in-flight ones
        self.replay = bool(replay)
        self._journal = (journal if journal is not None
                         else (RequestJournal() if self.replay else None))
        self.replays = 0                # admissions with a resume prefix
        self.replayed_tokens = 0        # teacher-forced resume tokens
        # per-request token streams (api.stream.TokenStream), fed at every
        # processed block; they outlive reset(): a replayed request keeps
        # its stream
        self._streams: dict[int, Any] = {}
        self.streams_opened = 0         # streams ever attached
        self.stream_stalls = 0          # feeds that found a stream's queue
        #                                 full (coalesced, never dropped)
        # chaos hooks, read once at construction (a bad value is "off");
        # their own generator, never the one sampling draws from
        self._chaos_fail_rate = self._env_float(
            c.TEST_SERVING_DISPATCH_FAIL_RATE)
        self._chaos_delay_ms = self._env_float(c.TEST_SERVING_STEP_DELAY_MS)
        self._chaos_rng = random.Random(
            int(self._env_float(c.TEST_SERVING_CHAOS_SEED)))
        self.chaos_faults_injected = 0
        self._chaos_crash_blocks: set[int] = set()
        raw = os.environ.get(c.TEST_SERVING_CRASH_AT_BLOCKS, "")
        if raw:
            try:
                self._chaos_crash_blocks = {
                    int(x) for x in raw.replace(",", " ").split()}
            except ValueError:
                log.error("bad %s value %r; ignoring",
                          c.TEST_SERVING_CRASH_AT_BLOCKS, raw)
        self._chaos_sigkill_block = int(
            self._env_float(c.TEST_SERVING_SIGKILL_AT_BLOCK))
        # host time to dispatch each decode block (the device runs later)
        self.block_dispatch_s: collections.deque = collections.deque(
            maxlen=4096)
        # request telemetry (module docstring): live traces by request id,
        # sealed at their terminal; all of it host bookkeeping
        self.telemetry = ServingTelemetry()
        self.trace_sink = trace_sink
        self._traces: dict[int, RequestTrace] = {}
        self._rate = ServiceRateEstimator()
        # device time (module docstring): each dispatch's fence, waited on
        # by the tracker's thread; reset() re-arms it, shutdown() stops it
        self.dispatch_tracker = DispatchTracker()
        # ServeApp.shutdown(drain=True) parks admission
        self.pause_admission = False
        # a mesh's ranks in lockstep (parallel/lockstep.py): the turn's
        # instant every rank decides deadlines by (None: this host's
        # clock), and the chaos hooks' mid-decode crash raised at the end
        # of the step instead of inside it
        self.turn_now: float | None = None
        self.defer_faults = False
        self._pending_fault: Exception | None = None
        self._init_device_state()
        # the chunk-aligned prefix cache (module docstring); a request id ->
        # its matched trie path, referenced until its completion is
        # processed
        self.cache_prompts = bool(cache_prompts)
        self._prefix_blocks = int(prefix_cache_blocks)
        if self._shard is not None and self._prefix_blocks:
            # whole shards of the block axis
            t_b = self._shard.n
            self._prefix_blocks = -(-self._prefix_blocks // t_b) * t_b
        self._prefix_cache: PrefixCache | None = None
        self._pool: PrefixPool | None = None
        self._draft_pool: PrefixPool | None = None
        self._prefix_refs: dict[int, list] = {}
        if self._paged:
            self._init_paged_state()
        elif self._prefix_blocks > 0:
            self._init_prefix_pool()
        self._init_host_state()
        self._queue: collections.deque[Request] = collections.deque()
        self._done: dict[int, Completion] = {}

    def _init_mesh(self, mesh, rules, slots: int) -> None:
        """The mesh's plan on this rank (the JAX package's
        serving.py:1766-1780): the head counts divide their axes, the
        slots the batch axes; a batch-split rank holds ``_shard``'s
        slots."""
        self._mesh, self._rules = mesh, rules
        self._plan = self._shard = None
        self._n_kv = None               # this rank's kv heads
        # the KV transfer's view of the rank: which slice of the kv heads
        # its pools hold (of how many), whether it sends that slice of an
        # export (one rank a slice: every coordinate off the batch and kv
        # axes 0) and whether it is rank 0, which assembles the payload
        self._kv_part, self._kv_parts = 0, 1
        self._kv_sender = self._front = True
        if mesh is None:
            return
        _validate_decode_mesh(self.cfg, mesh, rules)
        t_b = rule_size(mesh, rules, "batch")
        if slots % t_b:
            raise ValueError(
                f"mesh-sharded serving: slots={slots} is not divisible by "
                f"the 'batch' mesh axes (size {t_b}) — the slot pool is the "
                "batch dimension of every decode block")
        self._plan = plan = transformer._plan(mesh, rules, self.cfg)
        self._n_kv = self.cfg.n_kv_heads // rule_size(mesh, rules, "kv")
        if t_b > 1:
            self._shard = _BatchShard(self._plan, slots)
        kv_axis = plan.tp["kv"]
        if kv_axis is not None:
            self._kv_part = plan.coord[kv_axis]
            self._kv_parts = plan.shape[kv_axis]
        self._kv_sender = all(
            c_ == 0 for a, c_ in plan.coord.items()
            if a not in plan.batch_axes and a != kv_axis)
        self._front = all(c_ == 0 for c_ in plan.coord.values())

    @property
    def _slot_range(self):
        """(first, count) of this rank's slots on a batch-split mesh."""
        return None if self._shard is None else (self._shard.lo,
                                                  self._shard.s_n)

    def _init_draft(self, draft, draft_cfg, weight_dtype: str,
                    temperature: float) -> None:
        """Speculative serving (the JAX package's serving.py:1781-1836):
        ``draft`` is a registry entry's name, or weights (raw or
        ``DecodeWeights``) with ``draft_cfg``, registered as "draft".
        Greedy only (the acceptance rule is the greedy match), native
        weights (the verify forward runs the prefill's numerics, which a
        w8a16 decode path would not match), one vocabulary, a causal
        draft."""
        self._spec = False
        self.draft_model: str | None = None
        self._draft_params = self._draft_cfg = None
        if draft is None:
            return
        if isinstance(draft, str):
            dentry = self.registry.get(draft)
            draft_w, draft_cfg = dentry.weights, dentry.cfg
            self.draft_model = dentry.name
        else:
            if draft_cfg is None:
                raise ValueError("draft weights need draft_cfg (or pass a "
                                 "registry entry name)")
            draft_w = draft
            self.draft_model = "draft"
            self.registry.register(self.draft_model, draft, draft_cfg,
                                   source="inline")
        self.registry.get(self.model).draft = self.draft_model
        if isinstance(draft_w, DecodeWeights):
            if draft_w.mesh is not None:
                raise ValueError("speculative serving is single-device; "
                                 "prepare the draft without a mesh")
            draft_w = draft_w.params
        if self._mesh is not None:
            raise ValueError(
                "speculative serving is single-device (the per-row-position "
                "propose/verify programs are not mesh-threaded); serve the "
                "draft pair without a mesh")
        if weight_dtype != "native":
            raise ValueError(
                "speculative serving requires weight_dtype='native': the "
                "verify forward runs the prefill's numerics, which a w8a16 "
                "decode path would not match")
        if temperature != 0.0:
            raise ValueError(
                "speculative serving is greedy-only (temperature 0): the "
                "greedy-match acceptance rule has no sampled counterpart")
        if draft_cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft and target must share a vocabulary "
                f"({draft_cfg.vocab_size} != {self.cfg.vocab_size})")
        if not draft_cfg.causal:
            raise ValueError("speculative decode requires a causal draft")
        if draft_w["embed"].device.type != self.device.type:
            raise ValueError(f"the draft's weights are on "
                             f"{draft_w['embed'].device}, the server on "
                             f"{self.device}")
        self._draft_cfg = moe_dropfree(draft_cfg)
        self._draft_params = _cast_decode_params(draft_w, self._draft_cfg)
        self._spec = True

    @staticmethod
    def _env_float(name: str) -> float:
        """A chaos knob's value; a bad one degrades to 0 (off)."""
        raw = os.environ.get(name, "")
        if not raw:
            return 0.0
        try:
            return float(raw)
        except ValueError:
            log.error("bad %s value %r; ignoring", name, raw)
            return 0.0

    def _init_device_state(self) -> None:
        """(Re)create the slot pool's cache and per-slot state as fresh
        tensors (weights untouched). Called at construction and by
        ``reset()``. Paged mode allocates no ring: only the [S] lengths,
        which each dispatch's view carries (the pool is
        ``_init_paged_state``'s)."""
        s, dev = self.slots, self.device
        if self._shard is not None:
            s = self._shard.s_n             # this rank's slots
        lens = torch.zeros(s, dtype=torch.int32, device=dev)
        if self._paged:
            self._cache = None
            self._d_lens = lens
        else:
            cache = init_cache(self.cfg, s, self.max_len, self.kv_dtype, dev,
                               self._n_kv)
            self._cache = dataclasses.replace(cache, length=lens)
        # speculative serving: the draft mirrors the slot pool with its own
        # cache (its config's shapes), at the target's per-row lengths:
        # admission prefills both, every round moves both to the same
        # lengths. The paged engine keeps the draft's K/V in a mirror pool
        # (_init_paged_state) and only its lengths here.
        self._draft_cache = None
        if self._spec:
            dlens = torch.zeros(s, dtype=torch.int32, device=dev)
            if self._paged:
                self._d_draft_lens = dlens
            else:
                dcache = init_cache(self._draft_cfg, s, self.max_len,
                                    self.kv_dtype, dev)
                self._draft_cache = dataclasses.replace(dcache, length=dlens)
        zeros = dict(dtype=torch.int32, device=dev)
        self._state = _SlotState(
            tokens=torch.zeros(s, **zeros),
            active=torch.zeros(s, dtype=torch.bool, device=dev),
            target=torch.zeros(s, **zeros),
            offsets=torch.zeros(s, **zeros),
            temps=torch.zeros(s, dtype=torch.float32, device=dev),
            topks=torch.zeros(s, **zeros))

    @property
    def _batch_split(self) -> int:
        return 1 if self._shard is None else self._shard.n

    def _share(self, slot: int) -> int:
        """The paged pool's share ``slot``'s blocks come from: its batch
        rank on a batch-split mesh, else 0 (the whole pool)."""
        return 0 if self._shard is None else slot // self._shard.s_n

    def _init_prefix_pool(self) -> None:
        """(Re)create the prefix pool's device blocks and an empty trie."""
        self._pool = init_prefix_pool(
            self.cfg, self._prefix_blocks // self._batch_split,
            self.prefill_chunk, self.kv_dtype, self.device, self._n_kv)
        self._prefix_cache = PrefixCache(self._prefix_blocks,
                                         self.prefill_chunk)
        # speculative serving: the draft's K/V rides the same trie, each
        # node's block id indexing a target-pool block and a draft-pool
        # block, so a hit seeds both caches and the draft prefills only
        # the suffix too
        self._draft_pool = (
            init_prefix_pool(self._draft_cfg, self._prefix_blocks,
                             self.prefill_chunk, self.kv_dtype, self.device)
            if self._spec else None)

    def _init_paged_state(self) -> None:
        """(Re)create the paged pool (``kv_pool_blocks`` blocks and the pad
        block, the last, which unmapped table entries point at and which
        stays zero), its allocator, the slots' tables, offsets and floors,
        and the trie on the allocator."""
        n = self.kv_pool_blocks
        self._kv_pool = init_prefix_pool(
            self.cfg, (n + 1) // self._batch_split, self.kv_block,
            self.kv_dtype, self.device, self._n_kv)
        # speculative serving: the draft's K/V in a mirror pool of the same
        # block geometry: one allocator owns both, a slot's table indexes
        # both, and a trie node's block is valid in both
        self._draft_kv_pool = (
            init_prefix_pool(self._draft_cfg, n + 1, self.kv_block,
                             self.kv_dtype, self.device)
            if self._spec else None)
        self._allocator = BlockAllocator(n, self._class_budgets,
                                         shares=self._batch_split)
        self._np_tables = np.full(
            (self.slots, self.max_len // self.kv_block), n, np.int32)
        # host mirrors of the ring offsets, and each slot's floor: the
        # lowest logical position a scatter may commit for it. max_len
        # (never) while the slot is idle or mid-prefill, the body's length
        # once active: the decode program writes rows for every slot, and
        # an inactive one's must never reach a block the trie may share
        self._np_offs = np.zeros((self.slots,), np.int32)
        self._np_floor = np.full((self.slots,), self.max_len, np.int32)
        # a slot's blocks: its own (refcount-1 holders unless the trie
        # adopted them) and the trie's it maps (prefix hits)
        self._slot_blocks: list[list] = [[] for _ in range(self.slots)]
        self._slot_shared: list[list] = [[] for _ in range(self.slots)]
        self._slot_class = ["interactive"] * self.slots
        # admitted requests whose prefill is unfinished: [admission, index
        # of the next chunk], drained by _pump_prefill
        self._pending_prefill: collections.deque = collections.deque()
        if self._prefix_blocks > 0:
            self._prefix_cache = PrefixCache(self._prefix_blocks,
                                             self.kv_block,
                                             allocator=self._allocator)

    def _init_host_state(self) -> None:
        """(Re)zero the host-side scheduling state: sampling mirrors, the
        exact model, the processing expectations, slot ownership and the
        in-flight pipeline. The request queue is not touched."""
        slots = self.slots
        # host mirrors of the admitted temps/top-ks/logprobs: they pick the
        # argmax-only, static-k and logprob-free block variants
        self._np_temps = np.zeros((slots,), np.float32)
        self._np_topks = np.full((slots,), self.top_k, np.int32)
        self._np_lp = np.zeros((slots,), np.int32)
        self._cursor = 0        # host-tracked, advances block per dispatch
        # exact host model of the slots as of the NEWEST dispatched block
        # (exact only in predictive mode)
        self._model_len = np.zeros((slots,), np.int32)
        self._model_active = np.zeros((slots,), bool)
        self._model_target = np.zeros((slots,), np.int32)
        # the device state after the newest PROCESSED block
        self._expect_len = np.zeros((slots,), np.int32)
        self._expect_active = np.zeros((slots,), bool)
        # busy from admission until the completion is processed
        self._host_busy = np.zeros((slots,), bool)
        # dispatched-but-unprocessed blocks: packed results + the
        # admissions/cancellations dispatched after each
        self._pipeline: collections.deque = collections.deque()
        # processing-side slot ownership, replayed in dispatch order
        self._requests: list[Request | None] = [None] * slots
        self._emitted: list[list[int]] = [[] for _ in range(slots)]
        self._lp_acc: list[list] = [[] for _ in range(slots)]
        # slots completed by a per-request stop match whose deactivation
        # no processed block shows yet
        self._stop_cancelled: set[int] = set()
        # dispatch side: which slot serves a request id now, and every
        # admitted id whose completion is not delivered
        self._slot_of: dict[int, int] = {}
        self._inflight: set[int] = set()
        # per-request speculative tallies (verify rounds, accepted tokens),
        # zeroed at each admission, read at the completion into
        # spec_rounds_hist and the trace's attrs
        self._spec_round_counts = np.zeros((slots,), np.int64)
        self._spec_accepted_counts = np.zeros((slots,), np.int64)

    # ------------------------------------------------------------- intake

    def submit(self, request: Request) -> int:
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"request needs {prompt.size} prompt + "
                f"{request.max_new_tokens} new tokens but slots hold "
                f"max_len={self.max_len}")
        # an id outside the embedding would fault on the card
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f"prompt token ids must be in [0, "
                             f"{self.cfg.vocab_size})")
        if self._spec and request.temperature is not None \
                and float(request.temperature) > 0:
            raise ValueError(
                "speculative serving is greedy-only: a per-request "
                "temperature above 0 is refused (the greedy-match "
                "acceptance rule has no sampled counterpart)")
        if request.model is not None and request.model != self.model:
            raise ValueError(
                f"request names model {request.model!r} but this engine "
                f"serves {self.model!r}")
        if request.stop is not None:
            request.stop = _normalize_stop(request.stop)
        request.logprobs = int(request.logprobs or 0)
        if not 0 <= request.logprobs <= LOGPROBS_MAX:
            raise ValueError(f"logprobs must be in [0, {LOGPROBS_MAX}]")
        if request.logprobs and self._spec:
            raise ValueError(
                "logprobs are unavailable under speculative serving "
                "(rejected drafts have no per-token logits rows)")
        resume = request.resume_tokens
        if resume is not None:
            arr = np.asarray(resume, np.int32).reshape(-1)
            # the prefix is prefilled: an id outside the embedding faults
            if arr.size and (arr.min() < 0
                             or arr.max() >= self.cfg.vocab_size):
                raise ValueError(f"resume_tokens must be in [0, "
                                 f"{self.cfg.vocab_size})")
            resume = [int(t) for t in arr]
            request.resume_tokens = resume
        tr = RequestTrace(request.id)
        tr.mark("submitted")
        # bound before any early exit: a shed or resume-satisfied request
        # stays in its originating trace too
        ctx = (request.trace if isinstance(request.trace, TraceContext)
               else TraceContext.from_dict(request.trace))
        if ctx is not None:
            tr.bind(ctx)
            tr.attrs["service"] = "serve"
        if resume:
            tr.attrs["resume_tokens"] = len(resume)
            self._traces[request.id] = tr
            if self._deliver_if_satisfied(request.id, resume,
                                          request.max_new_tokens,
                                          request.stop):
                return request.id
            del self._traces[request.id]
        cls = str(request.priority or "interactive")
        if cls not in PRIORITY_CLASSES:
            raise ValueError(f"unknown priority {request.priority!r} "
                             f"(valid: {PRIORITY_CLASSES})")
        request.priority = cls
        if self.max_queue:
            # the batch tier backs off at a lower threshold, so overload
            # sheds throughput work first
            limit = self.max_queue
            if cls != "interactive":
                limit = max(1, int(self.max_queue * self.batch_queue_frac))
            if len(self._queue) >= limit:
                self._sweep_expired()
                if len(self._queue) >= limit and cls == "interactive":
                    self._shed_queued_batch()
                if len(self._queue) >= limit:
                    self.shed_requests += 1
                    self.shed_by_class[cls] += 1
                    # a shed request leaves a two-span trace
                    self._seal_trace(tr, "shed")
                    err = QueueFullError(
                        f"queue full ({limit} {cls} waiting); request shed")
                    # the estimate rides the error: the 429 handler needs
                    # no second trip through the serving lock
                    err.retry_after_s = self.estimate_retry_after()
                    err.priority = cls
                    raise err
        request.prompt = prompt
        self._traces[request.id] = tr
        if self._journal is not None:
            # the entry's prompt is the original one; a resume prefix
            # pre-seeds its emitted record, so a second failure replays
            # from the whole known prefix
            self._journal.submit(
                request.id, prompt.tolist(), request.max_new_tokens,
                temperature=request.temperature, top_k=request.top_k,
                cache_prompt=request.cache_prompt, seed=self._seed,
                deadline=request.deadline, emitted=resume, model=self.model,
                stop=[list(q) for q in request.stop] if request.stop
                else None,
                logprobs=request.logprobs, priority=request.priority,
                trace=ctx.as_dict() if ctx is not None else None)
        self._queue.append(request)
        return request.id

    def _deliver_if_satisfied(self, rid: int, tokens: list, max_new: int,
                              stop) -> bool:
        """Deliver a request whose resumed or journaled prefix already
        finishes it (budget reached, a stop token at its end, a completed
        stop sequence), without a slot, a prefill or a decode step ->
        whether it did."""
        stop_end = bool(self.stop_tokens) and bool(tokens) and \
            tokens[-1] in self.stop_tokens
        seq_end = _stop_match_end(tokens, stop) if stop else None
        if not (len(tokens) >= max_new or stop_end or seq_end is not None):
            return False
        if seq_end is not None and seq_end <= max_new:
            tokens = tokens[:seq_end]
            stop_end = True
        toks = list(tokens[:max_new])
        stopped = stop_end and toks and (
            seq_end is not None or toks[-1] in self.stop_tokens)
        self.replays += 1
        self.replayed_tokens += len(toks)
        reason = "stop" if stopped else "length"
        self._done[rid] = Completion(
            rid, toks, reason,
            trace=self._finish_trace(rid, "finished", n_tokens=len(toks),
                                     reason=reason))
        self._finish_stream(rid)
        self.seal_journal(rid)
        return True

    def _shed_queued_batch(self) -> bool:
        """Displace the YOUNGEST queued batch-tier request to make room
        for an interactive arrival: it completes "shed" with no tokens."""
        for i in range(len(self._queue) - 1, -1, -1):
            req = self._queue[i]
            if req.priority == "interactive":
                continue
            del self._queue[i]
            self.shed_requests += 1
            self.shed_by_class[req.priority] += 1
            self._done[req.id] = Completion(
                req.id, [], "shed", trace=self._finish_trace(req.id, "shed"))
            self._finish_stream(req.id)
            self.seal_journal(req.id)
            return True
        return False

    def _sweep_expired(self) -> None:
        """Queued requests past their deadline complete "expired" and
        never take a slot."""
        now = time.monotonic() if self.turn_now is None else self.turn_now
        if not any(r.deadline is not None and now > r.deadline
                   for r in self._queue):
            return
        kept: collections.deque[Request] = collections.deque()
        for req in self._queue:
            if req.deadline is not None and now > req.deadline:
                self.expired_requests += 1
                # a queued replay keeps its emitted prefix: delivered
                # decode work, not queue residue
                out = list(req.resume_tokens or ())
                self._done[req.id] = Completion(
                    req.id, out, "expired",
                    trace=self._finish_trace(req.id, "expired",
                                             n_tokens=len(out)))
                self._finish_stream(req.id)
                self.seal_journal(req.id)
            else:
                kept.append(req)
        self._queue = kept

    def cancel(self, request_id: int) -> bool:
        """Stop a request wherever it is. Queued: dequeued. Admitted: the
        slot's device-side active flag drops between blocks, and the
        cancellation is logged against the newest in-flight block so the
        bookkeeping emits Completion(finish_reason="cancelled") with the
        tokens produced before it. False when the request is unknown or
        already finished. In EOS mode a True can race a natural
        completion; the delivered finish_reason is authoritative."""
        for i, req in enumerate(self._queue):
            if req.id == request_id:
                del self._queue[i]
                self.cancelled_requests += 1
                # a queued replay keeps its emitted prefix
                out = list(req.resume_tokens or ())
                self._done[request_id] = Completion(
                    request_id, out, "cancelled",
                    trace=self._finish_trace(request_id, "cancelled",
                                             n_tokens=len(out)))
                self._finish_stream(request_id)
                self.seal_journal(request_id)
                return True
        if self._paged:
            # mid-prefill (interleaved): the request holds a slot and
            # blocks but decodes nothing yet; its pending chunks go and its
            # blocks free at once
            for i, (adm, _) in enumerate(self._pending_prefill):
                if adm.req.id != request_id:
                    continue
                del self._pending_prefill[i]
                self.cancelled_requests += 1
                self._host_busy[adm.slot] = False
                out = list(adm.req.resume_tokens or ())
                self._done[request_id] = Completion(
                    request_id, out, "cancelled",
                    trace=self._finish_trace(request_id, "cancelled",
                                             n_tokens=len(out)))
                self._finish_stream(request_id)
                self._release_request(request_id)
                return True
        slot = self._slot_of.get(request_id)
        if slot is None:
            return False
        if self._predictive and not self._model_active[slot]:
            return False        # already decoded to completion on device
        self._cancel_on_device(slot)
        self._model_active[slot] = False
        self.cancelled_requests += 1
        ev = ("cancel", (slot, request_id))
        if self._pipeline:
            self._pipeline[-1]["events"].append(ev)
        else:                   # nothing in flight: applies now
            self._apply_cancel((slot, request_id))
        return True

    def _cancel_on_device(self, slot: int) -> None:
        """``_cancel_slot`` on the rank that holds ``slot``."""
        if self._shard is None:
            _cancel_slot(self._state.active, slot)
        elif self._shard.mine([slot])[0]:
            _cancel_slot(self._state.active, slot - self._shard.lo)

    def host_digest(self) -> dict:
        """The host state every rank of a mesh keeps alike
        (parallel/lockstep.py compares it): which request each slot
        serves, the paged allocator's free blocks, the queue's length and
        the completions not yet drained."""
        return {
            "slots": sorted(self._slot_of.items()),
            "free_blocks": (list(self._allocator._free) if self._paged
                            else None),
            "queued": len(self._queue),
            "done": sorted(self._done),
        }

    def reset(self) -> list[int]:
        """Re-arm the serving state after a loop failure without touching
        the weights: a fresh KV ring (or paged pool, allocator and tables)
        and slot state, a fresh prefix pool and trie, the pipeline and
        slot bookkeeping cleared (blocks still running on the card are
        dropped unwaited: stream order and the caching allocators keep
        their memory until they end). Queued requests survive: they never
        started.

        The telemetry and the queued requests' traces survive. Admitted-
        but-undelivered requests replay when the journal is on:
        each is re-queued, ahead of the never-started queue and in
        admission order, under its own id, with its journaled prefix as
        ``resume_tokens``; one whose prefix already finishes it is
        delivered without decoding. Only ids with no journal entry (all
        of them under ``replay=False``) are returned as lost, so the
        caller fails them upstream (their traces end ``failed``); a
        replayed request's trace gains a ``replayed`` mark and goes on. A
        request still mid-prefill in paged mode is in flight too, and
        replays with the rest."""
        failed: list[int] = []
        replay_reqs: list[Request] = []
        for rid in sorted(self._inflight):
            entry = (self._journal.get(rid)
                     if self.replay and self._journal is not None else None)
            if entry is None:
                failed.append(rid)
                self._finish_trace(rid, "failed")
                self.fail_stream(
                    rid, f"request {rid} lost to a serving-loop failure "
                         "(no journal entry to replay)")
                self.seal_journal(rid)
                continue
            # a crash between the finishing block's processing and the
            # delivery: deliver the journaled stream, decode nothing more
            if self._deliver_if_satisfied(rid, list(entry.emitted),
                                          entry.max_new_tokens, entry.stop):
                continue
            # the trace goes on: a replayed mark, then a second admission
            # chain and one terminal
            tr = self._traces.get(rid)
            if tr is not None:
                tr.mark("replayed")
                tr.attrs["replays"] = int(tr.attrs.get("replays", 0)) + 1
                tr.attrs["replayed_tokens"] = len(entry.emitted)
            replay_reqs.append(self._request_from_entry(entry, id=rid))
        self._prefix_refs.clear()
        # the pending fences are dropped unwaited (a failed dispatch's may
        # never complete) and no ready instant crosses the reset; the
        # histograms are kept
        self.dispatch_tracker.reset()
        self._init_device_state()
        if self._paged:
            self._init_paged_state()
        elif self._prefix_blocks:
            self._init_prefix_pool()
        self._init_host_state()
        self._queue.extendleft(reversed(replay_reqs))
        self._pending_fault = None
        self.resets += 1
        return failed

    @staticmethod
    def _request_from_entry(entry, **kw) -> Request:
        """The Request that resumes a journal entry from its prefix (its
        in-process deadline too; a file's entries carry none)."""
        return Request(
            prompt=np.asarray(entry.prompt, np.int32),
            max_new_tokens=entry.max_new_tokens,
            temperature=entry.temperature, top_k=entry.top_k,
            cache_prompt=entry.cache_prompt,
            resume_tokens=list(entry.emitted),
            stop=[list(q) for q in entry.stop] if entry.stop else None,
            logprobs=int(entry.logprobs or 0),
            priority=str(entry.priority or "interactive"),
            deadline=entry.deadline, trace=entry.trace, **kw)

    def recover_journal(self, entries, compact: bool = True) -> int:
        """Resubmit another process's unfinished journal entries
        (``RequestJournal.recover``) as fresh requests resuming from their
        journaled prefixes: ``serve`` calls this at startup, so a killed
        process's requests are finished by its successor. Fresh ids, in
        the entries' order (the dead process's waiters are gone with its
        ids). Exempt from ``max_queue``: the dead process accepted them
        all. An entry that fails validation is dropped with an error in
        the log, never fatal. Only once the resubmissions are journaled
        does the file compact down to the live set (``compact=False``
        defers that to the caller): a crash before that replays twice,
        never loses. -> how many were resubmitted."""
        n = 0
        saved_max_queue, self.max_queue = self.max_queue, 0
        try:
            for entry in entries:
                try:
                    rid = self.submit(self._request_from_entry(entry))
                except ValueError as e:
                    log.error("journal recovery dropped request %s "
                              "(unservable): %s", entry.id, e)
                    continue
                tr = self._traces.get(rid)
                if tr is not None:      # the dead process's id: lineage
                    tr.attrs["recovered_from"] = entry.id
                n += 1
        finally:
            self.max_queue = saved_max_queue
        if compact and self._journal is not None:
            self._journal.compact()
        return n

    def shutdown(self) -> None:
        """Stop the dispatch tracker's thread (no device time is recorded
        after) and close a file-backed journal; ServeApp calls this at
        the end. Idempotent."""
        self.dispatch_tracker.shutdown()
        if self._journal is not None:
            self._journal.close()

    # ---------------------------------------------------------- streaming

    def attach_stream(self, request_id: int, stream) -> None:
        """Register a request's token channel (``api.stream.TokenStream``:
        ``feed(emitted)``, ``finish(reason)``, ``fail(message)``). Call it
        under the serving lock right after ``submit()`` (``ServeApp.
        submit_async`` does): a request that completed at submit (its
        resume prefix satisfied it) is delivered through the stream here."""
        self.streams_opened += 1
        comp = self._done.get(request_id)
        if comp is not None:
            try:
                stream.feed(comp.tokens)
                stream.finish(comp.finish_reason)
            except Exception:
                log.exception("token stream attach-finish failed")
            return
        self._streams[request_id] = stream

    def fail_stream(self, request_id: int, message: str) -> None:
        """End a request's stream with an error and no completion (its
        caller delivered a failure upstream). Idempotent; an id without a
        stream is a no-op."""
        s = self._streams.pop(request_id, None)
        if s is not None:
            try:
                s.fail(str(message))
            except Exception:
                log.exception("token stream fail() failed")

    @property
    def streams_active(self) -> int:
        return len(self._streams)

    def _stream_feed(self, rid: int, emitted) -> None:
        """Push a request's absolute emitted-token list into its stream, if
        it has one (the stream appends only what it has not seen). Called
        at processing time, the journal's durability point; it only
        appends: no socket I/O and no device read under the lock."""
        s = self._streams.get(rid)
        if s is None:
            return
        try:
            n_new, stalled = s.feed(emitted)
        except Exception:       # delivery must never kill the loop
            log.exception("token stream feed failed")
            return
        if n_new:
            now = time.monotonic()
            if s.last_feed_t is not None:
                self.telemetry.observe("stream_itl_s",
                                       max(0.0, now - s.last_feed_t))
            s.last_feed_t = now
            if stalled:
                self.stream_stalls += 1

    def _finish_stream(self, rid: int) -> None:
        """Seal a request's stream from its Completion; every terminal that
        builds one calls this right after storing ``_done[rid]``."""
        s = self._streams.pop(rid, None)
        if s is None:
            return
        comp = self._done.get(rid)
        try:
            if comp is not None:
                s.feed(comp.tokens)
                s.finish(comp.finish_reason)
            else:
                s.fail(f"request {rid} terminated without a completion")
        except Exception:
            log.exception("token stream finish failed")

    def seal_journal(self, request_id: int) -> None:
        """Seal a request's journal entry without a completion: its caller
        delivered a terminal error upstream (``ServeApp._fail_pending``),
        so a later recovery must not decode it again. Idempotent; a no-op
        with the journal off."""
        if self._journal is not None:
            self._journal.finish(request_id)

    def fail_queued(self) -> list[Request]:
        """Drain the wait queue (requests never admitted): the graceful
        shutdown path; the caller tells their waiters why."""
        out = list(self._queue)
        self._queue.clear()
        for req in out:
            self._finish_trace(req.id, "failed")
            self.fail_stream(
                req.id, f"request {req.id} failed: server shutting down "
                        "before it was admitted")
            self.seal_journal(req.id)
        return out

    def _release_request(self, request_id: int) -> None:
        """Drop a finished or cancelled request's dispatch-side tracking,
        its paged blocks, its reference on its matched prefix-cache path
        and its journal entry (no replay after a delivered terminal)."""
        slot = self._slot_of.pop(request_id, None)
        self._inflight.discard(request_id)
        if self._paged and slot is not None:
            # the id still owned the slot: a predictive re-admission drops
            # the predecessor's mapping (and frees its blocks) itself
            self._free_slot_blocks(slot)
        path = self._prefix_refs.pop(request_id, None)
        if path is not None:
            self._prefix_cache.release(path)
        self.seal_journal(request_id)

    # ------------------------------------------------------------ tracing

    def _seal_trace(self, tr: RequestTrace, terminal: str, *,
                    n_tokens: int = 0, reason: str | None = None) -> dict:
        """Close a trace with its terminal span, feed the histograms and
        (for a request that held a slot) the service-time EWMA, and hand
        the record to the sink. -> the dict ``Completion.trace`` carries."""
        tr.attrs["n_tokens"] = n_tokens
        tr.attrs["finish_reason"] = reason if reason is not None else terminal
        tr.mark(terminal)
        self.telemetry.observe_trace(tr)
        svc = tr.dur("admitted", terminal)
        if svc is not None and svc >= 0:
            self._rate.observe(svc)
        record = tr.to_dict()
        if self.trace_sink is not None:
            try:        # telemetry must never take down the serving loop
                self.trace_sink(record)
            except Exception:
                log.exception("trace sink failed")
        return record

    def _finish_trace(self, request_id: int, terminal: str, *,
                      n_tokens: int = 0,
                      reason: str | None = None) -> dict | None:
        tr = self._traces.pop(request_id, None)
        if tr is None:
            return None
        return self._seal_trace(tr, terminal, n_tokens=n_tokens,
                                reason=reason)

    def estimate_retry_after(self) -> int:
        """The data-driven ``Retry-After``: seconds until a queue seat
        frees, from the EWMA service time of served requests and the
        queue's depth, in [1, 60] and monotone in the depth."""
        return self._rate.retry_after_s(len(self._queue), self.slots)

    def progress(self, request_id: int) -> dict | None:
        """A live request's replay state, the ``GET /progress`` payload:
        its processed tokens and its prompt's length. None for an unknown
        or finished id, or with the journal off."""
        entry = (self._journal.get(request_id)
                 if self._journal is not None else None)
        if entry is None:
            return None
        return {"tokens": list(entry.emitted),
                "prompt_tokens": len(entry.prompt)}

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def idle(self) -> bool:
        """Nothing queued, in flight, admitted-and-unfinished, or
        finished-but-undrained."""
        return not (self._queue or self._pipeline
                    or self._host_busy.any() or self._done)

    @property
    def completions_ready(self) -> bool:
        """True when drain_completed() would return something, without
        the forced read of predictive mode on every tick: the model knows
        a request finished before its tokens are read."""
        if self._done:
            return True
        if self._predictive:
            return bool((self._host_busy & ~self._model_active).any())
        return False

    @property
    def n_active(self) -> int:
        """Slots holding an unfinished request (admission through
        processed completion)."""
        return int(self._host_busy.sum())

    def stats(self) -> dict:
        """Serving-load and prefix-cache counters, one flat snapshot (the
        /stats payload). ``prefill_tokens_reused`` were copied from the
        prefix pool, ``prefill_tokens_computed`` ran the model."""
        disp = sorted(self.block_dispatch_s)
        out = {
            "model": self.model,
            "role": self.role,
            "registry": self.registry.names(),
            "torch_device": str(self.device),
            "slots": self.slots,
            "active": self.n_active,
            "queued": self.pending,
            "max_len": self.max_len,
            "block_size": self.block_size,
            "max_queue": self.max_queue,
            "admission_dispatches": self.admission_dispatches,
            "blocks_dispatched": self.blocks_dispatched,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_tokens_reused": self.prefill_tokens_reused,
            "shed": self.shed_requests,
            "shed_by_class": dict(self.shed_by_class),
            "cancelled": self.cancelled_requests,
            "expired": self.expired_requests,
            "resets": self.resets,
            "replay": self.replay,
            "replays": self.replays,
            "replayed_tokens": self.replayed_tokens,
            "chaos_faults_injected": self.chaos_faults_injected,
            "streams_active": self.streams_active,
            "streams_opened": self.streams_opened,
            "stream_stalls": self.stream_stalls,
            "decode_block_dispatch_ms_p50": (
                disp[len(disp) // 2] * 1e3 if disp else None),
            # count and quantiles of each histogram (host monotonic clock)
            "latency": self.telemetry.snapshot(),
            "retry_after_s": self.estimate_retry_after(),
            # dispatch -> ready quantiles a program kind and the tracker's
            # counters (in_flight, tracked, dropped, reap_errors)
            "device": self.dispatch_tracker.snapshot(),
        }
        if self._spec:
            out["speculative"] = {
                "draft_model": self.draft_model,
                "gamma": self._current_gamma(),
                "gamma_pinned": bool(self._spec_gamma_pin),
                "gamma_max": self.spec_gamma_max,
                "rounds": self.spec_rounds,
                "proposed_tokens": self.spec_proposed_tokens,
                "accepted_tokens": self.spec_accepted_tokens,
                "draft_prefill_tokens_reused":
                    self.draft_prefill_tokens_reused,
                "acceptance_ewma": round(float(self._accept_ewma.mean()), 4),
                "acceptance": self.spec_accept_hist.snapshot(),
                "verify_rounds_per_request": self.spec_rounds_hist.snapshot(),
            }
        if self._journal is not None:
            out["journal"] = {
                "entries": len(self._journal),
                "durable": self._journal.path is not None,
                "write_errors": self._journal.write_errors,
                "compactions": self._journal.compactions,
                "replay": self.replay,
            }
        pc = self._prefix_cache
        if pc is not None:
            out["prefix_cache"] = {
                "hits": pc.hits,
                "misses": pc.misses,
                "evictions": pc.evictions,
                "inserted_blocks": pc.inserted_blocks,
                "blocks_used": pc.blocks_used,
                "blocks_total": pc.n_blocks,
                "copy_dispatches": self.prefix_copy_dispatches,
                "insert_dispatches": self.prefix_insert_dispatches,
            }
        if self._paged:
            alloc = self._allocator
            out["paged_kv"] = {
                "kv_block": self.kv_block,
                "pool_blocks_total": alloc.n_blocks,
                "pool_blocks_free": alloc.free_blocks,
                "pool_blocks_used": alloc.used_blocks,
                "pool_blocks_peak": alloc.peak_used,
                "pool_state": self._pool_state_counts(),
                "kv_exports": self.kv_exports,
                "kv_imports": self.kv_imports,
                "kv_import_rejects": self.kv_import_rejects,
                "class_used": dict(alloc.class_used),
                "class_budgets": dict(self._class_budgets),
                "admission_defers": self.admission_defers,
                "gather_dispatches": self.paged_gather_dispatches,
                "scatter_dispatches": self.paged_scatter_dispatches,
                "prefill_chunks_interleaved":
                    self.prefill_chunks_interleaved,
                "prefill_interleave": self.prefill_interleave,
                "pending_prefill": len(self._pending_prefill),
            }
        if self._mesh is not None:
            # a mesh's shape (serve --mesh; the JAX package serves one
            # process and has no such key)
            out["mesh"] = dict(zip(self._mesh.mesh_dim_names,
                                   self._mesh.mesh.shape))
        return out

    def _pool_state_counts(self) -> dict:
        """The pool's blocks by holder: ``slot`` (slot tables only),
        ``trie`` (the trie only), ``shared`` (both: the zero-copy prefix
        hits) and ``free``; the four partition the pool."""
        held: set[int] = set()
        for s in range(self.slots):
            held.update(int(b) for b in self._slot_blocks[s])
            held.update(int(b) for b in self._slot_shared[s])
        pc = self._prefix_cache
        trie = {int(n.block) for n in pc._owned} if pc is not None else set()
        return {"free": self._allocator.free_blocks,
                "slot": len(held - trie), "trie": len(trie - held),
                "shared": len(held & trie)}

    # ----------------------------------------------------------- the loop

    def _free_for_admission(self, slot: int) -> bool:
        # predictive: the model knows the slot's request finished even if
        # its blocks are unprocessed (processing keeps successive
        # requests' streams apart). EOS mode: only a processed completion
        # frees the slot. A slot mid-prefill is not even model-active yet.
        if self._paged and any(a.slot == slot
                               for a, _ in self._pending_prefill):
            return False
        if self._predictive:
            return not self._model_active[slot]
        return not self._host_busy[slot]

    def _admit(self) -> None:
        """Admit queued requests into free slots: the whole burst is
        collected first (every ring offset derives from the same cursor),
        then dispatched in three phases whose stream order is the
        contract: (1) copy the matched prefix-cache blocks into the slot
        rings, (2) prefill each request's uncached suffix, (3) copy the
        burst's new full chunks into the pool. Each admission is logged
        against the newest in-flight block so the bookkeeping replays it
        in order."""
        if self.pause_admission:
            return
        if self._paged:
            self._admit_paged()
            return
        self._sweep_expired()
        C = self.prefill_chunk
        admissions: list[_Admission] = []
        for slot in range(self.slots):
            if not self._queue:
                break
            if not self._free_for_admission(slot):
                continue
            req = self._queue.popleft()
            for stale in [r for r, s in self._slot_of.items() if s == slot]:
                del self._slot_of[stale]
            self._slot_of[req.id] = slot
            self._inflight.add(req.id)
            resume = req.resume_tokens
            if resume is not None:
                # a replay or a resume (possibly with an empty prefix):
                # the effective context is prompt + prefix, through the
                # normal chunked prefill, and only the rest of the budget
                # decodes
                self.replays += 1
                self.replayed_tokens += len(resume)
            full = (np.concatenate([req.prompt, np.asarray(resume, np.int32)])
                    if resume else req.prompt)
            # all but the last token is prefilled; the last is the slot's
            # first fed token
            body = full[:-1]
            # the slot's first decode write lands at the current cursor.
            # Speculation has no shared cursor (a round advances each slot
            # by its own accepted count, written per row with a guard at
            # the target), so its ring is offset 0: logical position ==
            # index, within max_len by submit's check
            offset = (0 if self._spec
                      else (self._cursor - body.size) % self.max_len)
            target = body.size + req.max_new_tokens - len(resume or ())
            temp = (self.temperature if req.temperature is None
                    else float(req.temperature))
            topk = self.top_k if req.top_k is None else int(req.top_k)
            prefix_len, path = 0, []
            if self._prefix_cache is not None:
                path = self._prefix_cache.lookup(body)
                prefix_len = len(path) * C
                if path:
                    # pinned (unevictable) until the completion is processed
                    self._prefix_cache.acquire(path)
                    self.prefill_tokens_reused += prefix_len
            self._mark_admitted(req, len(path))
            admissions.append(_Admission(
                slot=slot, req=req, body=body, offset=offset, target=target,
                temp=temp, topk=topk,
                chunk_starts=list(range(prefix_len, body.size, C))
                or [prefix_len],
                last=int(full[-1]), prefix_len=prefix_len, hit_path=path))
        if not admissions:
            return
        self._dispatch_prefix_copy(admissions)
        if self.batched_admission and len(admissions) > 1:
            self._prefill_burst(admissions)
        else:
            for adm in admissions:
                self._prefill_one(adm)
        # the draft's prefill before the trie insert, which mirrors each
        # new chunk into the draft pool from the draft cache
        if self._spec:
            self._prefill_draft(admissions)
        self._dispatch_prefix_insert(admissions)
        for adm in admissions:
            slot = adm.slot
            # the prefill's host dispatch is done (the card runs it later):
            # the span is what admission cost the scheduling loop
            self._mark(adm.req.id, "prefill_done")
            self._host_busy[slot] = True
            self._np_temps[slot] = adm.temp
            self._np_topks[slot] = adm.topk
            self._np_lp[slot] = adm.req.logprobs
            self._model_len[slot] = adm.body.size
            self._model_active[slot] = True
            self._model_target[slot] = adm.target
            if adm.hit_path:
                self._prefix_refs[adm.req.id] = adm.hit_path
            admit = (slot, adm.body.size, adm.req)
            if self._pipeline:
                self._pipeline[-1]["events"].append(("admit", admit))
            else:                       # nothing in flight: applies now
                self._apply_admit(admit)

    def _mark_admitted(self, req: Request, hit_blocks: int) -> None:
        tr = self._traces.get(req.id)
        if tr is not None:
            tr.attrs["prompt_tokens"] = int(req.prompt.size)
            tr.attrs["prefix_hit_blocks"] = hit_blocks
            tr.mark("admitted")

    def _mark(self, request_id: int, span: str) -> None:
        tr = self._traces.get(request_id)
        if tr is not None:
            tr.mark(span)

    def _track(self, kind: str, event=None) -> int:
        """Register the dispatch just enqueued with the tracker: behind
        ``event`` when the caller has one recorded there, else behind a
        new one. -> its sequence number."""
        if event is None:
            event = _event(self.device)
        return self.dispatch_tracker.track(kind, _Fence(event))

    def _dispatch_prefix_copy(self, admissions) -> None:
        """Phase 1 of admission: one ``_copy_prefix_blocks`` call moves
        every matched pool block of the burst into its slot's ring, ahead
        of the suffix prefill whose attention reads them."""
        rows = [(a.slot, n.block, ci, a.offset)
                for a in admissions for ci, n in enumerate(a.hit_path)]
        if rows and self._shard is not None:
            self._copy_prefix_sharded(np.asarray(rows, np.int64))
            self.prefix_copy_dispatches += 1
            self._track("prefix_copy")
        elif rows:
            staged = _stage(np.asarray(rows, np.int64).T, self.device)
            _copy_prefix_blocks(self._pool, self._cache, staged)
            self.prefix_copy_dispatches += 1
            self._track("prefix_copy")
            if self._draft_pool is not None:
                # the same path is valid in the draft-shaped pool (inserts
                # mirror every block into both), so the hit seeds the
                # draft's ring too and the draft prefills only the suffix
                _copy_prefix_blocks(self._draft_pool, self._draft_cache,
                                    staged)
                self._track("draft_prefix_copy")

    def _dispatch_prefix_insert(self, admissions) -> None:
        """Phase 3 of admission: insert the burst's new full chunks into
        the trie and copy their just-prefilled K/V out of the slot rings
        into the new blocks, in one ``_insert_prefix_blocks`` call."""
        if self._prefix_cache is None:
            return
        rows, created = [], []
        for a in admissions:
            want = (self.cache_prompts if a.req.cache_prompt is None
                    else a.req.cache_prompt)
            if not want:
                continue
            for ci, node in self._prefix_cache.insert(a.body):
                rows.append((a.slot, node.block, ci, a.offset))
                created.append(node)
        if rows and self._shard is not None:
            self._insert_prefix_sharded(np.asarray(rows, np.int64))
            self.prefix_insert_dispatches += 1
            self._track("prefix_insert")
        elif rows:
            staged = _stage(np.asarray(rows, np.int64).T, self.device)
            _insert_prefix_blocks(self._pool, self._cache, staged)
            self.prefix_insert_dispatches += 1
            self._track("prefix_insert")
            if self._draft_pool is not None:
                # one trie node, two pools, one refcount
                _insert_prefix_blocks(self._draft_pool, self._draft_cache,
                                      staged)
                self._track("draft_prefix_insert")
        # the insert references protected the new blocks until their copy
        self._prefix_cache.release(created)

    def _copy_prefix_sharded(self, rows: np.ndarray) -> None:
        """``_copy_prefix_blocks`` on a batch-split mesh: each row's pool
        block comes from the rank holding it, and each rank writes the
        rows of its own slots."""
        sh, dev = self._shard, self.device
        slot, block = rows[:, 0], rows[:, 1]
        nb = self._pool.k.shape[1]
        local = _stage(block % nb, dev)
        owner = _stage(block // nb, dev)
        src = _with_tensors(self._pool, [
            sh.exchange(t[:, local], owner, 1)
            for t in _pool_tensors(self._pool)])
        mine = np.nonzero(sh.mine(slot))[0]
        if mine.size:
            at = np.stack([slot[mine] - sh.lo, mine, rows[mine, 2],
                           rows[mine, 3]])
            _copy_prefix_blocks(src, self._cache, _stage(at, dev))

    def _insert_prefix_sharded(self, rows: np.ndarray) -> None:
        """``_insert_prefix_blocks`` on a batch-split mesh: each row's K/V
        comes from the rank holding its slot, and each rank writes the
        blocks it holds."""
        sh, dev = self._shard, self.device
        slot, block = rows[:, 0], rows[:, 1]
        n_rows = rows.shape[0]
        at = np.stack([np.clip(slot - sh.lo, 0, sh.s_n - 1),
                       np.arange(n_rows), rows[:, 2], rows[:, 3]])
        cand = _with_tensors(self._pool, [
            t.new_zeros((t.shape[0], n_rows) + tuple(t.shape[2:]))
            for t in _pool_tensors(self._pool)])
        _insert_prefix_blocks(cand, self._cache, _stage(at, dev))
        owner = _stage(slot // sh.s_n, dev)
        got = [sh.exchange(t, owner, 1) for t in _pool_tensors(cand)]
        nb = self._pool.k.shape[1]
        mine = np.nonzero(block // nb == sh.rank)[0]
        if mine.size:
            src, dst = _stage(mine, dev), _stage(block[mine] % nb, dev)
            for t, g in zip(_pool_tensors(self._pool), got):
                t[:, dst] = g[:, src]

    def _chunk(self, adm: _Admission, c0: int) -> tuple[np.ndarray, int]:
        n_valid = max(0, min(self.prefill_chunk, adm.body.size - c0))
        chunk = np.zeros(self.prefill_chunk, np.int32)
        chunk[:n_valid] = adm.body[c0:c0 + n_valid]
        self.prefill_tokens_computed += n_valid
        return chunk, n_valid

    def _prefill_one(self, adm: _Admission) -> None:
        """Per-slot admission: one prefill call per chunk."""
        for c0 in adm.chunk_starts:
            chunk, n_valid = self._chunk(adm, c0)
            _prefill_chunk(self._params, self.cfg, self._cache, self._state,
                           chunk, adm.slot, c0, adm.offset, n_valid,
                           adm.last, adm.target, adm.temp, adm.topk,
                           finalize=c0 == adm.chunk_starts[-1],
                           plan=self._plan, slot_range=self._slot_range)
            self.admission_dispatches += 1
            self._track("prefill")

    def _prefill_burst(self, admissions) -> None:
        """Batched admission: chunk round r of every admitted request in
        one ``_prefill_batch`` call, max-chunks calls in all."""
        rounds = max(len(a.chunk_starts) for a in admissions)
        for r in range(rounds):
            rows = [a for a in admissions if r < len(a.chunk_starts)]
            chunks = [self._chunk(a, a.chunk_starts[r]) for a in rows]
            _prefill_batch(
                self._params, self.cfg, self._cache, self._state,
                np.stack([c for c, _ in chunks]),
                [a.slot for a in rows], [a.chunk_starts[r] for a in rows],
                [a.offset for a in rows], [n for _, n in chunks],
                [a.last for a in rows], [a.target for a in rows],
                [a.temp for a in rows], [a.topk for a in rows],
                [r == len(a.chunk_starts) - 1 for a in rows],
                plan=self._plan, slot_range=self._slot_range)
            self.admission_dispatches += 1
            self._track("prefill")

    def _prefill_draft(self, admissions) -> None:
        """Speculative serving: the draft's own ring gets the same context.
        A prefix hit covers the draft too (``_dispatch_prefix_copy``
        seeded its ring), so only the suffix prefills, with the target's
        chunk starts: one ``_prefill_batch`` call a chunk round, every row
        non-final, so the slot state the target's prefill committed is
        left alone while the draft's lengths land at each body's size.
        Every admission has a round-0 row, an empty one for a fully
        cached or 1-token prompt, which still resets the draft slot's
        length from its previous occupant."""
        C = self.prefill_chunk
        for adm in admissions:
            self.draft_prefill_tokens_reused += adm.prefix_len
        rounds = max(len(a.chunk_starts) for a in admissions)
        for r in range(rounds):
            rows = [a for a in admissions if r < len(a.chunk_starts)]
            chunks, n_valids = [], []
            for a in rows:
                c0 = a.chunk_starts[r]
                n_valid = max(0, min(C, a.body.size - c0))
                chunk = np.zeros(C, np.int32)
                chunk[:n_valid] = a.body[c0:c0 + n_valid]
                chunks.append(chunk)
                n_valids.append(n_valid)
            k = len(rows)
            _prefill_batch(
                self._draft_params, self._draft_cfg, self._draft_cache,
                self._state, np.stack(chunks), [a.slot for a in rows],
                [a.chunk_starts[r] for a in rows], [a.offset for a in rows],
                n_valids, [0] * k, [0] * k, [0.0] * k, [0] * k, [False] * k)
            self.admission_dispatches += 1
            self._track("draft_prefill")

    def _apply_admit(self, admit) -> None:
        slot, body_len, req = admit
        # the slot belongs to a new request from this event on
        self._stop_cancelled.discard(int(slot))
        self._spec_round_counts[slot] = 0
        self._spec_accepted_counts[slot] = 0
        self._expect_len[slot] = body_len
        self._expect_active[slot] = True
        self._requests[slot] = req
        # a resumed request's completion owes the whole stream: the tally
        # starts with the teacher-forced prefix, whose logprob rows are
        # placeholders (those positions were prefilled, not decoded)
        resume = req.resume_tokens or ()
        self._emitted[slot] = [int(t) for t in resume]
        self._lp_acc[slot] = ([{"token": int(t), "logprob": None,
                                "top": None} for t in resume]
                              if req.logprobs else [])
        # re-arm busy at the replay position: a predecessor processed just
        # before this admit cleared it
        self._host_busy[slot] = True

    def _apply_cancel(self, payload) -> None:
        """Processing-side half of cancel(), replayed at its position in
        the event log, so the emitted tally is exactly what the device
        produced before the deactivation. A request that finished in an
        earlier block won the race: skip, and reconcile the counter."""
        slot, rid = payload
        req = self._requests[slot]
        if req is None or req.id != rid:
            self.cancelled_requests -= 1
            return
        out = self._emitted[slot]
        self._done[rid] = Completion(
            rid, out, "cancelled",
            trace=self._finish_trace(rid, "cancelled", n_tokens=len(out)),
            logprobs=self._lp_acc[slot] if req.logprobs else None)
        self._finish_stream(rid)
        self._requests[slot] = None
        self._emitted[slot] = []
        self._lp_acc[slot] = []
        self._host_busy[slot] = self._taken_over(slot, rid)
        self._expect_active[slot] = False
        self._release_request(rid)

    # ------------------------------------------------------- paged KV
    # (the JAX package's serving.py:3483-3811 and :4093). Every admitted
    # request holds every block it can write from admission on, so no
    # admitted request fails for want of KV: overload defers admission.

    def _free_slot_blocks(self, slot: int) -> None:
        """Return a slot's table to all-pad: unref every block it holds
        (its own free unless the trie adopted them; shared ones lose this
        slot's reference), credit its class's budget for its own, and
        floor the slot so no decode row of a block in flight lands in a
        freed block. Blocks already dispatched keep the tables they
        staged, and stream order puts their scatters before any write of
        a block's next holder."""
        own, shared = self._slot_blocks[slot], self._slot_shared[slot]
        if own or shared:
            self._allocator.credit(self._slot_class[slot], len(own))
            for block in own + shared:
                self._allocator.unref(block)
            self._slot_blocks[slot] = []
            self._slot_shared[slot] = []
            self._np_tables[slot, :] = self._allocator.n_blocks   # pad
        self._np_floor[slot] = self.max_len

    def _gather_view(self, draft: bool = False) -> KVCache:
        """The pool as the ring view for the next program, from this
        instant's host tables and offsets (``_stage`` copies them, so a
        later table change never reaches a dispatch already queued).
        ``draft``: the draft's mirror pool at the draft's lengths (the same
        tables and offsets)."""
        ring = np.arange(self.max_len)[None, :]
        _, blk, row = _paged_rows(self._np_tables, self._np_offs,
                                  self.kv_block, ring)
        pool = self._draft_kv_pool if draft else self._kv_pool
        base = blk * (pool.k.shape[2] * self.kv_block) + row
        self.paged_gather_dispatches += 1
        lens = self._d_draft_lens if draft else self._d_lens
        if self._shard is not None:
            # a batch-split mesh: this rank's slots, whose blocks all lie in
            # its share (BlockAllocator shares). A pad entry reads the
            # share's last block: the pad itself on the last rank, stale
            # rows elsewhere, which the mask weighs 0 as a ring's
            sh, nb = self._shard, pool.k.shape[1]
            mine = slice(sh.lo, sh.lo + sh.s_n)
            local = np.minimum(blk[mine] - sh.rank * nb, nb - 1)
            if (local < 0).any():
                raise RuntimeError("paged KV gather: a slot's table holds "
                                   "another rank's block")
            base = local * (pool.k.shape[2] * self.kv_block) + row[mine]
        return _gather_paged_view(pool, _stage(base, self.device), lens)

    def _scatter_view(self, view: KVCache, ring_ids: np.ndarray,
                      n_valids: np.ndarray, floors: np.ndarray,
                      draft: bool = False) -> None:
        """Commit the rows a program wrote: ``ring_ids`` [S, W] are the
        ring indices each slot's program wrote (decode: the cursor window
        for every slot; prefill: one slot's chunk). The host drops column
        j of slot s where j >= ``n_valids[s]``, its logical position is
        below ``floors[s]`` or its table entry is the pad block (the
        reference's three guards), and stages the rest, each target once
        (``_scatter_paged_rows``). The tables and offsets are the ones the
        gather staged: nothing changes them between the two. ``draft``
        commits into the draft's mirror pool."""
        pool = self._draft_kv_pool if draft else self._kv_pool
        p, blk, row = _paged_rows(self._np_tables, self._np_offs,
                                  self.kv_block, ring_ids)
        col = np.arange(ring_ids.shape[1])[None, :]
        keep = ((col < n_valids[:, None]) & (p >= floors[:, None])
                & (blk < self._allocator.n_blocks))
        s_idx, j_idx = np.nonzero(keep)
        kvh = pool.k.shape[2]
        rows = np.stack([
            s_idx * (kvh * self.max_len) + ring_ids[s_idx, j_idx],
            blk[s_idx, j_idx] * (kvh * self.kv_block) + row[s_idx, j_idx]])
        if np.unique(rows[1]).size != rows.shape[1]:
            # two slots' writes to one block: a host bookkeeping fault,
            # raised before the card sees a racy index_copy_
            raise RuntimeError("paged KV scatter: a pool row targeted twice")
        if self._shard is not None:
            # this rank's slots' rows, into its share's blocks (gather)
            sh = self._shard
            rows = rows[:, (s_idx >= sh.lo) & (s_idx < sh.lo + sh.s_n)]
            rows[0] -= sh.lo * (kvh * self.max_len)
            rows[1] -= sh.rank * pool.k.shape[1] * (kvh * self.kv_block)
        if rows.shape[1]:
            _scatter_paged_rows(pool, view,
                                _stage(rows.astype(np.int64), self.device))
        self.paged_scatter_dispatches += 1
        self._track("paged_scatter")

    def _admit_paged(self) -> None:
        """Paged admission, gated on free pool blocks and the class's
        budget as well as on free slots. Allocation is all or nothing a
        request and FIFO, with one reordering: past a head-of-line request
        whose class is over budget to the first queued request of the
        other class (a budget would otherwise block the very tier it
        protects). Admitted requests join ``_pending_prefill``, which
        ``_pump_prefill`` drains (whole here without interleaving)."""
        self._sweep_expired()
        for slot in range(self.slots):
            if not self._queue:
                break
            if not self._free_for_admission(slot):
                continue
            status = self._try_admit_paged(slot, 0)
            if status == "ok":
                continue
            self.admission_defers += 1
            if status == "budget":
                head_cls = self._queue[0].priority
                alt = next((i for i in range(1, len(self._queue))
                            if self._queue[i].priority != head_cls), None)
                if alt is not None and \
                        self._try_admit_paged(slot, alt) == "ok":
                    continue
            break       # the pool is short: FIFO holds, retry next turn
        self._pump_prefill(self.prefill_interleave or None)

    def _try_admit_paged(self, slot: int, qidx: int) -> str:
        """Admit queued request ``qidx`` into ``slot`` -> "ok" (dequeued,
        its prefill pending), "budget" (its class is over its block
        budget) or "pool" (blocks short even after reclaiming trie
        leaves)."""
        B = self.kv_block
        req = self._queue[qidx]
        resume = req.resume_tokens
        full = (np.concatenate([req.prompt, np.asarray(resume, np.int32)])
                if resume else req.prompt)
        body = full[:-1]
        target = body.size + req.max_new_tokens - len(resume or ())
        # every logical position the request can write, up front
        cap_blocks = max(1, -(-target // B))
        share = self._share(slot)
        path = (self._prefix_cache.lookup(body, share)
                if self._prefix_cache is not None else [])
        n_new = cap_blocks - len(path)
        cls = req.priority
        alloc = self._allocator
        blocks = alloc.alloc_for(cls, n_new, share)
        if blocks is None:
            budget = alloc.class_budgets.get(cls)
            if budget is not None and \
                    alloc.class_used.get(cls, 0) + n_new > budget:
                return "budget"
            short = n_new - alloc.free_in(share)
            if self._prefix_cache is not None and short > 0:
                # cached prefixes yield to live admissions; a reclaim may
                # evict nodes of the matched path, so look it up again
                self._prefix_cache.reclaim(short, share)
                path = (self._prefix_cache.lookup(body, share) if path
                        else [])
                n_new = cap_blocks - len(path)
                blocks = alloc.alloc_for(cls, n_new, share)
            if blocks is None:
                return "pool"
        del self._queue[qidx]
        prefix_len = len(path) * B
        if resume is not None:
            self.replays += 1
            self.replayed_tokens += len(resume)
        for stale in [r for r, s in self._slot_of.items() if s == slot]:
            del self._slot_of[stale]
        # a predictive re-admission: the predecessor's decode is done on
        # the card though its completion is unprocessed; its blocks free
        # now (its mapping is gone, so _release_request cannot free twice)
        self._free_slot_blocks(slot)
        self._slot_of[req.id] = slot
        self._inflight.add(req.id)
        # speculation has no shared cursor: offset 0, as on the ring
        offset = (0 if self._spec
                  else (self._cursor - body.size) % self.max_len)
        temp = (self.temperature if req.temperature is None
                else float(req.temperature))
        topk = self.top_k if req.top_k is None else int(req.top_k)
        if path:
            self._prefix_cache.acquire(path)
            self.prefill_tokens_reused += prefix_len
            self._prefix_refs[req.id] = path
        self._mark_admitted(req, len(path))
        # the table: the trie's hit blocks first (one reference each, no
        # copy: the hit is the block), then the slot's own fresh ones
        shared = [n.block for n in path]
        for block in shared:
            alloc.ref(block)
        row = self._np_tables[slot]
        row[:] = alloc.n_blocks                             # pad
        row[:len(shared) + len(blocks)] = shared + blocks
        self._slot_blocks[slot] = list(blocks)
        self._slot_shared[slot] = shared
        self._slot_class[slot] = cls
        self._np_offs[slot] = offset
        self._np_floor[slot] = self.max_len     # until the final chunk
        self._host_busy[slot] = True
        self._np_temps[slot] = temp
        self._np_topks[slot] = topk
        self._np_lp[slot] = req.logprobs
        self._pending_prefill.append([_Admission(
            slot=slot, req=req, body=body, offset=offset, target=target,
            temp=temp, topk=topk,
            chunk_starts=list(range(prefix_len, body.size,
                                    self.prefill_chunk)) or [prefix_len],
            last=int(full[-1]), prefix_len=prefix_len, hit_path=path), 0])
        return "ok"

    def _pump_prefill(self, budget: int | None) -> None:
        """Dispatch pending prefill chunks, oldest admission first, until
        ``budget`` prompt tokens are spent (None: all of them, the ring
        engine's behaviour). A decode block dispatches between capped
        pumps, so a burst of long prompts stretches over blocks instead
        of stalling every running stream."""
        spent = 0
        while self._pending_prefill:
            if budget is not None and spent >= budget:
                self.prefill_chunks_interleaved += 1
                break
            pend = self._pending_prefill[0]
            adm, idx = pend
            c0 = adm.chunk_starts[idx]
            final = idx == len(adm.chunk_starts) - 1
            n_valid = max(0, min(self.prefill_chunk, adm.body.size - c0))
            if final and not self._spec and self.role != "prefill":
                # the admission-time offset put the first decode write at
                # the cursor of then; blocks interleaved since moved it.
                # The pool is logical, so the offset may change between
                # dispatches: re-derive it for the cursor of now (a no-op
                # when nothing interleaved; a prefill role's slot never
                # decodes)
                adm.offset = (self._cursor - adm.body.size) % self.max_len
                self._np_offs[adm.slot] = adm.offset
            self._dispatch_paged_prefill(adm, c0, n_valid, final)
            spent += max(1, n_valid)
            if final:
                self._pending_prefill.popleft()
                self._finalize_admit_paged(adm)
            else:
                pend[1] = idx + 1

    def _dispatch_paged_prefill(self, adm: _Admission, c0: int,
                                n_valid: int, final: bool) -> None:
        """One slot's chunk: gather the view, run ``_prefill_chunk`` (the
        ring engine's program) on it, commit the chunk's rows."""
        C = self.prefill_chunk
        chunk = np.zeros(C, np.int32)
        chunk[:n_valid] = adm.body[c0:c0 + n_valid]
        view = self._gather_view()
        # a prefill role writes the final chunk's KV but never activates
        # the slot: it does not decode
        _prefill_chunk(self._params, self.cfg, view, self._state, chunk,
                       adm.slot, c0, adm.offset, n_valid, adm.last,
                       adm.target, adm.temp, adm.topk,
                       finalize=final and self.role != "prefill",
                       plan=self._plan, slot_range=self._slot_range)
        self._track("prefill")
        ring_ids = np.zeros((self.slots, C), np.int64)
        ring_ids[adm.slot] = (adm.offset + c0 + np.arange(C)) % self.max_len
        n_valids = np.zeros((self.slots,), np.int64)
        n_valids[adm.slot] = n_valid
        # floor 0: this is the prefill writing what the floor will guard
        floors = np.zeros((self.slots,), np.int64)
        self._scatter_view(view, ring_ids, n_valids, floors)
        self.admission_dispatches += 1
        self.prefill_tokens_computed += n_valid
        if self._spec:
            # the draft's mirror pool takes the same span at its own
            # lengths; it never finalizes (the target's commit owns the
            # slot state)
            dview = self._gather_view(draft=True)
            _prefill_chunk(self._draft_params, self._draft_cfg, dview,
                           self._state, chunk, adm.slot, c0, adm.offset,
                           n_valid, adm.last, adm.target, adm.temp, adm.topk,
                           finalize=False)
            self._track("draft_prefill")
            self._scatter_view(dview, ring_ids, n_valids, floors,
                               draft=True)
            self.admission_dispatches += 1

    def _finalize_admit_paged(self, adm: _Admission) -> None:
        """The final chunk is dispatched: the trie adopts the slot's
        freshly filled full blocks (no copy: it references them), the slot
        takes decode writes from the body's end on, and the admit event is
        logged at this point of the dispatch order."""
        slot, req, body = adm.slot, adm.req, adm.body
        self._mark(req.id, "prefill_done")
        if self._spec:
            self.draft_prefill_tokens_reused += adm.prefix_len
        want = (self.cache_prompts if req.cache_prompt is None
                else req.cache_prompt)
        if self._prefix_cache is not None and want:
            B = self.kv_block
            row = self._np_tables[slot]
            offer = {i: int(row[i])
                     for i in range(adm.prefix_len // B, body.size // B)}
            if offer:
                self._prefix_cache.adopt(body, offer)
        if self.role == "prefill":
            # the KV leaves for another replica: snapshot it, complete
            # the request with no tokens, free the slot and its blocks
            self._stash_export(adm)
            self._done[req.id] = Completion(
                req.id, [], "prefilled",
                trace=self._finish_trace(req.id, "finished", n_tokens=0,
                                         reason="prefilled"))
            self._finish_stream(req.id)
            self._host_busy[slot] = False
            self._release_request(req.id)
            return
        self._np_floor[slot] = body.size
        self._model_len[slot] = body.size
        self._model_active[slot] = True
        self._model_target[slot] = adm.target
        admit = (slot, body.size, req)
        if self._pipeline:
            self._pipeline[-1]["events"].append(("admit", admit))
        else:                           # nothing in flight: applies now
            self._apply_admit(admit)

    # ------------------------------------------- KV transfer (disaggregation)
    # (the JAX package's serving.py:3819-4090)

    def _stash_export(self, adm: _Admission) -> None:
        """Start a finished prefill's blocks on their way to the host and
        keep them, with the request's replay state, for ``export_blocks``.
        Nothing waits for the card here: the copy and its event are
        enqueued, and the encoding happens when the payload is asked
        for. The blocks free right after (``_snapshot_kv_blocks``)."""
        req, slot, body = adm.req, adm.slot, adm.body
        B = self.kv_block
        n_blocks = max(1, -(-int(body.size) // B))
        ids = [int(b) for b in self._np_tables[slot][:n_blocks]]
        tr = self._traces.get(req.id)
        entry = {
            "id": int(req.id),
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "temperature": req.temperature,
            "top_k": req.top_k,
            "cache_prompt": req.cache_prompt,
            "seed": self._seed,
            "emitted": [int(t) for t in (req.resume_tokens or ())],
            "model": req.model,
            "stop": ([list(map(int, q)) for q in req.stop]
                     if req.stop else None),
            "logprobs": int(req.logprobs or 0),
            "priority": req.priority,
            # the decode replica lands in this trace even header-less
            "trace": (tr.ctx.as_dict()
                      if tr is not None and tr.ctx is not None else None),
        }
        meta = dict(model=self.model, kv_block=B, kv_dtype=self.kv_dtype,
                    body_len=int(body.size), entry=entry)
        # on a mesh the ranks of the slot's share hold its blocks, each its
        # slice of the heads; one rank a slice snapshots it
        share = self._share(slot)
        holds = self._kv_sender and (self._shard is None
                                     or self._shard.rank == share)
        snap = None
        if holds:
            if self._shard is not None:
                nb = self._kv_pool.k.shape[1]
                ids = [b - share * nb for b in ids]
            snap = _snapshot_kv_blocks(self._kv_pool, ids)
        rid = int(req.id)
        with self._transfer_lock:
            self.kv_exports += 1
            if self._front:
                self._exports[rid] = _Export(
                    meta, {self._kv_part: snap} if holds else {},
                    self._kv_parts)
                while len(self._exports) > self._exports_cap:
                    self._exports.popitem(last=False)
            elif holds:
                self._parts_out[rid] = (self._kv_part, snap)
        if tr is not None:
            tr.attrs["exported_blocks"] = n_blocks

    def export_blocks(self, request_id: int, timeout_s: float = 30.0
                      ) -> dict:
        """Pop a prefilled request's transfer payload, encoded now (base64
        and the checksum, after waiting for its copy to the host). Safe
        from another thread than the serving loop's, without the serving
        lock. On a mesh, rank 0 assembles the ranks' slices of the heads
        (``join_kv_heads``), waiting up to ``timeout_s`` for the
        followers' to arrive (each at a turn after its copy is done).
        KeyError when the request never finished its prefill here, the
        stash aged it out or its slices did not all come: the caller
        re-prefills from the prompt on a decode replica instead."""
        rid = int(request_id)
        deadline = time.monotonic() + timeout_s
        with self._transfer_lock:
            item = self._exports.get(rid)
            while item is not None and len(item.parts) < item.n_parts:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._transfer_lock.wait(left)
                item = self._exports.get(rid)
            if item is None:
                raise KeyError(f"no KV export payload for request {rid}")
            del self._exports[rid]
        if len(item.parts) < item.n_parts:
            raise KeyError(
                f"KV export of request {rid} is not complete: "
                f"{len(item.parts)} of {item.n_parts} ranks' kv heads "
                f"arrived within {timeout_s} s")
        host = join_kv_heads([item.parts[p].wait()
                              for p in range(item.n_parts)])
        return _payload(host, **item.meta)

    def take_export_parts(self) -> dict:
        """A mesh follower's finished export slices, popped for the next
        lockstep message -> {request id: (kv part, host buffers)}. Never
        waits for the card: a slice whose copy's event is not done yet
        (``query``) stays for a later turn."""
        out = {}
        with self._transfer_lock:
            for rid, (part, snap) in list(self._parts_out.items()):
                if snap.ready is not None and not snap.ready.query():
                    continue
                out[rid] = (part, snap.host)
                del self._parts_out[rid]
        return out

    def add_export_parts(self, parts: dict) -> None:
        """Rank 0: a follower's slices (``take_export_parts``) join their
        exports; a slice of an export the stash aged out is dropped."""
        if not parts:
            return
        with self._transfer_lock:
            for rid, (part, host) in parts.items():
                item = self._exports.get(int(rid))
                if item is not None:
                    item.parts[int(part)] = _KVSnapshot(list(host))
            self._transfer_lock.notify_all()

    def prepare_import(self, payload) -> _KVImport:
        """Decode and verify a transfer payload against this engine, and
        stage its blocks in host memory (pinned on the card). Reads only
        the engine's configuration, so it runs outside the serving lock:
        hashing a long prompt's payload there would stall the loop.
        ValueError (counted in ``kv_import_rejects``) on any damage or
        mismatch."""
        try:
            return self._prepare_import(payload)
        except ValueError:
            with self._transfer_lock:
                self.kv_import_rejects += 1
            raise

    def _prepare_import(self, payload) -> _KVImport:
        if not self._paged:
            raise ValueError("import_blocks requires paged=True (the "
                             "transfer unit is the paged KV block)")
        if self.role == "prefill":
            raise ValueError("a prefill-role replica cannot import KV "
                             "blocks (nothing here decodes them)")
        if self._spec:
            raise ValueError("KV import into a speculative server is "
                             "unsupported (the transfer carries no draft "
                             "pool payload)")
        B = self.kv_block
        if not isinstance(payload, dict):
            raise ValueError("KV transfer payload must be an object")
        if payload.get("model") != self.model:
            raise ValueError(
                f"KV transfer is for model {payload.get('model')!r} but "
                f"this engine serves {self.model!r}")
        if int(payload.get("kv_block", 0)) != B:
            raise ValueError(f"KV transfer kv_block="
                             f"{payload.get('kv_block')} != this engine's {B}")
        if str(payload.get("kv_dtype")) != str(self.kv_dtype):
            raise ValueError(
                f"KV transfer kv_dtype={payload.get('kv_dtype')!r} != this "
                f"engine's {self.kv_dtype!r}")
        k, v, ks, vs = deserialize_kv_blocks(payload)
        pk = self._kv_pool.k
        # a payload holds every kv head, whatever slice this rank's pool
        # holds
        want = (pk.shape[0], self.cfg.n_kv_heads, *pk.shape[3:])
        if (k.shape[0], *k.shape[2:]) != want or k.dtype != pk.dtype:
            raise ValueError(
                f"KV transfer block shape {tuple(k.shape[0:1] + k.shape[2:])}"
                f"/{_WIRE_NAMES.get(k.dtype)} does not match this pool's "
                f"{want}/{_WIRE_NAMES.get(pk.dtype)}")
        if (ks is None) != (self._kv_pool.k_scale is None):
            raise ValueError("KV transfer scales do not match this pool")
        entry = payload.get("entry")
        if not isinstance(entry, dict):
            raise ValueError("KV transfer payload has no journal entry")
        try:
            prompt = [int(t) for t in entry["prompt"]]
            max_new = int(entry["max_new_tokens"])
            emitted = [int(t) for t in (entry.get("emitted") or ())]
            body_len = int(payload["body_len"])
            n_blocks = int(payload["n_blocks"])
            logprobs = int(entry.get("logprobs") or 0)
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed KV transfer entry: {e}") from None
        if body_len != len(prompt) + len(emitted) - 1:
            raise ValueError(
                f"KV transfer body_len={body_len} does not match the "
                f"entry's {len(prompt)} prompt + {len(emitted)} emitted "
                "tokens")
        if n_blocks != max(1, -(-body_len // B)):
            raise ValueError("KV transfer n_blocks/body_len mismatch")
        if len(prompt) < 1 or max_new < 1:
            raise ValueError("KV transfer entry has an empty request")
        if len(emitted) >= max_new:
            raise ValueError(
                "KV transfer entry is already satisfied (nothing left to "
                "decode); deliver it from the journal instead")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"KV transfer request needs {len(prompt)} prompt + "
                f"{max_new} new tokens but slots hold max_len="
                f"{self.max_len}")
        # the fed token indexes the embedding: out of range faults the card
        if min(prompt + emitted) < 0 or \
                max(prompt + emitted) >= self.cfg.vocab_size:
            raise ValueError(f"KV transfer token ids must be in [0, "
                             f"{self.cfg.vocab_size})")
        if not 0 <= logprobs <= LOGPROBS_MAX:
            raise ValueError(f"logprobs must be in [0, {LOGPROBS_MAX}]")
        if self.device.type == "cuda":
            k, v = k.pin_memory(), v.pin_memory()
            if ks is not None:
                ks, vs = ks.pin_memory(), vs.pin_memory()
        return _KVImport(k=k, v=v, ks=ks, vs=vs, entry=entry, prompt=prompt,
                         max_new=max_new, emitted=emitted, n_blocks=n_blocks)

    def import_blocks(self, payload, trace=None,
                      request_id: int | None = None) -> int:
        """Install a prefill replica's exported blocks and resume the
        request here, decode only: fresh blocks from this pool, the
        payload written in (``_write_pool_blocks``), the table row
        installed and the slot activated as a local final prefill chunk
        would, so the gather view cannot tell the blocks from ones
        prefilled here. ``payload`` is the wire dict or a
        ``prepare_import`` result (``ServeApp`` decodes outside the
        serving lock). ValueError on damage (``prepare_import``);
        QueueFullError, with ``retry_after_s``, when no slot or pool
        blocks are free now: a handoff is never queued. ``trace`` (a
        ``TraceContext`` or its dict, from the transport's header) puts
        the decode leg in the caller's trace; without it the entry's
        ``"trace"`` is the parent. On a mesh every rank imports the whole
        payload (rank 0 decides, parallel/lockstep.py sends it on with
        ``request_id``, the id rank 0 gave it); each writes its own slice
        of the heads, on a batch-split mesh only the ranks of the share
        that owns the slot. A refusal changes no host state. -> the new
        request id."""
        prep = (payload if isinstance(payload, _KVImport)
                else self.prepare_import(payload))
        entry, emitted, max_new = prep.entry, prep.emitted, prep.max_new
        stop = entry.get("stop")
        req = Request(
            prompt=np.asarray(prep.prompt, np.int32),
            max_new_tokens=max_new, temperature=entry.get("temperature"),
            top_k=entry.get("top_k"), cache_prompt=entry.get("cache_prompt"),
            resume_tokens=emitted or None,
            stop=_normalize_stop(stop) if stop else None,
            logprobs=int(entry.get("logprobs") or 0),
            priority=(entry.get("priority")
                      if entry.get("priority") in PRIORITY_CLASSES
                      else "interactive"),
            **({} if request_id is None else {"id": int(request_id)}))
        slot = next((s for s in range(self.slots)
                     if self._free_for_admission(s)), None)
        if slot is None:
            err = QueueFullError("no free slot for KV import")
            err.retry_after_s = self.estimate_retry_after()
            err.priority = req.priority
            raise err
        B = self.kv_block
        full = (np.concatenate([req.prompt, np.asarray(emitted, np.int32)])
                if emitted else req.prompt)
        body = full[:-1]
        target = body.size + max_new - len(emitted)
        cap_blocks = max(1, -(-target // B))
        cls = req.priority
        alloc = self._allocator
        share = self._share(slot)
        # funded or refused before anything changes: a refusal on a
        # mesh's rank 0 never reaches the followers, so it must leave the
        # host state (the trie, the free lists) as it found it
        short = cap_blocks - alloc.free_in(share)
        budget = alloc.class_budgets.get(cls)
        if (budget is not None
                and alloc.class_used.get(cls, 0) + cap_blocks > budget) \
                or (short > 0 and (
                    self._prefix_cache is None
                    or self._prefix_cache.reclaimable(share) < short)):
            self.admission_defers += 1
            err = QueueFullError(f"pool blocks short for KV import "
                                 f"({cap_blocks} needed)")
            err.retry_after_s = self.estimate_retry_after()
            err.priority = cls
            raise err
        if short > 0:
            self._prefix_cache.reclaim(short, share)
        blocks = alloc.alloc_for(cls, cap_blocks, share)
        # validated and funded: install
        tr = RequestTrace(req.id)
        tr.mark("submitted")
        ctx = (trace if isinstance(trace, TraceContext)
               else TraceContext.from_dict(trace))
        if ctx is None:
            # a header-less import: the prefill leg's identity is the
            # parent, a new span for this leg
            stashed = TraceContext.from_dict(entry.get("trace"))
            if stashed is not None:
                ctx = stashed.child()
        if ctx is not None:
            tr.bind(ctx)
            tr.attrs["service"] = "serve"
        tr.attrs["imported_blocks"] = prep.n_blocks
        if emitted:
            tr.attrs["resume_tokens"] = len(emitted)
        self._traces[req.id] = tr
        mine = self._shard is None or self._shard.rank == share
        if mine:
            bufs = [prep.k, prep.v] + ([prep.ks, prep.vs]
                                       if prep.ks is not None else [])
            bufs = split_kv_heads(bufs, self._kv_part, self._kv_parts)
            if self.device.type == "cuda":
                # host memory the copies need not wait for: pinned, whole
                bufs = [t if t.is_pinned() and t.is_contiguous()
                        else t.contiguous().pin_memory() for t in bufs]
            ids = blocks[:prep.n_blocks]
            if self._shard is not None:
                nb = self._kv_pool.k.shape[1]
                ids = [b - share * nb for b in ids]
            _write_pool_blocks(self._kv_pool, ids, *bufs,
                               *([None, None] if len(bufs) == 2 else []))
        for stale in [r for r, s in self._slot_of.items() if s == slot]:
            del self._slot_of[stale]
        self._free_slot_blocks(slot)
        self._slot_of[req.id] = slot
        self._inflight.add(req.id)
        offset = (self._cursor - body.size) % self.max_len
        temp = (self.temperature if req.temperature is None
                else float(req.temperature))
        topk = self.top_k if req.top_k is None else int(req.top_k)
        row = self._np_tables[slot]
        row[:] = alloc.n_blocks                             # pad
        row[:len(blocks)] = blocks
        self._slot_blocks[slot] = list(blocks)
        self._slot_shared[slot] = []
        self._slot_class[slot] = cls
        self._np_offs[slot] = offset
        self._np_floor[slot] = body.size
        self._host_busy[slot] = True
        self._np_temps[slot] = temp
        self._np_topks[slot] = topk
        self._np_lp[slot] = req.logprobs
        if mine:
            lo = 0 if self._shard is None else self._shard.lo
            _activate_slot(self._state, self._d_lens, slot - lo,
                           int(full[-1]), target, offset, body.size, temp,
                           topk)
        self._model_len[slot] = body.size
        self._model_active[slot] = True
        self._model_target[slot] = target
        tr.mark("admitted")
        tr.mark("prefill_done")
        # the imported prefix seeds the trie with no copy, as a local
        # finalize does
        want = (self.cache_prompts if req.cache_prompt is None
                else req.cache_prompt)
        if self._prefix_cache is not None and want:
            offer = {i: int(row[i]) for i in range(body.size // B)}
            if offer:
                self._prefix_cache.adopt(body, offer)
        if self._journal is not None:
            self._journal.submit(
                req.id, prep.prompt, max_new, temperature=req.temperature,
                top_k=req.top_k, cache_prompt=req.cache_prompt,
                seed=self._seed, emitted=emitted, model=self.model,
                stop=[list(q) for q in req.stop] if req.stop else None,
                logprobs=req.logprobs, priority=req.priority,
                trace=ctx.as_dict() if ctx is not None else None)
        admit = (slot, int(body.size), req)
        if self._pipeline:
            self._pipeline[-1]["events"].append(("admit", admit))
        else:
            self._apply_admit(admit)
        with self._transfer_lock:
            self.kv_imports += 1
        return req.id

    # ------------------------------------------------------------ decode

    def _dispatch_block(self) -> None:
        """Enqueue one decode block. Nothing here waits for the card: the
        variant flags come from the host mirrors, the cursor is a host
        int, and ``packed`` is read later by ``_process``. Paged mode
        first pumps up to ``prefill_interleave`` pending prefill tokens,
        then runs the block on a gathered view and commits the cursor
        window of each slot at or above its floor."""
        if self._paged and self._pending_prefill and self.prefill_interleave:
            self._pump_prefill(self.prefill_interleave)
        t0 = time.perf_counter()
        busy = self._host_busy
        lp_k = LOGPROBS_MAX if (self._np_lp[busy] > 0).any() else 0
        cache = self._gather_view() if self._paged else self._cache
        cache, packed = _decode_block(
            self._params, self._fused, self.cfg, cache, self._state,
            self._cursor, self._gen, block=self.block_size,
            stop_arr=self._stop_arr, pad_id=self.pad_id, top_k=self.top_k,
            # _host_busy never goes False while a row is active on device
            per_row_topk=bool((self._np_topks[busy] != self.top_k).any()),
            all_greedy=not (self._np_temps[busy] > 0).any(), lp_k=lp_k,
            plan=self._plan,
            rows=None if self._shard is None else (self._shard.lo,
                                                   self.slots))
        if self._paged:
            self._d_lens = cache.length
            window = (self._cursor + np.arange(self.block_size)) % self.max_len
            self._scatter_view(
                cache, np.broadcast_to(window, (self.slots, self.block_size)),
                np.full((self.slots,), self.block_size),
                self._np_floor.copy())
        else:
            self._cache = cache
        host, ready = _start_read(packed)
        seq = self._track("decode_block", ready)    # the read's event
        self._cursor = (self._cursor + self.block_size) % self.max_len
        self.blocks_dispatched += 1
        dt = time.perf_counter() - t0
        self.block_dispatch_s.append(dt)
        self.telemetry.observe("decode_block_s", dt)
        self._pipeline.append({"host": host, "ready": ready, "events": [],
                               "lp_k": lp_k, "seq": seq})
        if self._predictive:            # exact: no EOS can surprise us
            adv = np.minimum(self.block_size,
                             self._model_target - self._model_len)
            self._model_len = self._model_len + np.where(
                self._model_active, adv, 0).astype(np.int32)
            self._model_active &= self._model_len < self._model_target
        self._post_dispatch_chaos()

    def _current_gamma(self) -> int:
        """The next speculative round's draft window: the ``spec_gamma``
        pin, or the busy slots' mean acceptance EWMA a mapped through the
        expected accepted run length a/(1-a), clamped to [1,
        spec_gamma_max] and snapped to a power of two (the JAX package's
        serving.py:4279; there it bounds the compiled programs, here it
        keeps the port's windows the same)."""
        if self._spec_gamma_pin:
            return self._spec_gamma_pin
        busy = self._host_busy
        a = float(self._accept_ewma[busy].mean() if busy.any()
                  else self._accept_ewma.mean())
        a = min(max(a, 0.0), 0.99)
        raw = max(1.0, min(a / max(1e-6, 1.0 - a),
                           float(self.spec_gamma_max)))
        g = 1 << int(round(math.log2(raw)))
        # the largest power of two <= spec_gamma_max, so a max off the
        # ladder is never returned itself
        return max(1, min(g, 1 << (self.spec_gamma_max.bit_length() - 1)))

    def _dispatch_spec_round(self) -> None:
        """Speculative decode dispatch: one propose/verify round for all
        slots (``_spec_block``), logged in the pipeline the decode blocks
        use, so admissions and cancels replay at their dispatch positions
        and the packed result is sliced by length delta. Its result comes
        back as a decode block's does (``_start_read``: a pinned copy and
        an event), so nothing here waits for the card.

        Paged: both pools are gathered into ring views (the same tables,
        each at its own lengths), the round runs on them, and each slot's
        window, the gamma+1 positions from its length before the round, is
        committed back to both pools (``_commit_spec_window``). The JAX
        package computes that window from host lengths, so it processes
        the round at once; here the window is indexed on the card from
        the lengths the round started from, so the round joins the
        pipeline like a ring round and dispatch waits for nothing.
        Committing all gamma+1 rows is safe though the verify may roll
        back: those rows lie past the slot's new length, in blocks it
        holds alone, and the next round overwrites them."""
        t0 = time.perf_counter()
        gamma = self._current_gamma()
        if self._paged:
            cache = self._gather_view()
            dcache = self._gather_view(draft=True)
            len0 = cache.length
            staged = _stage(np.concatenate(
                [self._np_tables, self._np_floor[:, None]], 1).astype(
                    np.int64), self.device)
        else:
            cache, dcache = self._cache, self._draft_cache
        cache, dcache, packed = _spec_block(
            self._params, self._draft_params, self.cfg, self._draft_cfg,
            cache, dcache, self._state, gamma=gamma, stop_arr=self._stop_arr,
            pad_id=self.pad_id)
        if self._paged:
            self._d_lens, self._d_draft_lens = cache.length, dcache.length
            tables, floors = staged[:, :-1], staged[:, -1]
            for pool, view in ((self._kv_pool, cache),
                               (self._draft_kv_pool, dcache)):
                _commit_spec_window(pool, view, len0, tables, floors,
                                    gamma + 1)
                self.paged_scatter_dispatches += 1
                self._track("paged_scatter")
        else:
            self._cache, self._draft_cache = cache, dcache
        host, ready = _start_read(packed)
        seq = self._track("spec_round", ready)
        self.blocks_dispatched += 1
        self.spec_rounds += 1
        dt = time.perf_counter() - t0
        self.block_dispatch_s.append(dt)
        self.telemetry.observe("decode_block_s", dt)
        self._pipeline.append({"host": host, "ready": ready, "events": [],
                               "lp_k": 0, "seq": seq, "spec_gamma": gamma})
        self._post_dispatch_chaos()

    def _post_dispatch_chaos(self) -> None:
        """The deterministic chaos hooks (constants.py): crash the loop,
        or SIGKILL the process, at exact decode-block ordinals, after the
        block was really dispatched, so recovery has in-flight work to
        replay."""
        if (self._chaos_sigkill_block
                and self.blocks_dispatched >= self._chaos_sigkill_block):
            log.error("chaos: SIGKILLing this process at decode block %d",
                      self.blocks_dispatched)
            os.kill(os.getpid(), signal.SIGKILL)
        if self.blocks_dispatched in self._chaos_crash_blocks:
            self._chaos_crash_blocks.discard(self.blocks_dispatched)
            self.chaos_faults_injected += 1
            fault = RuntimeError("chaos: injected mid-decode loop crash at "
                                 f"block {self.blocks_dispatched}")
            if not self.defer_faults:
                raise fault
            self._pending_fault = fault

    def _process(self, count: int) -> None:
        """Read + bookkeep the oldest ``count`` in-flight blocks, each from
        its pinned host copy once its event has passed (newer blocks keep
        running). Emitted tokens per slot are the length delta against
        the expectation; completions fire where a slot went inactive; each
        block's admissions and cancellations replay after it, in dispatch
        order.

        Device lag: the newest of these blocks is waited for first (stream
        order makes the older ones ready too), then one host observation
        instant less each block's ready instant, as the tracker's reaper
        recorded it, is its ``device_lag_s``."""
        recs = [self._pipeline.popleft() for _ in range(count)]
        B = self.block_size
        if recs[-1]["ready"] is not None:
            recs[-1]["ready"].synchronize()
        t_obs = time.monotonic()
        tracker = self.dispatch_tracker
        # the reaper's walk up to the newest seq returns at once now
        tracker.ready_time(recs[-1]["seq"], timeout=0.25)
        for rec in recs:
            rt = tracker.ready_time(rec["seq"])
            rec["lag"] = max(0.0, t_obs - rt) if rt is not None else None
            if rec["lag"] is not None:
                self.telemetry.observe("device_lag_s", rec["lag"])
        for rec in recs:
            lag = rec["lag"]
            lp_k = rec["lp_k"]
            packed = rec["host"].numpy()
            gamma = rec.get("spec_gamma")
            if gamma is not None:
                # a speculative round: emissions, the raw acceptance
                # count, the length and the active flag
                toks, n_accs = packed[:, :gamma + 1], packed[:, gamma + 1]
                lengths = packed[:, gamma + 2]
                active = packed[:, gamma + 3].astype(bool)
            else:
                toks = packed[:, :B]
                lengths, active = packed[:, B], packed[:, B + 1].astype(bool)
            if lp_k:
                base = B + 2
                lp_chosen = np.ascontiguousarray(
                    packed[:, base:base + B]).view(np.float32)
                lp_ids = packed[:, base + B:base + B + B * lp_k].reshape(
                    -1, B, lp_k)
                lp_vals = np.ascontiguousarray(
                    packed[:, base + B + B * lp_k:base + B + 2 * B * lp_k]
                ).view(np.float32).reshape(-1, B, lp_k)
            for slot in np.nonzero(self._expect_active)[0]:
                if slot in self._stop_cancelled:
                    continue
                if gamma is not None:
                    # the raw acceptance count (the draft's agreement,
                    # before the budget and stop clamps) feeds the slot's
                    # EWMA that steers gamma, the histogram and counters
                    acc = int(n_accs[slot])
                    rate = acc / gamma
                    self.spec_proposed_tokens += gamma
                    self.spec_accepted_tokens += acc
                    self._accept_ewma[slot] += self._spec_ewma_alpha * (
                        rate - self._accept_ewma[slot])
                    self.spec_accept_hist.observe(rate)
                    self._spec_round_counts[slot] += 1
                    self._spec_accepted_counts[slot] += acc
                n = int(lengths[slot] - self._expect_len[slot])
                req = self._requests[slot]
                new = [int(t) for t in toks[slot, :n]]
                stop_hit = False
                if new and req is not None and req.stop:
                    # a match may start in delivered tokens but must end
                    # in this batch (delivered tokens are never retracted)
                    prev_len = len(self._emitted[slot])
                    cand = self._emitted[slot] + new
                    end = _stop_match_end(cand, req.stop, start=prev_len)
                    if end is not None:
                        new = cand[prev_len:end]
                        stop_hit = True
                had_tokens = bool(self._emitted[slot])
                self._emitted[slot].extend(new)
                if new and lp_k and req is not None and req.logprobs:
                    k = req.logprobs
                    for j in range(len(new)):
                        self._lp_acc[slot].append({
                            "token": new[j],
                            "logprob": round(float(lp_chosen[slot, j]), 6),
                            "top": [
                                [int(t) for t in lp_ids[slot, j, :k]],
                                [round(float(v), 6)
                                 for v in lp_vals[slot, j, :k]]]})
                if new and req is not None and self._journal is not None:
                    # the durability point: the journaled prefix advances
                    # with the host-processed tokens (replay from any true
                    # prefix is exact; the lag only costs re-decoding)
                    self._journal.emit(req.id, new)
                if new and req is not None:
                    # streaming delivery at the same instant: the feed is
                    # absolute, so a replay's resume prefix is not sent twice
                    self._stream_feed(req.id, self._emitted[slot])
                if new and not had_tokens and req is not None:
                    # the host first sees this request's tokens: TTFT's
                    # span (behind the block's read, so it lags the card)
                    tr = self._traces.get(req.id)
                    if tr is not None and tr.t("first_token") is None:
                        tr.mark("first_token")
                        if lag is not None:
                            tr.attrs["device_lag_first_token_s"] = round(
                                lag, 6)
                if stop_hit:
                    # complete now with "stop" and free the device slot
                    # like a cancel; _stop_cancelled skips the slot until
                    # a processed block shows it inactive
                    self._complete_slot(slot, req, "stop", lag)
                    if active[slot]:
                        self._cancel_on_device(int(slot))
                        self._stop_cancelled.add(int(slot))
                    self._model_active[slot] = False
                    continue
                if not active[slot]:
                    out = self._emitted[slot]
                    reason = ("stop" if out and out[-1] in self.stop_tokens
                              else "length")
                    self._complete_slot(slot, req, reason, lag)
            self._expect_len = np.array(lengths)
            self._expect_active = np.array(active)
            for slot in list(self._stop_cancelled):
                if not active[slot]:
                    self._stop_cancelled.discard(slot)
                else:
                    self._expect_active[slot] = False
            for kind, payload in rec["events"]:
                if kind == "admit":
                    self._apply_admit(payload)
                else:
                    self._apply_cancel(payload)

    def _complete_slot(self, slot: int, req: Request, reason: str,
                       lag: float | None = None) -> None:
        """Deliver one slot's finished request and free its host state;
        ``lag`` is its last block's device lag, for the trace."""
        out = self._emitted[slot]
        tr = self._traces.get(req.id)
        if lag is not None and tr is not None:
            tr.attrs["device_lag_s"] = round(lag, 6)
        if self._spec:
            if tr is not None:
                tr.attrs["spec_rounds"] = int(self._spec_round_counts[slot])
                tr.attrs["spec_accepted_tokens"] = int(
                    self._spec_accepted_counts[slot])
            if self._spec_round_counts[slot]:
                self.spec_rounds_hist.observe(
                    float(self._spec_round_counts[slot]))
            self._spec_round_counts[slot] = 0
            self._spec_accepted_counts[slot] = 0
        lps = self._lp_acc[slot][:len(out)] if req.logprobs else None
        self._done[req.id] = Completion(
            req.id, out, reason,
            trace=self._finish_trace(req.id, "finished", n_tokens=len(out),
                                     reason=reason),
            logprobs=lps)
        self._finish_stream(req.id)
        self._requests[slot] = None
        self._emitted[slot] = []
        self._lp_acc[slot] = []
        self._host_busy[slot] = self._taken_over(slot, req.id)
        self._release_request(req.id)

    def _taken_over(self, slot: int, rid: int) -> bool:
        """Whether the dispatch side already admitted another request into
        ``slot`` (a predictive re-admission), so that it stays busy when
        ``rid``'s completion is processed. The successor's admit event
        re-arms busy when it is replayed, but processing may stop between
        the two blocks (``checkpoint_progress``, the backlog cap), and a
        paged admission logs its event only at its final prefill chunk:
        in between, the decode blocks' variant flags read ``_host_busy``
        and must see the successor's sampling and logprobs."""
        return any(s == slot and r != rid for r, s in self._slot_of.items())

    def _device_may_be_active(self) -> bool:
        if self._predictive:
            return bool(self._model_active.any())
        return bool(self._expect_active.any()) or any(
            kind == "admit"
            for r in self._pipeline for kind, _ in r["events"])

    def step(self) -> None:
        """One scheduling turn (``_step``); a deferred chaos fault is
        raised at its end."""
        self._step()
        if self._pending_fault is not None:
            fault, self._pending_fault = self._pending_fault, None
            raise fault

    def _step(self) -> None:
        """One scheduling turn.

        Predictive mode (no stop tokens): admission comes off the exact
        host model, blocks dispatch open-loop, and nothing is read until
        the results are wanted (drain) or the backlog hits its cap.

        EOS mode: admit when the host's view is current, dispatch a block
        if any slot may be running, and process the blocks beyond the
        pipeline depth (all of them on the drain tail)."""
        self._inject_chaos()
        if self._predictive:
            self._admit()
            if self._device_may_be_active():
                self._dispatch_block()
            elif self._pipeline:
                self._process(len(self._pipeline))
            if len(self._pipeline) >= 64:      # bound host-side backlog
                self._process(len(self._pipeline) - self.pipeline_depth)
            return
        if not self._pipeline:
            self._admit()
        dispatched = False
        if self._device_may_be_active():
            if self._spec:
                self._dispatch_spec_round()
            else:
                self._dispatch_block()
            dispatched = True
        depth = self.pipeline_depth if dispatched else 0
        if len(self._pipeline) > depth:
            self._process(len(self._pipeline) - depth)
            self._admit()

    def _inject_chaos(self) -> None:
        """The seeded chaos hooks (constants.py): a turn's delay, and a
        failure raised as a real dispatch failure would be, out of
        step() into the serving loop's recovery. The n-th turn fails iff
        the n-th draw does, whatever the timing."""
        if self._chaos_delay_ms:
            time.sleep(self._chaos_delay_ms / 1000)
        if (self._chaos_fail_rate
                and self._chaos_rng.random() < self._chaos_fail_rate):
            self.chaos_faults_injected += 1
            raise RuntimeError("chaos: injected serving dispatch failure "
                               f"#{self.chaos_faults_injected}")

    def checkpoint_progress(self) -> None:
        """The durability checkpoint: process every in-flight block except
        the newest ``pipeline_depth``, so the journal's prefixes (and
        /progress) advance and finished completions come out, without
        waiting for the blocks still running. Predictive mode otherwise
        processes only at a completion or a 64-block backlog. ServeApp
        calls it every ``journal_checkpoint_s``."""
        n = len(self._pipeline) - self.pipeline_depth
        if n > 0:
            self._process(n)

    def drain_completed(self) -> dict[int, Completion]:
        if self._predictive and self._pipeline and not self._done:
            self._process(len(self._pipeline))
        done, self._done = self._done, {}
        return done

    def run_until_drained(self) -> dict[int, Completion]:
        """Serve until the queue, every slot, and the pipeline are empty."""
        out: dict[int, Completion] = {}
        while not self.idle:
            self.step()
            if self._done:
                out.update(self.drain_completed())
        out.update(self.drain_completed())
        return out


__all__ = ["Request", "Completion", "SlotServer", "QueueFullError",
           "PrefixCache", "BlockAllocator",
           "COMPLETION_FINISH_REASONS", "FINISH_REASONS", "PRIORITY_CLASSES",
           "LOGPROBS_MAX", "KV_TRANSFER_VERSION", "KV_IMPORT_KEYS",
           "KV_ENTRY_KEYS", "serialize_kv_blocks", "deserialize_kv_blocks",
           "split_kv_heads", "join_kv_heads"]
