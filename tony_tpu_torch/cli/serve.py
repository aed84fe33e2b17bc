"""``serve``: a long-lived generation service over the continuous-batching
slot pool (port of the JAX package's cli/serve.py: one engine, one device).

    python -m tony_tpu_torch.cli.serve --port 8200 \\
        --vocab 32768 --d-model 1024 --n-layers 12 --n-heads 8 --d-ff 4096

    curl -s localhost:8200/generate -d '{"prompt": [1,2,3],
                                         "max_new_tokens": 64}'
    -> {"id": 0, "tokens": [...], "finish_reason": "length"}

One serving thread owns the device: it admits queued requests into freed
KV-cache slots and dispatches decode blocks (models/serving.py). HTTP
handler threads only enqueue and wait; they make no CUDA tensor. POST
/generate blocks until the request completes (400 on a malformed body,
429 when the queue is full, 503 when the serving loop is down, 504 on its
timeout); ``resume_tokens`` teacher-forces an already-emitted prefix and
``progress_key`` names the request for GET /progress?key=a (or
?keys=a,b), which answers each live request's journaled tokens. GET
/healthz answers 200 or 503; GET /stats reports the slots, the queue, the
engine's counters (``replays``, ``replayed_tokens``, ``journal``, the
streams'), ``latency`` (each latency histogram's count, mean, p50, p90
and p99), ``retry_after_s``, ``metrics`` (the serving-load gauges' max
and average over scheduling turns) and, with ``--prefix-cache-blocks``,
the prefix cache's (``prefix_cache``: hits, misses, evictions, blocks).

Telemetry: GET /metrics renders the /stats numbers and the latency
histograms (TTFT, TPOT, queue wait, end to end, prefill and decode-block
dispatch, the loop's turn, device lag, replay catch-up, the streams'
inter-token gap) in Prometheus's text format, with the device time of
each dispatched program kind (``serving_dispatch_ready_seconds{kind=}``:
dispatch to ready on the card, measured off the serving thread on CUDA
events; /stats' ``device``). GET /debug/profile?seconds=N (N in (0,
120]; one capture at a time, 409 otherwise) records a ``torch.profiler``
trace of the live traffic into ``<trace-dir>/profiles/serve_<unix
time>_<N>s/`` as Chrome-trace JSON (not an xplane dump; needs
``--trace-dir``). A 429's ``Retry-After`` is the engine's
estimate of the seconds until a queue seat frees (an EWMA of served
requests' service time times the queue's depth over the slots), or the
fleet autoscaler's remaining cooldown when that is longer: POST
/autoscale/hint ``{"cooldown_s": s}`` sets it, and it decays with the
wall clock.

Streaming: ``"stream": true`` (or ``?stream=true``) on /generate answers
Server-Sent Events, ``{"tokens": [...]}`` deltas and one closing
``{"id", "finish_reason", "n_tokens", "trace_id"}`` frame. POST
/v1/completions and /v1/chat/completions speak the OpenAI shapes
(api/openai.py), buffered or streamed (chunks, then ``data: [DONE]``);
``--text-codec`` maps their text to token ids. Every streamed frame
carries ``id: <rid>:<n>`` (n tokens delivered so far); a client that lost
its stream re-POSTs with ``Last-Event-ID: <rid>:<n>`` and gets the rest,
its delivered prefix teacher-forced. A client that vanishes mid-stream is
cancelled. Frames come when the engine processes blocks: in predictive
mode at a completion, at a 64-block backlog or at every journal
checkpoint (``--journal-checkpoint-s``), so about once a checkpoint; in
EOS mode (``--stop-tokens``) behind each block. An inbound ``X-Tony-Trace:
<trace_id>:<span_id>`` is adopted (else a root is minted), journaled with
the request and echoed as ``X-Tony-Trace-Id`` on buffered answers and as
``trace_id`` on a stream's closing frame.

Every accepted request is journaled; a serving-loop failure replays the
in-flight ones (``--no-replay``: fails them instead). The loop advances
the journal every ``--journal-checkpoint-s`` seconds. With
``--trace-dir``, the journal is the file
``<trace-dir>/requests.journal.jsonl``: a restarted process recovers and
finishes the requests a killed one left (it prints how many it resumed).
The directory also takes every terminated request's lifecycle trace
(``requests.trace.jsonl``) and, at shutdown, the latency histograms
(``telemetry.state.json``, written through a temporary file and a
rename), which the next process on the directory resumes; a dump that is
unreadable or of the wrong shape is reported and ignored.

Weights are random, drawn from ``--seed``, or restored from an lm_train
checkpoint (``--checkpoint-dir``: its latest step's ``params``), on
``--device`` (default: the card; the CPU only when named).
``--prefix-cache-blocks N`` keeps shared prompt prefixes' K/V in N
chunk-sized blocks; ``--no-cache-prompts`` serves from that cache but
inserts a prompt only when its request sets ``"cache_prompt": true``.

Disaggregated serving: ``--role prefill`` (needs ``--paged-kv``) prefills
only: /generate answers ``finish_reason: "prefilled"``, no tokens, and
the KV handoff payload as ``"handoff"``; POST that body verbatim to
/kv/import on a ``--role decode`` (or ``both``) replica, which decodes
the rest as the /generate of a local request would (``?stream=true``
for SSE, ``?timeout_s=``). A damaged payload answers 400, a replica with
no free slot or pool blocks 429 with ``Retry-After``. /stats says the
``role``.

``--paged-kv`` swaps the slots x max-len KV ring for one pool of
``--kv-block``-token blocks (``--kv-pool-blocks`` of them; default the
ring's bytes) with a block table a slot: admission waits for free blocks,
so concurrency follows the KV the requests need. With it,
``--prefill-interleave N`` prefills at most N prompt tokens a decode
block, ``--class-budget-interactive`` / ``--class-budget-batch`` cap the
blocks a priority class (the body's ``"priority"``) may hold, and the
prefix cache maps cached blocks into a slot's table instead of copying
them (``--prefix-cache-blocks`` then counts ``--kv-block``-token nodes).
/stats gains ``paged_kv`` (the pool's blocks, by holder, the classes'
use, the deferred admissions).

``--hf-checkpoint DIR`` serves a HuggingFace Llama or Mistral checkpoint
(models/hf_import.py, no ``transformers`` needed; its config sets the
dims), exclusive with ``--checkpoint-dir``; ``--weight-dtype int8``
decodes on int8 weights (w8a16) while prefill reads the cast ones.

Several models: ``--model NAME=SPEC`` (repeatable; SPEC ``random[:seed]``,
``ckpt:<dir>`` or ``hf:<dir>``) serves each from its own engine, the first
the default; a body's ``"model"`` (or /v1's) picks one, an unknown name
answers 400. /stats gains ``models`` (each engine's payload) and
``registry`` (the names), and /metrics the ``serving_models`` info gauge
and ``{model="..."}`` series. One journal serves every engine; a restart
resubmits each entry to its model's engine.

Speculative serving (greedy): ``--draft-model NAME|SPEC`` (a SPEC loads
at the ``--draft-*`` dims as the entry "draft"), ``--spec-gamma`` pins the
draft window, else it is autotuned up to ``--spec-gamma-max``. Every
request's tokens are the spec-off server's; /stats' ``speculative`` and
the ``serving_spec_*`` families count the rounds and the acceptance.

Tensor-parallel serving: ``--mesh data=2,tensor=2`` (``axis=size``
pairs, unnamed axes 1) serves one model without a draft from a job of as
many processes under the TONY_* contract (``train.init``: NCCL on the
cards, gloo with ``--device cpu``). The weights are prepared once onto
the mesh (``TP_DECODE_RULES``) and every rank runs its own engine on its
blocks, kept in step by parallel/lockstep.py: rank 0 binds ``--port``
(the serving job passes ``$TONY_SERVE_PORT``) and owns HTTP, admission,
the journal, traces and streams; the other ranks bind nothing and follow
its turns. /stats gains ``world`` and ``lockstep`` (the turn exchange's
host seconds); the engine's ``mesh`` is the mesh's shape. /metrics has no
compile families (ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import math
import os
import select
import socket
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .. import metrics as _metrics
from ..api.stream import stream_requested


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tony_tpu_torch.cli.serve")
    p.add_argument("--port", type=int, default=8200)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default=None,
                   help="default: the GPU (raises without one)")
    p.add_argument("--checkpoint-dir", default="",
                   help="lm_train checkpoint directory; empty = random init")
    p.add_argument("--hf-checkpoint", default="",
                   help="HuggingFace Llama/Mistral checkpoint directory "
                        "(its config sets the model dims)")
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--d-ff", type=int, default=1024)
    p.add_argument("--vocab", type=int, default=4096)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--slots", type=int, default=8,
                   help="concurrent KV-cache slots (the max in-flight batch)")
    p.add_argument("--max-len", type=int, default=2048,
                   help="per-slot cache capacity: prompt + generation")
    p.add_argument("--block-size", type=int, default=16,
                   help="decode steps per dispatched block")
    p.add_argument("--prefill-chunk", type=int, default=128)
    p.add_argument("--kv-dtype", default="native", choices=("native", "int8"))
    p.add_argument("--weight-dtype", default="native",
                   choices=("native", "int8"))
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--stop-tokens", default="",
                   help="whitespace-separated EOS token ids")
    p.add_argument("--pad-id", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--per-slot-admission", action="store_true",
                   help="one prefill call per chunk per slot instead of "
                        "one per chunk round")
    p.add_argument("--prefix-cache-blocks", type=int, default=0,
                   help="enable the chunk-aligned prefix KV cache with this "
                        "many prefill-chunk-sized blocks of device memory "
                        "(0 = off): shared prompt prefixes prefill once and "
                        "later requests copy their cached K/V")
    p.add_argument("--no-cache-prompts", action="store_true",
                   help="with --prefix-cache-blocks: serve from the cache "
                        "but insert a prompt only when its request sets "
                        "cache_prompt=true")
    p.add_argument("--max-queue", type=int, default=0,
                   help="requests beyond this many waiting are shed with "
                        "HTTP 429 (0 = unbounded)")
    p.add_argument("--batch-queue-frac", type=float, default=0.5,
                   help="with --max-queue: batch-priority requests are "
                        "shed once the queue is this fraction full")
    p.add_argument("--loop-max-restarts", type=int, default=3,
                   help="consecutive serving-loop failures tolerated (each "
                        "resets the slot state and restarts after a "
                        "backoff) before /healthz answers 503")
    p.add_argument("--loop-backoff-s", type=float, default=0.5,
                   help="base of the exponential restart backoff")
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="SIGTERM/SIGINT: how long in-flight requests get "
                        "to finish before shutdown")
    p.add_argument("--trace-dir", default="",
                   help="directory of the file-backed request journal "
                        "(requests.journal.jsonl: a killed process's "
                        "unfinished requests are recovered and finished "
                        "by the restarted one), the request traces "
                        "(requests.trace.jsonl) and the latency histograms "
                        "(telemetry.state.json, resumed at startup). "
                        "Empty = in-memory journal, no files")
    p.add_argument("--no-replay", action="store_true",
                   help="no request journal and no replay: a loop crash "
                        "fails the in-flight requests and a restart "
                        "recovers nothing")
    p.add_argument("--journal-checkpoint-s", type=float, default=1.0,
                   help="how often the loop processes the in-flight blocks "
                        "down to the pipeline depth, so the journal's "
                        "prefixes (what replay and /progress resume from) "
                        "stay fresh; 0 = never (forced under --no-replay)")
    p.add_argument("--text-codec", default="ids", choices=("ids", "bytes"),
                   help="text <-> token mapping of the /v1 routes (no "
                        "tokenizer ships with the repo): 'ids' = text is "
                        "space-separated decimal token ids (an exact round "
                        "trip), 'bytes' = UTF-8 bytes (needs --vocab >= "
                        "256; ids >= 256 decode as U+FFFD)")
    p.add_argument("--paged-kv", action="store_true",
                   help="one paged pool of KV blocks with a block table a "
                        "slot instead of the slots x max-len ring: "
                        "admission waits for free blocks, so concurrency "
                        "follows the KV the requests need")
    p.add_argument("--kv-block", type=int, default=0,
                   help="with --paged-kv: tokens a KV block (must divide "
                        "--max-len and --prefill-chunk; default "
                        "--block-size)")
    p.add_argument("--kv-pool-blocks", type=int, default=0,
                   help="with --paged-kv: the pool's blocks, the KV memory "
                        "budget (default slots x max-len / kv-block, the "
                        "ring's bytes)")
    p.add_argument("--prefill-interleave", type=int, default=0,
                   help="with --paged-kv: prefill at most this many prompt "
                        "tokens a decode block, so a burst of long prompts "
                        "does not stall running streams (0 = whole prompts "
                        "at admission)")
    p.add_argument("--class-budget-interactive", type=int, default=0,
                   help="with --paged-kv: the KV blocks the interactive "
                        "class may hold exclusively (0 = no cap)")
    p.add_argument("--class-budget-batch", type=int, default=0,
                   help="with --paged-kv: the KV blocks the batch class "
                        "may hold exclusively (0 = no cap)")
    p.add_argument("--role", default="both",
                   choices=("prefill", "decode", "both"),
                   help="disaggregated serving: 'prefill' (needs "
                        "--paged-kv) prefills only and answers /generate "
                        "with finish_reason 'prefilled' and the KV handoff "
                        "payload; 'decode' and 'both' serve in full and "
                        "take POST /kv/import")
    p.add_argument("--model", action="append", default=[],
                   help="NAME=SPEC, repeatable: serve several models, one "
                        "engine (slot pool) each, requests routed by their "
                        "'model' field (the first is the default). SPEC: "
                        "random[:seed] at the CLI dims, ckpt:<lm_train "
                        "dir>, or hf:<HF dir>. Exclusive with "
                        "--checkpoint-dir/--hf-checkpoint")
    p.add_argument("--draft-model", default="",
                   help="speculative serving (greedy only): a --model NAME "
                        "or a SPEC (random[:seed], ckpt:<dir> at the "
                        "--draft-* dims, hf:<dir>) registered as 'draft'; "
                        "the default model speculates with it")
    p.add_argument("--spec-gamma", type=int, default=0,
                   help="pin the draft window (0 = autotune from the "
                        "acceptance rate)")
    p.add_argument("--spec-gamma-max", type=int, default=4,
                   help="the autotuned draft window's ceiling")
    p.add_argument("--draft-d-model", type=int, default=64)
    p.add_argument("--draft-n-layers", type=int, default=2)
    p.add_argument("--draft-n-heads", type=int, default=4)
    p.add_argument("--draft-d-ff", type=int, default=256)
    p.add_argument("--mesh", default="",
                   help="tensor-parallel serving over the job's processes, "
                        "e.g. 'tensor=2' or 'data=2,tensor=2' (module "
                        "docstring)")
    return p


def build_serving_mesh(spec_str: str, device_type: str):
    """'data=2,tensor=2' -> a mesh over every process of the job (the JAX
    package's cli/serve.py:231-264). Unnamed axes are 1 (no wildcard -1: a
    server's parallelism is exactly what the operator asked for); the
    sizes' product must be the job's process count."""
    import math

    import torch.distributed as dist

    from ..parallel.mesh import AXIS_ORDER, MeshSpec, build_mesh

    sizes = {}
    for part in spec_str.split(","):
        axis, sep, val = part.strip().partition("=")
        if not sep or axis not in AXIS_ORDER:
            raise SystemExit(
                f"--mesh: expected axis=size pairs over {AXIS_ORDER}, "
                f"got {part!r}")
        try:
            size = int(val)
        except ValueError:
            size = 0
        if size < 1:
            raise SystemExit(
                f"--mesh: axis size must be a positive integer, "
                f"got {part!r}")
        if axis in sizes:
            raise SystemExit(
                f"--mesh: axis {axis!r} given twice — a duplicate would "
                "silently serve with only the last value")
        sizes[axis] = size
    n = math.prod(sizes.values())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise SystemExit(
            f"--mesh needs {n} processes, only {world} in the job")
    if n < world:
        raise SystemExit(
            f"--mesh covers {n} processes, the job has {world}")
    return build_mesh(MeshSpec(**{**{a: 1 for a in AXIS_ORDER}, **sizes}),
                      device_type)


def _join_mesh(args):
    """``--mesh``: join the job, build the mesh and the ranks' lockstep ->
    (mesh, Lockstep); ``args.device`` becomes this rank's device."""
    from .. import train
    from ..parallel.lockstep import Lockstep

    if len(args.model or []) > 1 or args.draft_model:
        raise SystemExit(
            "--mesh serves a single model without a draft (tensor-parallel "
            "speculative/multi-model serving is not wired)")
    info = train.init(device=args.device)
    if info["backend"] is None:
        raise SystemExit("--mesh needs the job's process group: run under "
                         "the TONY_* env contract (TONY_COORDINATOR_ADDRESS,"
                         " TONY_PROCESS_ID, TONY_NUM_PROCESSES)")
    args.device = info["device"]
    mesh = build_serving_mesh(args.mesh, "cpu" if info["backend"] == "gloo"
                              else "cuda")
    return mesh, Lockstep()


def load_model(args):
    """(params, cfg) on ``--device``: the HF checkpoint in
    ``--hf-checkpoint`` at its own dims, or at the CLI's dims a random init
    from ``--seed`` or the latest step of the lm_train checkpoint in
    ``--checkpoint-dir`` (SystemExit when the directory holds none). One
    path with ``--model``'s loader."""
    if args.hf_checkpoint and args.checkpoint_dir:
        raise SystemExit("--hf-checkpoint and --checkpoint-dir are exclusive")
    if args.hf_checkpoint:
        return load_named_model("hf:" + args.hf_checkpoint, args)
    if args.checkpoint_dir:
        return load_named_model("ckpt:" + args.checkpoint_dir, args)
    return load_named_model("random", args)


def load_named_model(spec: str, args, dims: dict | None = None):
    """(params, cfg) on ``--device`` for one ``--model NAME=SPEC`` or
    ``--draft-model`` entry (the JAX package's cli/serve.py:281). SPEC:
    ``random[:seed]`` (a random init at the CLI dims; default seed
    ``--seed``), ``hf:<dir>`` (a HuggingFace Llama or Mistral checkpoint
    at its own dims) or an lm_train checkpoint directory, optionally
    ``ckpt:<dir>`` (its latest step's params). ``dims`` overrides the CLI
    dims (a draft's smaller shape)."""
    import torch

    from ..device import resolve_device
    from ..models import transformer
    from ..models.convert import torch_dtype

    device = resolve_device(args.device)
    if spec.startswith("hf:"):
        from ..models.hf_import import load_hf

        return load_hf(spec[3:], torch_dtype(args.dtype), device)
    d = dict(d_model=args.d_model, n_layers=args.n_layers,
             n_heads=args.n_heads, d_ff=args.d_ff)
    d.update(dims or {})
    cfg = transformer.TransformerConfig(
        vocab_size=args.vocab, d_model=d["d_model"], n_layers=d["n_layers"],
        n_heads=d["n_heads"], n_kv_heads=d["n_heads"], d_ff=d["d_ff"],
        dtype=torch_dtype(args.dtype))
    random_spec = spec == "random" or spec.startswith("random:")
    seed = (int(spec.partition(":")[2]) if random_spec and ":" in spec
            else args.seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = transformer.init(cfg, gen, device)
    if random_spec:
        return params, cfg
    from ..train.checkpoint import restore_lm_params

    return restore_lm_params(spec[5:] if spec.startswith("ckpt:") else spec,
                             params), cfg


def build_registry(args):
    """The model registry the flags describe (the JAX package's
    cli/serve.py:2159) -> (registry, the names that get an engine, the
    draft's name or None). Every served model is a named entry: the
    classic flags register "default"; ``--model NAME=SPEC`` entries
    register in order, the first the default. ``--draft-model`` names an
    entry or loads a SPEC as "draft", which the default model speculates
    with; the draft gets no engine of its own."""
    from ..models.registry import ModelRegistry

    registry = ModelRegistry()
    if args.model:
        if args.hf_checkpoint or args.checkpoint_dir:
            raise SystemExit(
                "--model and the classic --hf-checkpoint/--checkpoint-dir "
                "flags are exclusive: with --model the classic flags would "
                "be ignored; name the checkpoint as a --model entry")
        for item in args.model:
            name, sep, spec = item.partition("=")
            if not sep or not name:
                raise SystemExit(f"--model expects NAME=SPEC, got {item!r}")
            registry.register(name, *load_named_model(spec, args),
                              source=spec)
    else:
        registry.register(
            "default", *load_model(args),
            source=args.hf_checkpoint or args.checkpoint_dir or "random")
    default_name = registry.default.name
    draft_name = None
    if args.draft_model:
        if args.draft_model in registry:
            draft_name = args.draft_model
        else:
            if "draft" in registry:
                raise SystemExit(
                    "--draft-model SPEC registers under the reserved name "
                    "'draft', which --model already claimed: reference that "
                    "entry by name (--draft-model draft) or rename it")
            registry.register("draft", *load_named_model(
                args.draft_model, args, dims=dict(
                    d_model=args.draft_d_model, n_layers=args.draft_n_layers,
                    n_heads=args.draft_n_heads, d_ff=args.draft_d_ff)),
                source=args.draft_model)
            draft_name = "draft"
        if draft_name == default_name:
            raise SystemExit(
                f"--draft-model {args.draft_model!r} names the default "
                "serving model itself: a model cannot be its own draft "
                "(register the draft as a separate --model entry or give "
                "a SPEC)")
        registry.get(default_name).draft = draft_name
    return registry, [n for n in registry.names() if n != draft_name], \
        draft_name


def build_engines(args) -> dict:
    """{name: SlotServer} over the flags' registry, each entry's weights
    prepared once (the float32 masters are dropped), the default model's
    first. One request journal serves every engine (request ids are
    process-wide, and each entry carries its model's name): with
    ``--trace-dir`` (and replay on) it is the directory's file, and the
    unfinished requests a previous process left there are resubmitted,
    each to its model's engine, before serving."""
    from ..models.generate import prepare_decode
    from ..models.serving import SlotServer

    mesh = lockstep = None
    if args.mesh:
        mesh, lockstep = _join_mesh(args)
    registry, names, _ = build_registry(args)
    for entry in registry:
        if entry.name in names:     # a draft stays raw: its engine casts it
            # on a mesh: placed once and the whole masters dropped, so the
            # server holds one sharded copy
            entry.weights = prepare_decode(entry.weights, entry.cfg,
                                           weight_dtype=args.weight_dtype,
                                           mesh=mesh)
    args.lockstep = lockstep
    follower = lockstep is not None and not lockstep.leader
    journal, recovered = None, []
    if args.trace_dir and not args.no_replay and not follower:
        from pathlib import Path

        from ..events.journal import JOURNAL_FILE, RequestJournal

        journal, recovered = RequestJournal.recover(
            Path(args.trace_dir) / JOURNAL_FILE)
        print(f"request journal -> {journal.path}", flush=True)
    budgets = {cls: n for cls, n in (
        ("interactive", args.class_budget_interactive),
        ("batch", args.class_budget_batch)) if n}
    engines = {n: SlotServer(
        registry=registry, model=n, slots=args.slots, max_len=args.max_len,
        block_size=args.block_size, prefill_chunk=args.prefill_chunk,
        kv_dtype=args.kv_dtype, temperature=args.temperature,
        top_k=args.top_k,
        stop_tokens=tuple(int(t) for t in args.stop_tokens.split()),
        pad_id=args.pad_id, seed=args.seed,
        batched_admission=not args.per_slot_admission,
        prefix_cache_blocks=args.prefix_cache_blocks,
        cache_prompts=not args.no_cache_prompts,
        max_queue=args.max_queue, batch_queue_frac=args.batch_queue_frac,
        # a follower replays nothing itself: rank 0's reset sends the queue
        journal=journal, replay=not (args.no_replay or follower),
        paged=args.paged_kv,
        kv_block=args.kv_block, kv_pool_blocks=args.kv_pool_blocks,
        prefill_interleave=args.prefill_interleave,
        class_budgets=budgets or None, role=args.role,
        spec_gamma=args.spec_gamma, spec_gamma_max=args.spec_gamma_max,
        device=args.device) for n in names}
    if recovered:
        # an entry without a model name is the default engine's; one naming
        # a model this process does not serve is dropped, loudly. The
        # engines share the file, so it is compacted once, after every
        # engine journaled its resubmissions
        default = names[0]
        for n, eng in engines.items():
            mine = [e for e in recovered if (e.model or default) == n]
            if mine:
                cnt = eng.recover_journal(mine, compact=False)
                print(f"journal recovery: resumed {cnt} unfinished "
                      f"request(s) for model {n!r} from the previous "
                      "process", flush=True)
        orphans = sorted({e.model for e in recovered
                          if (e.model or default) not in engines})
        if orphans:
            print(f"journal recovery: dropped the entries of models this "
                  f"process does not serve ({orphans})", flush=True)
        journal.compact()
    return engines


def build_server(args):
    """The default model's SlotServer of ``build_engines(args)``."""
    return next(iter(build_engines(args).values()))


def build_app(args) -> "ServeApp | Follower":
    """The ServeApp over ``build_engines(args)`` (not started); with
    ``--mesh``, on a rank other than 0, the ``Follower`` of rank 0's."""
    engines = build_engines(args)
    lockstep = args.lockstep
    if lockstep is not None and not lockstep.leader:
        return Follower(next(iter(engines.values())), lockstep)
    return ServeApp(engines,
                    max_loop_restarts=args.loop_max_restarts,
                    loop_backoff_s=args.loop_backoff_s,
                    trace_dir=args.trace_dir,
                    journal_checkpoint_s=(0.0 if args.no_replay
                                          else args.journal_checkpoint_s),
                    lockstep=lockstep)


class Follower:
    """A ``serve --mesh`` rank other than 0: no front door; its engine
    follows rank 0's turns (parallel/lockstep.py) until rank 0 stops."""

    def __init__(self, server, lockstep):
        self.server, self.lockstep = server, lockstep

    def run(self) -> str:
        from ..parallel.lockstep import follow

        try:
            return follow(self.server, self.lockstep)
        finally:
            self.server.shutdown()


# beside requests.trace.jsonl under --trace-dir: the latency histograms'
# bucket state, written at shutdown and restored at startup
TELEMETRY_STATE_FILE = "telemetry.state.json"


class ServingLoopError(RuntimeError):
    """The serving loop died; the message carries the cause."""


class UnknownModelError(ValueError):
    """The request names a model this process does not serve (HTTP 400:
    never a silent fallback to other weights)."""


class ServeApp:
    """The serving loop + request rendezvous (the JAX package's
    cli/serve.py:339). One lock guards the engines (a SlotServer is not
    thread-safe); HTTP threads enqueue under it and block on a per-request
    event the loop thread sets at completion.

    Multi-model serving: ``server`` is a ``{name: SlotServer}`` dict (one
    engine, one slot pool, a registry entry) or one engine (under its
    model's name). Requests route by their ``model`` (none: the first
    engine, ``server``; an unknown name: ``UnknownModelError``, a 400),
    and the one loop thread steps every busy engine round-robin. Cancel,
    progress and journal sealing follow a request to its engine. /stats
    is the default engine's payload with the load counters summed over
    the engines and ``models``, each engine's own.

    A step failure is not terminal: the loop fails only the requests whose
    in-flight work died, re-arms the slot state through the engine's
    ``reset()`` (weights untouched) and restarts after an exponential
    backoff, up to ``max_loop_restarts`` consecutive failures (a turn that
    dispatches to the device re-arms the streak). ``/healthz`` reports
    ``degraded`` while a restart is pending and 503 ``down`` once the
    budget is spent (or the engine has no ``reset()``); then every waiter
    is failed and new submissions are rejected. ``shutdown(drain=True)``
    stops admission, fails queued requests, and lets in-flight ones finish
    up to a deadline. A waiter that gives up cancels its request.

    ``journal_checkpoint_s`` (0 = off): how often a busy loop turn with no
    completion ready calls the engine's ``checkpoint_progress``, which
    advances the journal (what a replay and /progress resume from) and
    feeds the open token streams, without waiting for the blocks still
    running. ``progress_key``s map
    a caller's names to request ids for ``progress()`` (GET /progress),
    at most 4096, finished requests' keys evicted first.

    Every busy turn feeds ``metrics`` (a ``MetricsAccumulator`` of the
    serving-load gauges, /stats' ``metrics``) and the turn's length into
    the engine's ``loop_turn_s`` histogram. ``trace_dir`` (``serve
    --trace-dir``) makes the engine's trace sink the directory's
    ``requests.trace.jsonl`` and its telemetry persistent across processes
    (``TELEMETRY_STATE_FILE``: restored here, written at ``shutdown``),
    and holds ``capture_profile``'s traces."""

    def __init__(self, server, *, max_loop_restarts: int = 3,
                 loop_backoff_s: float = 0.5, trace_dir: str = "",
                 journal_checkpoint_s: float = 1.0, lockstep=None):
        from ..train.profiling import StepTimer

        if isinstance(server, dict):
            if not server:
                raise ValueError("ServeApp needs at least one engine")
            self.engines = dict(server)
        else:
            self.engines = {
                str(getattr(server, "model", None) or "default"): server}
        # a mesh's rank 0 (parallel/lockstep.py): the one engine recorded
        # for the followers, every turn exchanged with them
        self.lockstep = lockstep
        if lockstep is not None:
            from ..parallel.lockstep import Leader

            if len(self.engines) != 1:
                raise ValueError("a mesh serves one model")
            name, eng = next(iter(self.engines.items()))
            self.engines = {name: Leader(eng, lockstep)}
        # the default model (a nameless request's, and the name /v1
        # responses carry then) and its engine
        self.default_model = next(iter(self.engines))
        self.server = self.engines[self.default_model]
        # the engine of each live request id (cancel, progress, journal
        # seal), dropped at its delivery or failure
        self._rid_engine: dict[int, object] = {}
        self._stepping = None           # the engine inside step()
        self.lock = threading.Lock()
        self.wake = threading.Event()
        self.stop = threading.Event()
        self.status = "ok"              # "ok" | "degraded" | "down"
        self.draining = False
        self.error: str | None = None
        self.max_loop_restarts = max_loop_restarts
        self.loop_backoff_s = loop_backoff_s
        self.journal_checkpoint_s = journal_checkpoint_s
        self._last_checkpoint = 0.0
        self.loop_failures = 0          # step exceptions, cumulative
        self.loop_restarts = 0          # successful reset+restart cycles
        self._restart_streak = 0        # consecutive failures (the budget)
        self._events: dict[int, threading.Event] = {}
        self._results: dict[int, object] = {}
        # client progress keys -> request ids (GET /progress), bounded
        self._progress_keys: collections.OrderedDict[str, int] = \
            collections.OrderedDict()
        self._progress_keys_cap = 4096
        # clients that vanished mid-stream (only the HTTP layer sees a
        # socket die; the handler cancels their requests)
        self.stream_disconnects = 0
        # SSE reconnect: a vanished stream's delivered tokens by request id
        # (its journaled prefix: feeds advance with the journal), popped by
        # a Last-Event-ID reconnect; single use, oldest evicted first
        self._resume_cache: collections.OrderedDict[int, list[int]] = \
            collections.OrderedDict()
        self._resume_cache_cap = 256
        # the fleet autoscaler's remaining scale-up cooldown and the
        # monotonic instant it was set: a 429's Retry-After is at least
        # what is left of it
        self._autoscale_hint: tuple[float, float] = (0.0, 0.0)
        self.metrics = _metrics.MetricsAccumulator()
        self._turn_timer = StepTimer()
        self.trace_dir = trace_dir
        self._trace_writer = None
        # one profiler capture at a time (torch.profiler is process-wide)
        self._profile_lock = threading.Lock()
        if trace_dir:
            self._open_trace_dir()
        self.thread = threading.Thread(
            target=self._loop, name="serve-loop", daemon=True)

    def _open_trace_dir(self) -> None:
        """Point the engine's trace sink at ``requests.trace.jsonl`` and
        resume its histograms from the directory's dump, if any."""
        from pathlib import Path

        from ..events.trace import TraceWriter

        self._trace_writer = TraceWriter(self.trace_dir)
        for eng in self.engines.values():
            eng.trace_sink = self._trace_writer.write
        print(f"request traces -> {self._trace_writer.path}", flush=True)
        path = Path(self.trace_dir) / TELEMETRY_STATE_FILE
        if path.exists():
            try:
                self.server.telemetry.restore(json.loads(path.read_text()))
                print(f"telemetry restored from {path}", flush=True)
            except (ValueError, KeyError, TypeError, AttributeError,
                    OSError) as e:
                # a stale or foreign dump, valid JSON of the wrong shape
                # included, must not block startup
                print(f"telemetry state not restored: {e}", flush=True)

    def _close_trace_dir(self) -> None:
        """Persist the histograms (through a temporary file and a rename:
        a crash mid-write leaves the previous dump) and close the trace
        file."""
        from pathlib import Path

        path = Path(self.trace_dir) / TELEMETRY_STATE_FILE
        try:
            with self.lock:
                state = self.server.telemetry.state()
            tmp = path.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(state))
            tmp.rename(path)
        except OSError as e:
            print(f"telemetry state not persisted: {e}", flush=True)
        for eng in self.engines.values():
            eng.trace_sink = None
        self._trace_writer.close()
        self._trace_writer = None

    @property
    def healthy(self) -> bool:
        """The /healthz bool: degraded still serves; down and draining
        are out of rotation."""
        return self.status != "down" and not self.draining

    def start(self):
        self.thread.start()

    def shutdown(self, drain: bool = False, drain_timeout_s: float = 30.0):
        """Stop the loop. ``drain=True`` first parks admission, fails
        queued-but-unstarted requests, and waits up to
        ``drain_timeout_s`` for every in-flight waiter to be answered."""
        if drain and self.thread.is_alive() and self.status != "down":
            with self.lock:
                self.draining = True
                for eng in self.engines.values():
                    eng.pause_admission = True
                    for req in eng.fail_queued():
                        ev = self._events.pop(req.id, None)
                        self._rid_engine.pop(req.id, None)
                        if ev is not None:
                            self._results[req.id] = ServingLoopError(
                                f"request {req.id} failed: server shutting "
                                "down before it was admitted")
                            ev.set()
            deadline = time.monotonic() + drain_timeout_s
            while time.monotonic() < deadline:
                with self.lock:
                    if not self._events and all(
                            e.n_active == 0 for e in self.engines.values()):
                        break
                time.sleep(0.05)
            with self.lock:
                if self._events:    # drain deadline exceeded: fail loudly
                    self._fail_pending(RuntimeError(
                        f"shutdown drain deadline ({drain_timeout_s}s) "
                        "exceeded"))
        self.stop.set()
        self.wake.set()
        self.thread.join(timeout=10)
        for eng in self.engines.values():
            eng.shutdown()
        if self._trace_writer is not None:
            self._close_trace_dir()

    def _fail_pending(self, exc: Exception) -> None:
        """Fail every waiting request with the loop's error, so waiters
        get a ServingLoopError (and open streams an error frame) instead
        of hanging to their timeouts, and seal their journal entries: a client told "failed" must not have
        its request resurrected by a later recovery."""
        for rid, ev in list(self._events.items()):
            self._results[rid] = ServingLoopError(
                f"serving loop failed: {exc!r}")
            self._events.pop(rid, None)
            eng = self._rid_engine.pop(rid, self.server)
            seal = getattr(eng, "seal_journal", None)
            fail_stream = getattr(eng, "fail_stream", None)
            if callable(seal):
                seal(rid)
            # a streamed request's consumer sees the same error, in band
            if callable(fail_stream):
                fail_stream(rid, f"serving loop failed: {exc!r}")
            ev.set()

    def _loop(self):
        from ..parallel.lockstep import LockstepMismatch

        try:
            while not self.stop.is_set():
                try:
                    self._serve()
                    return                  # clean stop
                except LockstepMismatch as e:
                    # a rank's host state diverged: nothing to re-arm
                    print(f"serving loop failed: {e}", flush=True)
                    with self.lock:
                        self.status = "down"
                        self.error = f"{type(e).__name__}: {e}"
                        self._fail_pending(e)
                    return
                except Exception as e:
                    if not self._recover(e):
                        return              # terminally down
        finally:
            if self.lockstep is not None:
                self.lockstep.close(self.error or "")

    def _serve(self):
        """The inner serving loop; any exception out of here is a step
        failure handed to _recover. A turn proves a recovery only when it
        dispatched to the device (the engines' dispatch counters moved).

        Each turn steps every busy engine. One engine's failure neither
        drops the completions another engine drained this turn (they are
        delivered first) nor starves the engines after it: they still
        step, then the first failure goes to _recover, which resets that
        engine alone."""
        from ..parallel.lockstep import run_turn

        def dispatches():
            return tuple((e.admission_dispatches, e.blocks_dispatched)
                         for e in self.engines.values())

        while not self.stop.is_set():
            with self.lock:
                before = dispatches()
                now = time.monotonic()
                ckpt_due = bool(self.journal_checkpoint_s and now
                                - self._last_checkpoint
                                >= self.journal_checkpoint_s)
                if self.lockstep is not None:
                    # the followers' turn: the ops since the last one, this
                    # instant, the checkpoint flag; raises on a rank's
                    # failure
                    self.lockstep.lead(self.server, now, ckpt_due)
                busy, done, step_exc, failed_eng = run_turn(self.engines,
                                                            ckpt_due)
                if step_exc is None:
                    self._stepping = None
                    if busy:
                        if ckpt_due:
                            self._last_checkpoint = now
                        self._observe_load()
                        if (self.status == "degraded"
                                and dispatches() != before):
                            self.status = "ok"
                            self._restart_streak = 0
                            self.error = None
            if done:
                self._deliver(done)
            if step_exc is not None:
                self._stepping = failed_eng     # _recover resets this one
                raise step_exc
            if not busy:
                # the next busy turn must not book this idle gap
                self._turn_timer.reset_interval()
                self.wake.wait(0.02)
                self.wake.clear()
            else:
                # hand the lock over: a busy turn holds it for a whole
                # block's dispatch, and without a yield this thread takes
                # it back before a woken waiter runs, so submissions and
                # /stats would wait for the engine to go idle
                time.sleep(0)

    def _deliver(self, done: dict) -> None:
        with self.lock:
            for rid, comp in done.items():
                ev = self._events.pop(rid, None)
                self._rid_engine.pop(rid, None)
                if ev is None:          # no waiter (timed out / cancelled)
                    continue
                if comp.finish_reason == "expired":
                    self._results[rid] = TimeoutError(
                        f"request {rid} expired in queue before admission")
                else:
                    self._results[rid] = comp
                ev.set()

    def _recover(self, exc: Exception) -> bool:
        """Handle a serving-loop failure: reset the engine and report True
        to restart, or flip terminally down and report False."""
        print("serving loop failed:\n" + traceback.format_exc(), flush=True)
        # the failed turn and the backoff are not a scheduling turn
        self._turn_timer.reset_interval()
        with self.lock:
            self.loop_failures += 1
            self._restart_streak += 1
            self.error = f"{type(exc).__name__}: {exc}"
            # reset the engine whose step died; the others' state is intact
            reset = getattr(self._stepping or self.server, "reset", None)
            if not callable(reset):
                self.status = "down"
                self._fail_pending(exc)
                return False
            if self._restart_streak > self.max_loop_restarts:
                self.status = "down"
                self.error += (f" (restart budget of "
                               f"{self.max_loop_restarts} exhausted)")
                self._fail_pending(exc)
                return False
            self.status = "degraded"
            try:
                lost = reset()
            except Exception as e2:
                print("serving reset failed:\n" + traceback.format_exc(),
                      flush=True)
                self.status = "down"
                self.error = f"reset failed: {type(e2).__name__}: {e2}"
                self._fail_pending(e2)
                return False
            # fail ONLY the requests whose in-flight work died; queued
            # waiters ride through the restart
            for rid in lost:
                ev = self._events.pop(rid, None)
                self._rid_engine.pop(rid, None)
                if ev is not None:
                    self._results[rid] = ServingLoopError(
                        f"request {rid} lost to a serving-loop failure: "
                        f"{self.error}")
                    ev.set()
            self.loop_restarts += 1
            backoff = min(
                self.loop_backoff_s * (2 ** (self._restart_streak - 1)),
                10.0)
        # back off outside the lock: waiters can time out or submit
        return not self.stop.wait(backoff)

    # ------------------------------------------------------------ requests

    def _engine_for(self, model: str | None):
        """A request's engine by its ``model`` (None: the default)."""
        if model is None:
            return self.server
        eng = self.engines.get(str(model))
        if eng is None:
            raise UnknownModelError(
                f"unknown model {model!r}; this process serves "
                f"{sorted(self.engines)}")
        return eng

    def _progress_of(self, rid: int):
        """A live request's journaled progress from its engine, or None."""
        prog = getattr(self._rid_engine.get(rid, self.server), "progress",
                       None)
        return prog(rid) if callable(prog) else None

    def submit_async(self, prompt, max_new_tokens: int,
                     timeout: float = 600.0,
                     temperature: float | None = None,
                     top_k: int | None = None,
                     stop: list | None = None, logprobs: int = 0,
                     priority: str = "interactive",
                     model: str | None = None,
                     cache_prompt: bool | None = None,
                     resume_tokens: list | None = None,
                     progress_key: str | None = None,
                     stream=None, trace=None):
        """Admission half of generate(): returns (request_id, event). The
        request carries ``timeout`` as its queue deadline.
        ``resume_tokens`` teacher-forces an already-emitted prefix (the
        completion's tokens include it); ``progress_key`` registers a
        caller's name for the request with ``progress()``. ``stream`` (an
        ``api.stream.TokenStream``) is attached in the same locked step as
        the submit, so no token slips between them; ``trace`` (a
        ``TraceContext``) is journaled with the request."""
        from ..models.serving import Request

        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k,
                      cache_prompt=cache_prompt,
                      deadline=time.monotonic() + timeout,
                      resume_tokens=resume_tokens, stop=stop,
                      logprobs=int(logprobs or 0),
                      priority=str(priority or "interactive"), model=model,
                      trace=trace)
        ev = threading.Event()
        engine = self._engine_for(model)
        # health check + registration + submit are one step against the
        # loop's failure handler, which fails registered events under it
        with self.lock:
            if self.status == "down":
                raise ServingLoopError(f"serving loop is down: {self.error}")
            if self.draining:
                raise ServingLoopError(
                    "server is draining; not accepting requests")
            self._events[req.id] = ev
            try:
                engine.submit(req)          # may shed: QueueFullError
            except Exception:
                self._events.pop(req.id, None)
                raise
            self._rid_engine[req.id] = engine
            if stream is not None:
                attach = getattr(engine, "attach_stream", None)
                if callable(attach):
                    attach(req.id, stream)
                else:       # an engine without streams (test stand-ins)
                    stream.fail("engine does not support streaming")
            if progress_key:
                self._progress_keys[str(progress_key)] = req.id
                if len(self._progress_keys) > self._progress_keys_cap:
                    self._evict_progress_keys_locked()
        self.wake.set()
        return req.id, ev

    def _evict_progress_keys_locked(self) -> None:
        """Shrink the key map to its cap: finished requests' keys first,
        oldest first (the journal says which ids are live), then the
        oldest of the rest. Evicting by age alone would drop a long
        decode's key while dead keys stayed."""
        for key in list(self._progress_keys):
            if len(self._progress_keys) <= self._progress_keys_cap:
                return
            if self._progress_of(self._progress_keys[key]) is None:
                del self._progress_keys[key]
        while len(self._progress_keys) > self._progress_keys_cap:
            self._progress_keys.popitem(last=False)

    def progress(self, keys) -> dict:
        """The GET /progress payload: per key, its live request's replay
        state ({tokens, prompt_tokens}) from the journal. Unknown keys
        and finished requests are absent."""
        out = {}
        with self.lock:
            for key in keys:
                rid = self._progress_keys.get(key)
                p = None if rid is None else self._progress_of(rid)
                if p is not None:
                    out[key] = p
        return out

    def take_result(self, request_id: int):
        res = self._results.pop(request_id)
        if isinstance(res, Exception):   # the loop failed this request
            raise res
        return res

    def discard_result(self, request_id: int) -> None:
        """A streamed request's cleanup: its terminal went out through the
        stream, so its waiter event and any stored result are dropped
        unread (under the lock, against ``_deliver``)."""
        with self.lock:
            self._events.pop(request_id, None)
            self._results.pop(request_id, None)

    def note_stream_disconnect(self) -> None:
        with self.lock:
            self.stream_disconnects += 1

    def save_resume_prefix(self, request_id: int, tokens) -> None:
        """Park a vanished stream's delivered tokens for a ``Last-Event-ID``
        reconnect (the handler collects what the stream fed it, which is
        the journaled prefix)."""
        toks = [int(t) for t in tokens]
        if not toks:
            return
        with self.lock:
            self._resume_cache[int(request_id)] = toks
            self._resume_cache.move_to_end(int(request_id))
            while len(self._resume_cache) > self._resume_cache_cap:
                self._resume_cache.popitem(last=False)

    def resume_prefix(self, request_id: int) -> list | None:
        """The prefix a ``Last-Event-ID: <rid>:<n>`` reconnect resumes
        from, or None for an unknown rid (the reconnect is then a fresh
        request). The parked prefix first (single use: popped); a rid
        still live means the client came back before the server saw the
        old connection die: that request is cancelled (its slot goes back
        to live traffic) and its journaled prefix resumed."""
        rid = int(request_id)
        with self.lock:
            toks = self._resume_cache.pop(rid, None)
            if toks is not None:
                return toks
            p = self._progress_of(rid)
        if p is None:
            return None
        self.cancel(rid)
        return [int(t) for t in p.get("tokens", [])] or None

    def import_async(self, payload, timeout: float = 600.0, stream=None,
                     trace=None):
        """The decode leg of a KV transfer (POST /kv/import): install a
        prefill replica's exported payload in the engine and register a
        waiter as ``submit_async`` does -> (request_id, event). The
        payload is decoded and verified before the serving lock is taken
        (the engine's ``prepare_import``: a long prompt's payload is tens
        of MB to hash). ValueError on damage (the caller re-prefills from
        the prompt instead), QueueFullError when no slot or pool blocks
        are free now. ``timeout`` is the caller's wait; an imported request
        has no queue deadline (it never queues)."""
        engine = self._engine_for(
            payload.get("model") if isinstance(payload, dict) else None)
        prep = getattr(engine, "prepare_import", None)
        imp = getattr(engine, "import_blocks", None)
        if not callable(prep) or not callable(imp):
            raise ValueError("this engine does not support KV import")
        prepared = prep(payload)        # ValueError propagates
        with self.lock:
            if self.status == "down":
                raise ServingLoopError(f"serving loop is down: {self.error}")
            if self.draining:
                raise ServingLoopError(
                    "server is draining; not accepting requests")
            rid = imp(prepared, trace=trace)    # QueueFullError propagates
            ev = threading.Event()
            self._events[rid] = ev
            self._rid_engine[rid] = engine
            if stream is not None:
                engine.attach_stream(rid, stream)
        self.wake.set()
        return rid, ev

    def export_payload(self, request_id: int) -> dict:
        """Pop a prefilled request's KV handoff payload (it rides the
        /generate answer of a prefill-role replica). Encoded outside the
        serving lock: the engine's stash has its own. KeyError when there
        is none (the bounded stash aged it out): the router then
        re-prefills on a decode replica."""
        for eng in self.engines.values():
            exp = getattr(eng, "export_blocks", None)
            if callable(exp):
                try:
                    return exp(request_id)
                except KeyError:
                    continue
        raise KeyError(f"no KV export payload for request {request_id}")

    def cancel(self, request_id: int) -> bool:
        """Drop the waiter and stop the request wherever it is."""
        with self.lock:
            self._events.pop(request_id, None)
            self._results.pop(request_id, None)
            eng = self._rid_engine.pop(request_id, self.server)
            srv_cancel = getattr(eng, "cancel", None)
            return bool(callable(srv_cancel) and srv_cancel(request_id))

    def generate(self, prompt, max_new_tokens: int, timeout: float = 600.0,
                 temperature: float | None = None,
                 top_k: int | None = None, model: str | None = None):
        rid, ev = self.submit_async(prompt, max_new_tokens, timeout=timeout,
                                    temperature=temperature, top_k=top_k,
                                    model=model)
        if not ev.wait(timeout):
            self.cancel(rid)     # free the slot, don't decode for nobody
            raise TimeoutError(
                f"request {rid} timed out after {timeout}s; cancelled")
        return self.take_result(rid)

    # ------------------------------------------------------- observability

    def _observe_load(self) -> None:
        """Feed the serving-load gauges (under the lock, once a busy
        turn), the turn's length into ``loop_turn_s``, and the TTFT and
        TPOT quantiles back into the accumulator as gauges."""
        m, eng = self.metrics, self.server
        engines = list(self.engines.values())

        def total(attr):
            return float(sum(getattr(e, attr, 0) for e in engines))

        m.observe(_metrics.SERVING_ACTIVE_SLOTS, total("n_active"))
        m.observe(_metrics.SERVING_QUEUE_DEPTH, total("pending"))
        computed = total("prefill_tokens_computed")
        reused = total("prefill_tokens_reused")
        if computed + reused > 0:
            m.observe(_metrics.SERVING_PREFILL_REUSED_FRAC,
                      reused / (computed + reused))
        m.observe(_metrics.SERVING_SHED_TOTAL, total("shed_requests"))
        m.observe(_metrics.SERVING_CANCELLED_TOTAL,
                  total("cancelled_requests"))
        m.observe(_metrics.SERVING_EXPIRED_TOTAL, total("expired_requests"))
        m.observe(_metrics.SERVING_LOOP_RESTARTS, float(self.loop_restarts))
        tel = getattr(eng, "telemetry", None)
        if tel is not None:
            # the turn is the process's (one thread steps every engine):
            # it goes into the default engine's loop_turn_s
            dt = self._turn_timer.tick()
            if dt is not None:
                tel.observe("loop_turn_s", dt)
            ttft, tpot = (self._merged_hist(name) for name in
                          ("ttft_s", "tpot_s"))
            if ttft.count:
                m.observe(_metrics.SERVING_TTFT_P50_S, ttft.quantile(0.5))
                m.observe(_metrics.SERVING_TTFT_P99_S, ttft.quantile(0.99))
            if tpot.count:
                m.observe(_metrics.SERVING_TPOT_P50_S, tpot.quantile(0.5))
                m.observe(_metrics.SERVING_TPOT_P99_S, tpot.quantile(0.99))
        est = getattr(eng, "estimate_retry_after", None)
        if callable(est):
            m.observe(_metrics.SERVING_RETRY_AFTER_S, float(est()))

    def _merged_hist(self, name: str):
        """One telemetry histogram over every engine (the engine's own
        with one engine); the buckets are shared, so they merge."""
        from ..observability import Histogram

        hists = [e.telemetry.hist[name] for e in self.engines.values()]
        if len(hists) == 1:
            return hists[0]
        out = Histogram()
        for h in hists:
            out.merge(h)
        return out

    def set_autoscale_hint(self, cooldown_s: float) -> None:
        """Record the fleet autoscaler's remaining scale-up cooldown: every
        429's Retry-After advertises at least what is left of it (it
        decays with the wall clock); 0 clears it."""
        with self.lock:
            self._autoscale_hint = (max(0.0, float(cooldown_s)),
                                    time.monotonic())

    def _autoscale_hint_remaining_locked(self) -> float:
        hint, t0 = self._autoscale_hint
        if hint <= 0.0:
            return 0.0
        return max(0.0, hint - (time.monotonic() - t0))

    def retry_after_s(self, engine_estimate: float | None = None) -> int:
        """A 429's Retry-After: the larger of the engine's estimate (the
        one a shed carried, else asked now) and the autoscaler's remaining
        cooldown, in [1, 60]; 1 when the engine has no estimator or it
        fails."""
        est = 0.0
        if engine_estimate is not None:
            try:
                est = float(engine_estimate)
            except (TypeError, ValueError):
                est = 0.0
        else:
            fn = getattr(self.server, "estimate_retry_after", None)
            if callable(fn):
                try:
                    with self.lock:
                        est = float(fn())
                except Exception:
                    est = 0.0
        with self.lock:
            cooldown = self._autoscale_hint_remaining_locked()
        return max(1, min(60, int(math.ceil(max(est, cooldown, 1.0)))))

    def prometheus_metrics(self) -> str:
        """The GET /metrics payload: the /stats numbers as gauges and
        counters, the paged pool's families under ``--paged-kv``, the
        latency histograms and the ``metrics`` snapshot. The numbers and
        copies of the histograms are taken in one hold of the serving
        lock (the loop feeds the histograms under it, and a busy turn
        holds it for a block's dispatch: a second hold would wait for a
        second turn); the text is rendered after it is released."""
        from ..observability import (
            TELEMETRY_HISTOGRAMS,
            Histogram,
            PromRenderer,
        )

        tel = getattr(self.server, "telemetry", None)
        tracker = getattr(self.server, "dispatch_tracker", None)
        hists = {}
        # each engine's own latency histograms and speculative ones,
        # copied for its {model=...} series
        per_model: dict = {name: {} for name in self.engines}
        with self.lock:
            st = self._stats_locked()
            if tel is not None:
                for name in TELEMETRY_HISTOGRAMS:
                    hists[name] = Histogram()
                    hists[name].merge(self._merged_hist(name))
                for mname, eng in self.engines.items():
                    copies = per_model[mname]
                    for name in ("ttft_s", "tpot_s", "queue_wait_s",
                                 "e2e_s"):
                        copies[name] = copy.deepcopy(
                            eng.telemetry.hist[name])
                    if getattr(eng, "_spec", False):
                        copies["accept"] = copy.deepcopy(eng.spec_accept_hist)
                        copies["rounds"] = copy.deepcopy(eng.spec_rounds_hist)
        # the tracker's reaper feeds its histograms outside the serving
        # lock: copies under the tracker's own
        ready = tracker.histograms() if tracker is not None else {}
        r = PromRenderer()
        r.gauge("serving_slots", st.get("slots", 0),
                "configured KV-cache slots")
        r.gauge(_metrics.SERVING_ACTIVE_SLOTS, st.get("active", 0),
                "slots holding an unfinished request")
        r.gauge(_metrics.SERVING_QUEUE_DEPTH, st.get("queued", 0),
                "requests waiting for a slot")
        computed = st.get("prefill_tokens_computed", 0)
        reused = st.get("prefill_tokens_reused", 0)
        if computed + reused > 0:
            r.gauge(_metrics.SERVING_PREFILL_REUSED_FRAC,
                    reused / (computed + reused),
                    "fraction of prefill tokens served from the prefix "
                    "cache")
        r.gauge(_metrics.SERVING_RETRY_AFTER_S,
                st.get("retry_after_s", 1),
                "current 429 Retry-After estimate (seconds until a "
                "queue seat frees)")
        for name, key, help_text in (
                (_metrics.SERVING_SHED_TOTAL, "shed",
                 "requests refused with queue full (HTTP 429)"),
                (_metrics.SERVING_CANCELLED_TOTAL, "cancelled",
                 "requests cancelled by their waiter"),
                (_metrics.SERVING_EXPIRED_TOTAL, "expired",
                 "requests whose deadline passed while queued"),
                ("serving_engine_resets_total", "resets",
                 "SlotServer.reset() recoveries"),
                (_metrics.SERVING_REPLAYS_TOTAL, "replays",
                 "requests resumed from a journaled/teacher-forced "
                 "prefix instead of failing (reset replay, journal "
                 "recovery, router-failover resume)"),
                (_metrics.SERVING_REPLAYED_TOKENS_TOTAL,
                 "replayed_tokens",
                 "emitted tokens carried across a death boundary by "
                 "replay (teacher-forced, re-prefilled not re-decoded)"),
                ("serving_blocks_dispatched_total", "blocks_dispatched",
                 "decode blocks dispatched to the device"),
                ("serving_admission_dispatches_total",
                 "admission_dispatches", "prefill programs dispatched"),
                ("serving_prefill_tokens_computed_total",
                 "prefill_tokens_computed",
                 "prompt tokens prefilled through the model"),
                ("serving_prefill_tokens_reused_total",
                 "prefill_tokens_reused",
                 "prompt tokens copied from the prefix cache"),
        ):
            if key in st:
                r.counter(name, st[key], help_text)
        # the streaming families render even at zero: a zero is a fact
        r.gauge(_metrics.SERVING_STREAMS_ACTIVE,
                st.get("streams_active", 0),
                "live per-request SSE token streams")
        r.counter(_metrics.SERVING_STREAMS_OPENED_TOTAL,
                  st.get("streams_opened", 0),
                  "token streams ever attached")
        r.counter(_metrics.SERVING_STREAM_STALLS_TOTAL,
                  st.get("stream_stalls", 0),
                  "stream feeds that found the consumer's chunk queue "
                  "full (backpressure: coalesced, accounted, never "
                  "dropped)")
        r.counter(_metrics.SERVING_STREAM_DISCONNECTS_TOTAL,
                  st.get("stream_disconnects", 0),
                  "clients that vanished mid-stream (mapped onto "
                  "cancel(): the slot returns to live traffic)")
        pk = st.get("paged_kv")
        if pk:
            r.gauge("serving_kv_pool_blocks_total",
                    pk.get("pool_blocks_total", 0),
                    "allocatable KV blocks in the paged pool")
            r.gauge("serving_kv_pool_blocks_free",
                    pk.get("pool_blocks_free", 0),
                    "KV blocks on the free list")
            r.gauge("serving_kv_pool_blocks_used",
                    pk.get("pool_blocks_used", 0),
                    "KV blocks held by slots, the prefix trie, or the "
                    "draft mirror (refcounted)")
            r.gauge("serving_kv_pool_blocks_peak",
                    pk.get("pool_blocks_peak", 0),
                    "high-water mark of used KV blocks")
            r.counter("serving_kv_admission_defers_total",
                      pk.get("admission_defers", 0),
                      "admissions deferred for pool blocks or a class "
                      "budget (the request stays queued, never fails)")
            r.counter("serving_prefill_chunks_interleaved_total",
                      pk.get("prefill_chunks_interleaved", 0),
                      "prefill chunks dispatched between decode blocks "
                      "(chunked-prefill interleaving)")
            # the pool by owner: slot + trie + shared + free == total
            for state, n in sorted((pk.get("pool_state") or {}).items()):
                r.gauge(_metrics.SERVING_KV_POOL_BLOCKS, n,
                        "KV pool blocks by owner: free list, slot "
                        "tables only, prefix trie only, or shared "
                        "(slot+trie at once)", labels={"state": state})
            r.counter(_metrics.SERVING_KV_EXPORTS_TOTAL,
                      pk.get("kv_exports", 0),
                      "finished prefills serialized for handoff")
            r.counter(_metrics.SERVING_KV_IMPORTS_TOTAL,
                      pk.get("kv_imports", 0),
                      "transfer payloads installed into the local pool")
            r.counter(_metrics.SERVING_KV_IMPORT_REJECTS_TOTAL,
                      pk.get("kv_import_rejects", 0),
                      "transfer payloads rejected (version/geometry/"
                      "checksum damage; the router re-prefills via "
                      "journal replay)")
            for cls, used in sorted((pk.get("class_used") or {}).items()):
                r.gauge("serving_kv_class_blocks_used", used,
                        "KV blocks exclusively held per admission tier "
                        "(COW/shared blocks are unattributed)",
                        labels={"class": cls})
        for cls, n in sorted((st.get("shed_by_class") or {}).items()):
            r.counter("serving_shed_by_class_total", n,
                      "requests shed per admission tier (queue-full "
                      "429s plus batch displacements by interactive "
                      "arrivals)", labels={"class": cls})
        loop = st.get("loop", {})
        r.counter(_metrics.SERVING_LOOP_RESTARTS,
                  loop.get("restarts", self.loop_restarts),
                  "successful serving-loop recoveries")
        r.counter("serving_loop_failures_total",
                  loop.get("failures", self.loop_failures),
                  "serving-loop step failures")
        r.gauge("serving_loop_up",
                0 if loop.get("status", self.status) == "down" else 1,
                "1 unless the serving loop is terminally down")
        for name, h in hists.items():
            r.histogram("serving_" + name[:-2] + "_seconds", h,
                        TELEMETRY_HISTOGRAMS[name])
        # device time: dispatch -> ready a program kind, and the tracker's
        # counters (the /stats device snapshot taken with the numbers)
        if tracker is not None:
            dev = st["device"]
            for kind, h in sorted(ready.items()):
                r.histogram("serving_dispatch_ready_seconds", h,
                            "dispatch -> device-ready latency per program "
                            "kind (reaper-measured on CUDA events, off the "
                            "serving thread)", labels={"kind": kind})
            r.gauge("serving_inflight_dispatches", dev.get("in_flight", 0),
                    "device programs dispatched but not yet observed ready "
                    "(the measured pipeline depth)")
            r.counter("serving_dispatches_tracked_total",
                      dev.get("tracked", 0),
                      "dispatches registered with the tracker")
            r.counter("serving_dispatch_track_dropped_total",
                      dev.get("dropped", 0),
                      "dispatches untracked because the reaper fell behind "
                      "(telemetry loss, not request loss)")
            r.counter("serving_dispatch_reap_errors_total",
                      dev.get("reap_errors", 0),
                      "tracked fences whose wait raised (died with a "
                      "failed dispatch)")
        for entry in st.get("metrics", []):
            r.gauge("serving_task_metric", entry["value"],
                    "MetricsAccumulator snapshot (max_/avg_ per gauge)",
                    labels={"name": entry["name"]})
        self._render_models(r, st, per_model)
        return r.render()

    def _render_models(self, r, st: dict, per_model: dict) -> None:
        """The {model=...} partition (the JAX package's cli/serve.py:1340):
        an info gauge a registered serving model, its load and latency
        families, and a speculative engine's families."""
        for name in self.engines:
            lab = {"model": name}
            r.gauge(_metrics.SERVING_MODELS, 1,
                    "registered serving models (info gauge: one series "
                    "per model, value 1)", labels=lab)
            est = st["models"].get(name) or {}
            r.gauge(_metrics.SERVING_ACTIVE_SLOTS, est.get("active", 0),
                    "slots holding an unfinished request", labels=lab)
            r.gauge(_metrics.SERVING_QUEUE_DEPTH, est.get("queued", 0),
                    "requests waiting for a slot", labels=lab)
            for fam, key in (
                    (_metrics.SERVING_SHED_TOTAL, "shed"),
                    (_metrics.SERVING_CANCELLED_TOTAL, "cancelled"),
                    (_metrics.SERVING_EXPIRED_TOTAL, "expired"),
                    (_metrics.SERVING_REPLAYS_TOTAL, "replays"),
                    (_metrics.SERVING_REPLAYED_TOKENS_TOTAL,
                     "replayed_tokens"),
                    ("serving_blocks_dispatched_total",
                     "blocks_dispatched")):
                if key in est:
                    r.counter(fam, est[key], labels=lab)
            copies = per_model.get(name, {})
            for hname in ("ttft_s", "tpot_s", "queue_wait_s", "e2e_s"):
                if hname in copies:
                    r.histogram("serving_" + hname[:-2] + "_seconds",
                                copies[hname], labels=lab)
            spec = est.get("speculative")
            if not spec:
                continue
            r.counter(_metrics.SERVING_SPEC_ROUNDS_TOTAL,
                      spec.get("rounds", 0),
                      "speculative verify rounds dispatched", labels=lab)
            r.counter(_metrics.SERVING_SPEC_PROPOSED_TOKENS_TOTAL,
                      spec.get("proposed_tokens", 0),
                      "draft tokens proposed for verification", labels=lab)
            r.counter(_metrics.SERVING_SPEC_ACCEPTED_TOKENS_TOTAL,
                      spec.get("accepted_tokens", 0),
                      "draft tokens the target accepted", labels=lab)
            r.gauge(_metrics.SERVING_SPEC_GAMMA, spec.get("gamma", 0),
                    "the next verify round's draft window (autotuned from "
                    "the acceptance EWMA, or pinned)", labels=lab)
            if "accept" in copies:
                r.histogram(_metrics.SERVING_SPEC_ACCEPTANCE_RATE,
                            copies["accept"],
                            "per-round draft acceptance rate "
                            "(accepted/gamma, before the budget and stop "
                            "clamps)", labels=lab)
                r.histogram(_metrics.SERVING_SPEC_VERIFY_ROUNDS,
                            copies["rounds"],
                            "verify rounds per completed request",
                            labels=lab)

    def health(self) -> dict:
        """The /healthz payload: ``status`` is ok/degraded/draining/down,
        ``healthy`` the load-balancer bool."""
        with self.lock:
            status = ("draining" if self.draining and self.status != "down"
                      else self.status)
            return {"healthy": self.healthy, "status": status,
                    "error": self.error,
                    "loop_restarts": self.loop_restarts}

    # the /stats keys a multi-model process sums over its engines, so the
    # top-level payload (and /metrics' unlabeled series) is the process's
    _AGGREGATE_STAT_KEYS = (
        "slots", "active", "queued", "shed", "cancelled", "expired",
        "resets", "replays", "replayed_tokens", "blocks_dispatched",
        "admission_dispatches", "prefill_tokens_computed",
        "prefill_tokens_reused", "chaos_faults_injected",
        "streams_active", "streams_opened", "stream_stalls")

    def stats(self) -> dict:
        with self.lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        # one payload an engine, by model name (a router reads the keys as
        # the models this replica serves); the top level is the default
        # engine's, its load counters summed over the engines
        per = {name: eng.stats() for name, eng in self.engines.items()}
        out = dict(per[self.default_model])
        out["models"] = per
        if len(per) > 1:
            for k in self._AGGREGATE_STAT_KEYS:
                if k in out:
                    out[k] = sum(int(p.get(k, 0) or 0) for p in per.values())
        out["loop"] = {"status": self.status,
                       "restarts": self.loop_restarts,
                       "failures": self.loop_failures,
                       "max_restarts": self.max_loop_restarts}
        # only the HTTP layer sees sockets die, so this counter lives here,
        # beside the engine's stream counters
        out["stream_disconnects"] = self.stream_disconnects
        out["pid"] = os.getpid()
        if self.lockstep is not None:
            out["world"] = self.lockstep.world
            out["lockstep"] = self.lockstep.stats()
        # the disaggregation role the fleet router reads; an engine without
        # one (a test stand-in) serves both
        out["role"] = out.get("role") or getattr(self.server, "role", "both")
        out["metrics"] = self.metrics.snapshot()
        return out

    def capture_profile(self, seconds: float) -> dict:
        """GET /debug/profile?seconds=N: record a ``torch.profiler`` trace
        (Chrome-trace JSON) of whatever runs for ``seconds`` into
        ``<trace_dir>/profiles/serve_<unix time>_<N>s/``. Runs on the HTTP
        handler's thread while the serving loop keeps dispatching: the
        card's kernels are recorded process-wide, host operations only on
        the threads the profiler sees. The profiler starts and stops
        between the loop's turns (under its lock), never while a turn
        launches kernels: a capture on the card crashed the process
        natively three times, each while the paged engine dispatched.
        One capture at a time (BlockingIOError otherwise); RuntimeError
        without a trace directory; ValueError outside (0, 120]."""
        from contextlib import ExitStack
        from pathlib import Path

        import torch
        from torch.profiler import ProfilerActivity, profile

        from .. import constants as c

        if not self.trace_dir:
            raise RuntimeError("profiling needs --trace-dir (nowhere to "
                               "write the trace)")
        if not 0 < seconds <= 120:
            raise ValueError("seconds must be in (0, 120]")
        if not self._profile_lock.acquire(blocking=False):
            raise BlockingIOError("a profile capture is already running")
        try:
            out_dir = (Path(self.trace_dir) / c.PROFILE_DIR_NAME
                       / f"serve_{int(time.time())}_{seconds:g}s")
            out_dir.mkdir(parents=True, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof, running = profile(activities=activities), ExitStack()
            with self.lock:
                running.enter_context(prof)
            try:
                time.sleep(seconds)
            finally:
                with self.lock:
                    running.close()
            prof.export_chrome_trace(str(out_dir
                                         / f"trace.{os.getpid()}.json"))
            files = sorted(str(f.relative_to(out_dir))
                           for f in out_dir.rglob("*") if f.is_file())
            return {"dir": str(out_dir), "seconds": seconds, "files": files}
        finally:
            self._profile_lock.release()


def _generate_args(payload: dict, path: str) -> dict:
    """A /generate body -> ServeApp.submit_async keywords plus ``stream``
    (the SSE opt-in: ``"stream": true`` or ``?stream=true``); ValueError
    for anything malformed (the 400 reply)."""
    if "prompt" not in payload:
        raise ValueError("missing 'prompt' (a list of token ids)")
    prompt = payload["prompt"]
    if not isinstance(prompt, list) or not all(
            isinstance(t, int) and not isinstance(t, bool) for t in prompt):
        raise ValueError("prompt must be a JSON list of token ids")
    stream = stream_requested(payload, path)
    cache_prompt = payload.get("cache_prompt")
    # bool("false") is True: coercing would turn a string opt-out into
    # caching the prompt
    if cache_prompt is not None and not isinstance(cache_prompt, bool):
        raise ValueError("cache_prompt must be a JSON boolean")
    resume = payload.get("resume_tokens")
    if resume is not None:
        if not isinstance(resume, list) or not all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in resume):
            raise ValueError("resume_tokens must be a JSON list of ints")
    progress_key = payload.get("progress_key")
    if progress_key is not None and not isinstance(progress_key, str):
        raise ValueError("progress_key must be a string")
    timeout = float(payload.get("timeout_s", 600.0))
    # NaN and Infinity pass float(): a NaN deadline never expires
    if not 0 < timeout < float("inf"):
        raise ValueError("timeout_s must be a positive finite number")
    stop = payload.get("stop")
    if stop is not None and not isinstance(stop, list):
        raise ValueError("stop must be a list of token ids or a list of "
                         "token-id lists")
    # only null means "off": false or 0.0 are malformed, as in the JAX
    # package
    logprobs = payload.get("logprobs", 0)
    if logprobs is None:
        logprobs = 0
    if isinstance(logprobs, bool) or not isinstance(logprobs, int):
        raise ValueError("logprobs must be an integer")
    if stream and logprobs:
        raise ValueError("logprobs are unavailable on streamed requests "
                         "(buffered responses only)")
    priority = payload.get("priority") or "interactive"
    if priority not in ("interactive", "batch"):
        raise ValueError("priority must be 'interactive' or 'batch'")
    model = payload.get("model")
    if model is not None and not isinstance(model, str):
        raise ValueError("model must be a string")
    temp, top_k = payload.get("temperature"), payload.get("top_k")
    return dict(prompt=prompt,
                max_new_tokens=int(payload.get("max_new_tokens", 64)),
                timeout=timeout,
                temperature=None if temp is None else float(temp),
                top_k=None if top_k is None else int(top_k),
                stop=stop, logprobs=logprobs, priority=priority, model=model,
                cache_prompt=cache_prompt, resume_tokens=resume,
                progress_key=progress_key, stream=stream)


def make_handler(app: ServeApp, codec=None):
    """The serve HTTP surface: GET /healthz, /stats, /metrics, /progress
    and /debug/profile, POST /generate (buffered or SSE), /kv/import
    (buffered or SSE), /v1/completions, /v1/chat/completions and
    /autoscale/hint.
    ``codec`` is the /v1 routes' ``api.openai.TokenCodec`` (default
    "ids")."""
    from ..api import openai as oai
    from ..api.stream import (TokenStream, begin_sse, parse_last_event_id,
                              read_json_body, sse_frame)
    from ..models.serving import QueueFullError
    from ..observability import (PROM_CONTENT_TYPE, TRACE_HEADER,
                                 TRACE_ID_RESPONSE_HEADER, TraceContext)

    if codec is None:
        codec = oai.TokenCodec("ids")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):      # quiet; the loop is the log story
            pass

        def _send(self, code: int, obj: dict, headers: dict | None = None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _retry_after(self, exc=None) -> dict:
            """A 429's Retry-After header: the estimate a shed carried
            (else the engine's now), with the autoscaler's hint folded
            in."""
            ra = getattr(exc, "retry_after_s", 0)
            return {"Retry-After": str(app.retry_after_s(
                engine_estimate=ra or None))}

        def _trace_ctx(self) -> TraceContext:
            """This hop's trace context: the inbound X-Tony-Trace header's,
            else a minted root (serve is a front door too)."""
            ctx = TraceContext.from_header(self.headers.get(TRACE_HEADER))
            return ctx if ctx is not None else TraceContext.mint()

        def _client_gone(self) -> bool:
            """True when the client hung up while we wait (a peeked EOF).
            A client that half-closes its send side after the request reads
            as gone too."""
            try:
                r, _, _ = select.select([self.connection], [], [], 0)
                if not r:
                    return False
                return self.connection.recv(1, socket.MSG_PEEK) == b""
            except OSError:
                return True

        def _resume(self) -> tuple[list | None, int]:
            """The ``Last-Event-ID: <rid>:<n>`` reconnect of a streamed
            request -> (its resume prefix, the n acked tokens to withhold);
            (None, 0) for a fresh stream."""
            lei = parse_last_event_id(self.headers.get("Last-Event-ID"))
            if lei is None:
                return None, 0
            prev = app.resume_prefix(lei[0])
            if prev is None:
                return None, 0
            return prev, min(lei[1], len(prev))

        def _relay_sse(self, rid, stream, deadline, frame_fn, final_fn,
                       error_fn, on_disconnect) -> None:
            """Drain one request's TokenStream into SSE frames (the head is
            sent): ``frame_fn(tokens)`` per chunk, ``final_fn(reason)`` at
            the terminal, ``error_fn(message)`` in band. A write failure or
            a peeked EOF means the client vanished: the request is
            cancelled, the disconnect counted and ``on_disconnect`` run
            (it parks the prefix for a reconnect). The peek runs at every
            wake-up, a chunk's too: a write to a closed socket can succeed,
            and chunks may come faster than the wait beat. Past the
            deadline the request is cancelled with an error frame."""
            try:
                for kind, payload in stream.events(poll_s=0.25):
                    if kind == "tokens":
                        if self._client_gone():
                            raise BrokenPipeError("client went away")
                        self.wfile.write(frame_fn(payload))
                        self.wfile.flush()
                    elif kind == "done":
                        self.wfile.write(final_fn(payload))
                        self.wfile.flush()
                        break
                    elif kind == "error":
                        self.wfile.write(error_fn(payload))
                        self.wfile.flush()
                        break
                    elif time.monotonic() >= deadline:
                        app.cancel(rid)
                        self.wfile.write(error_fn(
                            f"request {rid} timed out; cancelled"))
                        self.wfile.flush()
                        break
                    elif self._client_gone():
                        raise BrokenPipeError("client went away")
            except OSError:         # BrokenPipeError, ConnectionResetError
                app.cancel(rid)     # stop decoding for nobody
                # park the prefix before counting the disconnect: a client
                # that sees the count can reconnect at once
                on_disconnect()
                app.note_stream_disconnect()
            finally:
                app.discard_result(rid)
            self.close_connection = True

        def _wait(self, rid, ev, timeout, on_timeout) -> bool:
            """Wait for a buffered request in short beats, so a vanished
            client is noticed and its request cancelled -> whether it
            completed (else it was cancelled and answered, or abandoned)."""
            deadline = time.monotonic() + timeout
            while not ev.wait(0.25):
                if time.monotonic() >= deadline:
                    app.cancel(rid)
                    on_timeout(f"request {rid} timed out after {timeout}s; "
                               "cancelled")
                    return False
                if self._client_gone():
                    app.cancel(rid)     # abandonment: nobody to answer
                    self.close_connection = True
                    return False
            return True

        def do_GET(self):
            if self.path == "/healthz":
                payload = app.health()
                self._send(200 if payload["healthy"] else 503, payload)
            elif self.path == "/stats":
                self._send(200, app.stats())
            elif self.path == "/metrics":
                body = app.prometheus_metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type", PROM_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.partition("?")[0] == "/progress":
                # ?key=a (repeatable) and ?keys=a,b
                qs = parse_qs(urlparse(self.path).query)
                keys = list(qs.get("key", []))
                for ks in qs.get("keys", []):
                    keys.extend(k for k in ks.split(",") if k)
                self._send(200, app.progress(keys))
            elif self.path.partition("?")[0] == "/debug/profile":
                # blocks this handler's thread for the capture while the
                # loop keeps dispatching
                qs = parse_qs(urlparse(self.path).query)
                try:
                    seconds = float(qs.get("seconds", ["2"])[0])
                    result = app.capture_profile(seconds)
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                    return
                except (BlockingIOError, RuntimeError) as e:
                    # a capture running, or no --trace-dir
                    self._send(409, {"error": str(e)})
                    return
                except Exception as e:      # the profiler failed
                    self._send(500, {"error": f"capture failed: {e}"})
                    return
                self._send(200, result)
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            path = self.path.partition("?")[0]
            if path == "/generate":
                self._post_generate()
            elif path == "/v1/completions":
                self._post_openai(chat=False)
            elif path == "/v1/chat/completions":
                self._post_openai(chat=True)
            elif path == "/autoscale/hint":
                self._post_autoscale_hint()
            elif path == "/kv/import":
                self._post_kv_import()
            else:
                self._send(404, {"error": "unknown path"})

        def _post_kv_import(self):
            """The decode leg of a KV transfer: the body is a prefill
            replica's ``"handoff"`` payload verbatim (its keys are the
            pinned ``KV_IMPORT_KEYS``), so ``stream`` and ``timeout_s``
            ride the query string. Then it answers as /generate does:
            buffered, or SSE with ``?stream=true``. A damaged payload is a
            400 (the router re-prefills from the prompt instead), a full
            replica a 429 with Retry-After."""
            qs = parse_qs(urlparse(self.path).query)
            ts = None
            try:
                timeout = float((qs.get("timeout_s") or ["600"])[0])
                if not 0 < timeout < float("inf"):
                    raise ValueError(
                        "timeout_s must be a positive finite number")
                if (qs.get("stream") or ["false"])[0].lower() in (
                        "1", "true", "yes"):
                    ts = TokenStream()
                payload = read_json_body(self)
                ctx = self._trace_ctx()
                rid, ev = app.import_async(payload, timeout=timeout,
                                           stream=ts, trace=ctx)
            except QueueFullError as e:
                self._send(429, {"error": str(e)},
                           headers=self._retry_after(e))
                return
            except ServingLoopError as e:
                self._send(503, {"error": str(e)})
                return
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
                return
            if ts is not None:
                seen = {"n": 0}
                got: list = []

                def frame(toks):
                    toks = [int(t) for t in toks]
                    got.extend(toks)
                    seen["n"] += len(toks)
                    return sse_frame({"tokens": toks},
                                     event_id=f"{rid}:{seen['n']}")

                def final(reason):
                    return sse_frame(
                        {"id": rid, "finish_reason": reason,
                         "n_tokens": seen["n"], "trace_id": ctx.trace_id},
                        event_id=f"{rid}:{seen['n']}")

                def err(msg):
                    return sse_frame({"error": str(msg)})

                begin_sse(self)
                self._relay_sse(
                    rid, ts, time.monotonic() + timeout, frame, final, err,
                    lambda: app.save_resume_prefix(rid, got))
                return
            if not self._wait(rid, ev, timeout,
                              lambda m: self._send(504, {"error": m})):
                return
            try:
                comp = app.take_result(rid)
            except ServingLoopError as e:
                self._send(503, {"error": str(e)})
                return
            except TimeoutError as e:
                self._send(504, {"error": str(e)})
                return
            self._send(200, {"id": comp.id, "tokens": comp.tokens,
                             "finish_reason": comp.finish_reason},
                       headers={TRACE_ID_RESPONSE_HEADER: ctx.trace_id})

        def _post_autoscale_hint(self):
            """The autoscaler's remaining cooldown, ``{"cooldown_s": s}``:
            every 429's Retry-After says at least what is left of it."""
            try:
                cd = float(read_json_body(self).get("cooldown_s", 0.0))
                if not 0 <= cd < float("inf"):
                    raise ValueError("cooldown_s must be a finite number >= 0")
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
                return
            app.set_autoscale_hint(cd)
            self._send(200, {"ok": True, "cooldown_s": cd})

        def _post_generate(self):
            ts, skip = None, 0
            try:
                kw = _generate_args(read_json_body(self), self.path)
                if kw.pop("stream"):
                    resume, skip = self._resume()
                    if resume is not None:
                        kw["resume_tokens"] = resume
                    ts = TokenStream()
                ctx = self._trace_ctx()
                rid, ev = app.submit_async(**kw, stream=ts, trace=ctx)
            except QueueFullError as e:
                # 429 + Retry-After: retry elsewhere or later instead of
                # queueing into a deadline miss
                self._send(429, {"error": str(e)},
                           headers=self._retry_after(e))
                return
            except ServingLoopError as e:
                self._send(503, {"error": str(e)})
                return
            except (KeyError, ValueError, TypeError,
                    NotImplementedError) as e:
                self._send(400, {"error": str(e)})
                return
            if ts is not None:
                # {"tokens": [...]} deltas, then one closing {"id",
                # "finish_reason", "n_tokens", "trace_id"} frame; every
                # frame's id: line is the reconnect cursor <rid>:<abs>, and
                # a resumed stream withholds the first ``skip`` tokens
                seen = {"n": 0}
                got: list = []

                def frame(toks):
                    toks = [int(t) for t in toks]
                    got.extend(toks)
                    start = max(0, skip - seen["n"])
                    seen["n"] += len(toks)
                    new = toks[start:]
                    if not new:
                        return b""
                    return sse_frame({"tokens": new},
                                     event_id=f"{rid}:{seen['n']}")

                def final(reason):
                    return sse_frame(
                        {"id": rid, "finish_reason": reason,
                         "n_tokens": max(0, seen["n"] - skip),
                         "trace_id": ctx.trace_id},
                        event_id=f"{rid}:{seen['n']}")

                def err(msg):
                    return sse_frame({"error": str(msg)})

                begin_sse(self)
                self._relay_sse(
                    rid, ts, time.monotonic() + kw["timeout"], frame, final,
                    err, lambda: app.save_resume_prefix(rid, got))
                return
            if not self._wait(rid, ev, kw["timeout"],
                              lambda m: self._send(504, {"error": m})):
                return
            try:
                comp = app.take_result(rid)
            except ServingLoopError as e:
                self._send(503, {"error": str(e)})
                return
            except TimeoutError as e:
                self._send(504, {"error": str(e)})
                return
            if comp.finish_reason == "shed":
                self._send(429, {"error": f"request {comp.id} shed by "
                                 "admission tiers; retry later"},
                           headers=self._retry_after())
                return
            body = {"id": comp.id, "tokens": comp.tokens,
                    "finish_reason": comp.finish_reason}
            if comp.logprobs is not None:
                body["logprobs"] = comp.logprobs
            if comp.finish_reason == "prefilled":
                # a prefill role's handoff rides the answer the router
                # already waits for; an aged-out stash omits it (the
                # router then re-prefills on a decode replica)
                try:
                    body["handoff"] = app.export_payload(comp.id)
                except KeyError:
                    pass
            self._send(200, body,
                       headers={TRACE_ID_RESPONSE_HEADER: ctx.trace_id})

        def _oai_error(self, code: int, message: str, etype: str,
                       headers: dict | None = None) -> None:
            self._send(code, {"error": {"message": message, "type": etype}},
                       headers=headers)

        def _post_openai(self, chat: bool):
            """The OpenAI-compatible routes, buffered and streamed; the
            payload mapping is ``api.openai``'s."""
            try:
                req = (oai.parse_chat_request if chat
                       else oai.parse_completion_request)(
                    read_json_body(self), codec)
            except (KeyError, ValueError, TypeError) as e:
                self._oai_error(400, str(e), "invalid_request_error")
                return
            model_name = req["model"] or app.default_model
            ts, skip, resume = None, 0, None
            if req["stream"]:
                # the same reconnect contract as /generate's
                resume, skip = self._resume()
                ts = TokenStream()
            ctx = self._trace_ctx()
            try:
                rid, ev = app.submit_async(
                    req["prompt_tokens"], req["max_new_tokens"],
                    timeout=req["timeout_s"],
                    temperature=req.get("temperature"),
                    top_k=req.get("top_k"), resume_tokens=resume,
                    model=req["model"], stream=ts,
                    stop=req.get("stop_sequences"),
                    logprobs=req.get("logprobs", 0),
                    priority=req.get("priority") or "interactive",
                    trace=ctx)
            except QueueFullError as e:
                self._oai_error(429, str(e), "rate_limit_error",
                                headers=self._retry_after(e))
                return
            except ServingLoopError as e:
                self._oai_error(503, str(e), "service_unavailable")
                return
            except (KeyError, ValueError, TypeError,
                    NotImplementedError) as e:
                self._oai_error(400, str(e), "invalid_request_error")
                return
            if ts is not None:
                got: list = []
                frame, final, err = oai.stream_frame_fns(
                    rid, model_name, codec, chat, skip=skip, collect=got,
                    trace_id=ctx.trace_id)
                begin_sse(self)
                self._relay_sse(
                    rid, ts, time.monotonic() + req["timeout_s"], frame,
                    final, err, lambda: app.save_resume_prefix(rid, got))
                return
            if not self._wait(rid, ev, req["timeout_s"],
                              lambda m: self._oai_error(504, m, "timeout")):
                return
            try:
                comp = app.take_result(rid)
            except ServingLoopError as e:
                self._oai_error(503, str(e), "service_unavailable")
                return
            except TimeoutError as e:
                self._oai_error(504, str(e), "timeout")
                return
            if comp.finish_reason == "shed":
                self._oai_error(429, f"request {comp.id} shed by admission "
                                "tiers; retry later", "rate_limit_error",
                                headers=self._retry_after())
                return
            build = oai.chat_response if chat else oai.completion_response
            self._send(200, build(comp.id, model_name, comp.tokens,
                                  comp.finish_reason,
                                  len(req["prompt_tokens"]), codec,
                                  logprobs=comp.logprobs),
                       headers={TRACE_ID_RESPONSE_HEADER: ctx.trace_id})

    return Handler


class ServeHTTPServer(ThreadingHTTPServer):
    """One thread per connection, with a listen backlog for a burst of
    concurrent clients (socketserver's default of 5 resets the rest)."""
    request_queue_size = 128


def make_httpd(app: ServeApp, host: str, port: int,
               codec=None) -> ServeHTTPServer:
    """The HTTP server over ``app`` (port 0: an ephemeral one); ``codec``
    as ``make_handler``'s."""
    return ServeHTTPServer((host, port), make_handler(app, codec))


def main(argv=None) -> int:
    import signal

    from ..api.openai import TokenCodec

    args = build_argparser().parse_args(argv)
    app = build_app(args)
    if isinstance(app, Follower):
        # a mesh rank other than 0: no port, rank 0's turns until it stops
        reason = app.run()
        print(f"rank {app.lockstep.rank}: serving stopped"
              + (f" ({reason})" if reason else ""), flush=True)
        return 0
    app.start()
    httpd = make_httpd(app, args.host, args.port,
                       TokenCodec(args.text_codec,
                                  vocab_size=app.server.cfg.vocab_size))
    # graceful drain on SIGTERM/SIGINT, on a helper thread (httpd.shutdown
    # deadlocks from the serve_forever thread); a second signal exits now
    draining = threading.Event()

    def _drain_and_stop():
        app.shutdown(drain=True, drain_timeout_s=args.drain_timeout_s)
        httpd.shutdown()

    def _on_signal(signum, frame):
        if draining.is_set():
            print("second signal: exiting immediately", flush=True)
            os._exit(128 + signum)
        draining.set()
        print(f"signal {signum}: draining (finishing in-flight requests, "
              f"up to {args.drain_timeout_s}s)", flush=True)
        threading.Thread(target=_drain_and_stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    srv = app.server
    models = ", ".join(f"{n}={e.cfg.n_layers}L d{e.cfg.d_model}"
                       for n, e in app.engines.items())
    draft = f" +draft {srv.draft_model}" if srv.draft_model else ""
    print(f"serving {models}{draft} on "
          f"http://{args.host}:{httpd.server_address[1]} ({srv.slots} slots "
          f"x {srv.max_len} tokens, {srv.device})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        app.shutdown()      # no-op after a completed drain
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
