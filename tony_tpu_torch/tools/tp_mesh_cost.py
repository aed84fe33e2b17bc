"""What a mesh costs the paged serving engine, and whether its tokens stay
those of one device, measured across cards.

    python -m tony_tpu_torch.tools.tp_mesh_cost \
        [--meshes 'tensor=4;data=2,tensor=2;data=4'] [--layers 4] \
        [--device cpu] [--out FILE]

For each mesh, one process a rank under the TonY env contract (a free
localhost port; ``train.init``: NCCL on the cards, rank r on card r, or
gloo with ``--device cpu``). Every rank builds the paged ``SlotServer``
(models/serving.py) at the flagship's widths and ``--layers`` layers,
float32, random weights from ``--seed``, each rank drawing its block of
each leaf (``transformer.init(place=)``), and serves the same requests
(greedy, ``--requests`` prompts of 256-1024 tokens, ``--new`` new each).
The parent serves them first on one device with the same weights.

Each mesh reports:

- ``tokens_equal``: the requests whose tokens equal the one-device run's
  (float32; the tensor axis reorders float32 sums, so a near tie may
  part);
- ``serve_s``: the mesh's wall time for the requests, beside the one
  device's;
- on a mesh whose batch axes are wider than one (the engine's slots and
  its pool's block axis split over them), the paged view's gather, timed
  on the device by events over ``--reps`` calls: ``gather_ms`` the
  engine's own (``SlotServer._gather_view``), ``own_ms`` a gather of the
  rank's slots from its own blocks alone, and ``local_all_ms`` a gather
  of every slot's rows from the rank's own blocks: the local half of a
  design that reads other ranks' blocks by gathering every batch rank's
  candidates, whose exchange then costs ``gather_ms - local_all_ms``.
  ``view_bytes`` is the rank's own view. Run from another checkout (its
  ``tony_tpu_torch`` first on ``PYTHONPATH``), the tool times that
  tree's engine, so two designs compare in one run on the same cards.

Prints one JSON line, ``tp_mesh_cost {...}``, with the card's name and
power limit beside the numbers on the cards.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

RANK_TIMEOUT_S = 600
FLAGSHIP = dict(vocab_size=32768, d_model=1024, n_heads=8, n_kv_heads=8,
                d_ff=4096)


def _cfg(args):
    import torch

    from tony_tpu_torch.models import transformer as T

    dims = dict(FLAGSHIP)
    if args.d_model:
        dims.update(d_model=args.d_model, d_ff=4 * args.d_model,
                    vocab_size=args.vocab or dims["vocab_size"])
    return T.TransformerConfig(n_layers=args.layers, dtype=torch.float32,
                               **dims)


def _prompts(args, vocab: int) -> list:
    import numpy as np

    rng = np.random.default_rng(args.seed + 1)
    hi = max(2, args.max_len - args.new)
    lens = rng.integers(min(256, hi // 2), min(1024, hi) + 1, args.requests)
    return [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def _serve(engine, prompts: list, new: int, sync) -> tuple:
    """The requests through ``engine`` -> (tokens in order, wall s)."""
    from tony_tpu_torch.models.serving import Request

    sync()
    t0 = time.perf_counter()
    reqs = [Request(prompt=p, max_new_tokens=new) for p in prompts]
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained()
    sync()
    return [done[r.id].tokens for r in reqs], time.perf_counter() - t0


def _device(args):
    import torch

    if args.device == "cpu":
        return torch.device("cpu"), lambda: None
    dev = torch.device("cuda", torch.cuda.current_device())
    return dev, lambda: torch.cuda.synchronize(dev)


def _timer(dev, sync):
    """fn, reps -> ms a call (CUDA events on the card, the host's clock on
    the CPU)."""
    import torch

    def timed(fn, reps):
        fn()
        sync()
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            sync()
            return a.elapsed_time(b) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    return timed


def _gather_costs(engine, dev, sync, reps: int) -> dict:
    """The paged view's gather on a batch-split rank (module docstring)."""
    import numpy as np

    from tony_tpu_torch.models import serving as S

    sh = engine._shard
    pool = engine._kv_pool
    ring = np.arange(engine.max_len)[None, :]
    _, blk, row = S._paged_rows(engine._np_tables, engine._np_offs,
                                engine.kv_block, ring)
    per = pool.k.shape[1] * pool.k.shape[2] * engine.kv_block
    base = (blk * (pool.k.shape[2] * engine.kv_block) + row) % per
    every = S._stage(base, dev)
    own = S._stage(base[sh.lo:sh.lo + sh.s_n], dev)
    timed = _timer(dev, sync)
    view = S._gather_paged_view(pool, own, None)
    return {
        "gather_ms": timed(engine._gather_view, reps),
        "local_all_ms": timed(lambda: S._gather_paged_view(pool, every,
                                                           None), reps),
        "own_ms": timed(lambda: S._gather_paged_view(pool, own, None), reps),
        "view_bytes": sum(t.numel() * t.element_size()
                          for t in S._pool_tensors(view)),
        "batch_ranks": sh.n, "slots_a_rank": sh.s_n,
    }


def _engine(args, weights, cfg, dev, mesh=None):
    from tony_tpu_torch.models.serving import SlotServer

    return SlotServer(weights, cfg, slots=args.slots, max_len=args.max_len,
                      paged=True, device=dev, mesh=mesh)


def _rank(args) -> dict:
    """One rank of a mesh's job (the env contract names it)."""
    import torch

    from tony_tpu_torch import train
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.models.generate import prepare_decode
    from tony_tpu_torch.parallel import (TP_DECODE_RULES, block_placer,
                                         mesh_from_string)

    info = train.init(device=args.device)
    dev, sync = _device(args)
    mesh = mesh_from_string(args.mesh, dev.type)
    cfg = _cfg(args)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init(cfg, gen, dev, place=block_placer(mesh, TP_DECODE_RULES))
    engine = _engine(args, prepare_decode(params, cfg, mesh=mesh), cfg, dev)
    del params
    prompts = _prompts(args, cfg.vocab_size)
    _serve(engine, prompts[:2], 4, sync)            # warm-up
    tokens, wall = _serve(engine, prompts, args.new, sync)
    out = {"rank": info["process_id"], "backend": info["backend"],
           "tokens": tokens, "serve_s": wall,
           "blocks": engine.blocks_dispatched}
    if engine._shard is not None:
        out["gather"] = _gather_costs(engine, dev, sync, args.reps)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _job(args, mesh: str, world: int, tmp: Path) -> list:
    """The ranks of ``mesh`` -> each rank's record (rank order)."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, TONY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   TONY_PROCESS_ID=str(r), TONY_NUM_PROCESSES=str(world))
        if args.device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        argv = [sys.executable, "-m", "tony_tpu_torch.tools.tp_mesh_cost",
                "--as-rank", "--mesh", mesh, "--out",
                str(tmp / f"{r}.json")] + _passed(args)
        procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=RANK_TIMEOUT_S)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"{mesh} rank {r} exited {p.returncode}:\n"
                               f"{errs[r][-3000:]}")
    return [json.loads((tmp / f"{r}.json").read_text()) for r in range(world)]


def _passed(args) -> list:
    out = []
    for name in ("layers", "requests", "new", "slots", "max_len", "seed",
                 "reps", "d_model", "vocab"):
        out += [f"--{name.replace('_', '-')}", str(getattr(args, name))]
    return out + (["--device", args.device] if args.device else [])


def _card() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--meshes", default="tensor=4;data=2,tensor=2;data=4")
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--new", type=int, default=32)
    p.add_argument("--slots", type=int, default=16)
    p.add_argument("--max-len", type=int, default=1088)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--d-model", type=int, default=0,
                   help="a narrower model (d_ff 4 x d_model) for a CPU run")
    p.add_argument("--vocab", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: the cards (rank r on card r)")
    p.add_argument("--out", default="")
    p.add_argument("--mesh", default="")
    p.add_argument("--as-rank", action="store_true")
    args = p.parse_args(argv)
    if args.as_rank:
        Path(args.out).write_text(json.dumps(_rank(args)))
        return 0

    import torch

    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.models.generate import prepare_decode
    from tony_tpu_torch.parallel import parse_mesh

    if args.device != "cpu":
        torch.cuda.set_device(0)
    dev, sync = _device(args)
    cfg = _cfg(args)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    engine = _engine(args, prepare_decode(T.init(cfg, gen, dev), cfg), cfg,
                     dev)
    prompts = _prompts(args, cfg.vocab_size)
    _serve(engine, prompts[:2], 4, sync)
    want, one_s = _serve(engine, prompts, args.new, sync)
    del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result = {"card": _card() if dev.type == "cuda" else "cpu",
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "requests": len(prompts), "new": args.new,
              "slots": args.slots, "max_len": args.max_len,
              "one_device_serve_s": one_s, "meshes": {}}
    for mesh in args.meshes.split(";"):
        spec = parse_mesh(mesh)
        world = 1
        for v in vars(spec).values():
            world *= max(1, int(v))
        with tempfile.TemporaryDirectory() as tmp:
            ranks = _job(args, mesh, world, Path(tmp))
        toks = [r.pop("tokens") for r in ranks]
        if any(t != toks[0] for t in toks[1:]):
            raise RuntimeError(f"{mesh}: the ranks' tokens differ")
        result["meshes"][mesh] = {
            "world": world, "backend": ranks[0]["backend"],
            "tokens_equal": sum(a == b for a, b in zip(toks[0], want)),
            "ranks": ranks}
    line = "tp_mesh_cost " + json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
