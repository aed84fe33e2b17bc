"""What the training meshes cost across cards, and whether their losses stay
those of one card: the pipeline schedules, expert sharding and the sharded
dense step.

    python -m tony_tpu_torch.tools.train_mesh_cost \
        [--cases gpipe,1f1b,circular,moe_ep4,moe_dp2_ep2,fsdp4,dp2_tp2] \
        [--layers 12] [--steps 4] [--device cpu --d-model 64] [--out FILE]

One process a rank under the TonY env contract (a free localhost port;
``train.init``: NCCL on the cards, rank r on card r, or gloo with
``--device cpu``); every rank runs every case in turn, each on its own
mesh of the four ranks, from the same weights (``transformer.init`` from
``--seed``) and the same synthetic batches:

- ``gpipe``, ``1f1b``: ``create_pipeline_train_step`` at ``pipe=4``, M = 8;
  ``circular``: S = 4, V = 3, M = 8 (bf16, the flagship's widths, B8 x
  2048);
- ``moe_ep4``, ``moe_dp2_ep2``: the MoE step (8 experts, top-2, capacity
  factor 1.25; B4 x 1024) at ``expert=4`` and ``data=2,expert=2``, the
  experts split by ``EP_RULES``;
- ``fsdp4``, ``dp2_tp2``: the dense sharded step (``FSDP_TP_RULES``) at
  ``fsdp=4`` and ``data=2,tensor=2``.

A rank takes rows r::n of each global batch on a batch-split mesh
(data/loader.py); the parent runs the same steps on one card first, on
the batch in the ranks' order (rank 0's rows, then rank 1's: the global
order a MoE's routing sees). Each case reports every step's loss beside
one card's (and the spread of the ranks' losses), the step's wall ms (the
median over the steps after the first, each step synchronised) and each
card's peak allocated memory, beside one card's.

Prints one JSON line, ``train_mesh_cost {...}``, with the card's name and
power limit beside the numbers on the cards.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

RANK_TIMEOUT_S = 1500
WORLD = 4
# name -> (kind, mesh, schedule or None, chunks)
CASES = {
    "gpipe": ("pipeline", "pipe=4", "gpipe", 1),
    "1f1b": ("pipeline", "pipe=4", "1f1b", 1),
    "circular": ("pipeline", "pipe=4", "circular", 3),
    "moe_ep4": ("moe", "expert=4", None, 1),
    "moe_dp2_ep2": ("moe", "data=2,expert=2", None, 1),
    "fsdp4": ("dense", "fsdp=4", None, 1),
    "dp2_tp2": ("dense", "data=2,tensor=2", None, 1),
}
MICROBATCHES = 8
MOE_EXPERTS = 8
# bf16 losses against one card: the meshes reorder bf16 and float32 sums
LOSS_ATOL = 3e-2
# the ranks' losses of one step: a data-parallel rank's is its own share
# plus the others' sum (Plan.global_sum), rounded once more per rank
RANK_LOSS_ATOL = 1e-4


def _cfg(args, kind: str):
    import torch

    from tony_tpu_torch.models import transformer as T

    d = args.d_model or 1024
    return T.TransformerConfig(
        vocab_size=args.vocab or 32768, d_model=d, n_layers=args.layers,
        n_heads=8, n_kv_heads=8, d_ff=4 * d, dtype=torch.bfloat16,
        n_experts=MOE_EXPERTS if kind == "moe" else 0, capacity_factor=1.25)


def _shape(args, kind: str) -> tuple:
    return (args.moe_batch, args.moe_seq) if kind == "moe" else (
        args.batch, args.seq)


def _device(args):
    import torch

    if args.device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _params(args, cfg, dev):
    import torch

    from tony_tpu_torch.models import transformer as T

    return T.init(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                  dev)


def _batches(args, cfg, dev, kind: str) -> list:
    import torch

    from tony_tpu_torch.train.step import synthetic_lm_batch

    b, l = _shape(args, kind)
    return [tuple(x.contiguous() for x in synthetic_lm_batch(
        torch.Generator(device=dev).manual_seed(1000 + i), b, l,
        cfg.vocab_size)) for i in range(args.steps)]


def _ranked(x, n: int):
    """The global batch in the ranks' order: rank 0's rows r::n first."""
    import torch

    return torch.cat([x[i::n] for i in range(n)]) if n > 1 else x


def _steps(bundle, batches, dev) -> tuple:
    """Each step's loss and wall seconds (synchronised)."""
    params, opt = bundle.params, bundle.opt_state
    losses, secs = [], []
    for tok, tgt in batches:
        t0 = time.perf_counter()
        params, opt, m = bundle.step_fn(params, opt, tok, tgt)
        loss = float(m["loss"])
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
    return losses, secs


def _one_card(args, name: str, dev) -> dict:
    """The case's steps on one device, on the batch in the ranks' order ->
    losses, step ms and peak memory."""
    import torch

    from tony_tpu_torch.parallel import parse_mesh
    from tony_tpu_torch.train import create_train_step

    kind, mesh, _, _ = CASES[name]
    cfg = _cfg(args, kind)
    spec = parse_mesh(mesh).resolve(WORLD)
    n = spec["data"] * spec["fsdp"]
    batches = [(_ranked(t, n), _ranked(y, n))
               for t, y in _batches(args, cfg, dev, kind)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    bundle = create_train_step(cfg, device=dev, params=_params(args, cfg, dev))
    losses, secs = _steps(bundle, batches, dev)
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else None)
    del bundle
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": _median_ms([x * 1e3 for x in secs]),
            "peak_gb": peak}


def _case(args, name: str, dev) -> dict:
    """This rank's run of one case on its mesh."""
    import torch

    from tony_tpu_torch.data import loader_shard_info
    from tony_tpu_torch.parallel import (
        EP_RULES, FSDP_TP_RULES, merge_rules, mesh_from_string,
    )
    from tony_tpu_torch.train import create_train_step
    from tony_tpu_torch.train.pipeline_step import create_pipeline_train_step

    kind, desc, schedule, chunks = CASES[name]
    cfg = _cfg(args, kind)
    mesh = mesh_from_string(desc, dev.type)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    batches = _batches(args, cfg, dev, kind)
    if kind == "pipeline":
        bundle = create_pipeline_train_step(
            cfg, mesh, MICROBATCHES, schedule=schedule, num_chunks=chunks,
            device=dev, params=_params(args, cfg, dev))
    else:
        rules = merge_rules(FSDP_TP_RULES,
                            EP_RULES if kind == "moe" else {})
        bundle = create_train_step(cfg, mesh, rules=rules, device=dev,
                                   params=_params(args, cfg, dev))
        pi, pc = loader_shard_info(mesh, int(os.environ["TONY_PROCESS_ID"]),
                                   WORLD, rules=bundle.rules)
        batches = [(t[pi::pc], y[pi::pc]) for t, y in batches]
    losses, secs = _steps(bundle, batches, dev)
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else None)
    del bundle
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": [s * 1e3 for s in secs],
            "peak_gb": peak}


def _rank(args) -> dict:
    from tony_tpu_torch import train

    info = train.init(device=args.device)
    dev = _device(args)
    out = {"rank": info["process_id"], "backend": info["backend"],
           "cases": {}}
    for name in args.cases.split(","):
        out["cases"][name] = _case(args, name, dev)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _job(args, tmp: Path) -> list:
    """The four ranks -> each rank's record (rank order)."""
    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, TONY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   TONY_PROCESS_ID=str(r), TONY_NUM_PROCESSES=str(WORLD))
        if args.device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        argv = [sys.executable, "-m", "tony_tpu_torch.tools.train_mesh_cost",
                "--as-rank", "--out", str(tmp / f"{r}.json")] + _passed(args)
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
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{errs[r][-3000:]}")
    return [json.loads((tmp / f"{r}.json").read_text()) for r in range(WORLD)]


def _passed(args) -> list:
    out = ["--cases", args.cases]
    for name in ("layers", "steps", "batch", "seq", "moe_batch", "moe_seq",
                 "seed", "d_model", "vocab"):
        out += [f"--{name.replace('_', '-')}", str(getattr(args, name))]
    return out + (["--device", args.device] if args.device else [])


def _median_ms(ms: list) -> float:
    """The median step after the first (the first builds and warms)."""
    return statistics.median(ms[1:] if len(ms) > 1 else ms)


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
    p.add_argument("--cases", default=",".join(CASES))
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--moe-batch", type=int, default=4)
    p.add_argument("--moe-seq", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--d-model", type=int, default=0,
                   help="a narrower model (d_ff 4 x d_model) for a CPU run")
    p.add_argument("--vocab", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: the cards (rank r on card r)")
    p.add_argument("--out", default="")
    p.add_argument("--as-rank", action="store_true")
    args = p.parse_args(argv)
    unknown = set(args.cases.split(",")) - set(CASES)
    if unknown:
        raise SystemExit(f"unknown cases {sorted(unknown)}; known: "
                         f"{list(CASES)}")
    if args.as_rank:
        Path(args.out).write_text(json.dumps(_rank(args)))
        return 0

    import torch

    if args.device != "cpu":
        torch.cuda.set_device(0)
    dev = _device(args)
    want, one_ms = {}, {}
    for name in args.cases.split(","):
        kind = CASES[name][0]
        # the pipelines and the dense meshes see one batch order: one
        # card's run serves them all
        key = (kind if kind == "moe" else "dense",
               CASES[name][1] if kind == "moe" else "")
        if key not in want:
            want[key] = _one_card(args, name, dev)
        want[name] = want[key]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _job(args, Path(tmp))
    result = {"card": _card() if dev.type == "cuda" else "cpu",
              "layers": args.layers, "steps": args.steps,
              "backend": ranks[0]["backend"], "cases": {}}
    bad = []
    for name in args.cases.split(","):
        per = [r["cases"][name] for r in ranks]
        losses, one = per[0]["losses"], want[name]
        err = max(abs(a - b) for a, b in zip(losses, one["losses"]))
        spread = max(abs(a - b) for q in per[1:]
                     for a, b in zip(q["losses"], losses))
        if not spread <= RANK_LOSS_ATOL:
            bad.append(f"{name}: the ranks' losses differ by {spread:.3g}")
        if not err <= LOSS_ATOL:
            bad.append(f"{name}: loss max |err| {err:.3g} against one card "
                       f"(atol {LOSS_ATOL})")
        result["cases"][name] = {
            "mesh": CASES[name][1], "losses": losses,
            "one_card_losses": one["losses"], "loss_max_abs_err": err,
            "rank_loss_spread": spread,
            "one_card_step_ms": one["step_ms"],
            "one_card_peak_gb": one["peak_gb"],
            "step_ms_median": [_median_ms(q["step_ms"]) for q in per],
            "step_ms": [q["step_ms"] for q in per],
            "peak_gb": [q["peak_gb"] for q in per]}
    line = "train_mesh_cost " + json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    if bad:
        raise SystemExit("; ".join(bad))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
