"""Can two processes on one card form a process group, and which collectives
then run? A probe for a machine with one GPU, where a multi-rank job can
only share the card.

    python -m tony_tpu_torch.tools.rank_probe

Starts two ranks on cuda:0 under the TonY env contract (a free localhost
port) for each backend, NCCL and gloo, each rank a process of its own with
a time limit. A rank joins with ``init_process_group`` and tries, each with
its own outcome, an all_reduce, all_gather_into_tensor,
reduce_scatter_tensor, all_to_all_single and a batch_isend_irecv ring
shift of CUDA tensors, checking each result. It prints one JSON line per
backend: each rank's outcome a step ("ok", the error, or "timeout").
The port's own code never runs two ranks on one card (train/bootstrap.py
takes card ``rank % N``); this only says what the card's machine allows.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from datetime import timedelta

RANK_TIMEOUT_S = 90


def _rank(backend: str, rank: int, port: int) -> dict:
    import torch
    import torch.distributed as dist

    out = {}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=2,
                                timeout=timedelta(seconds=60))
        out["init"] = "ok"
    except Exception as e:  # report what the backend says, then stop
        out["init"] = f"{type(e).__name__}: {e}"[:400]
        return out

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # each collective's own outcome
            out[name] = f"{type(e).__name__}: {e}"[:400]

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        assert t.eq(3.0).all().item(), t

    def all_gather():
        t = torch.full((2,), float(rank), device=dev)
        o = torch.empty(4, device=dev)
        dist.all_gather_into_tensor(o, t)
        assert o.tolist() == [0.0, 0.0, 1.0, 1.0], o

    def reduce_scatter():
        t = torch.arange(4, dtype=torch.float32, device=dev)
        o = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(o, t)
        assert o.tolist() == [4.0 * rank, 4.0 * rank + 2.0], o

    def all_to_all():
        t = torch.tensor([rank * 10.0, rank * 10.0 + 1], device=dev)
        o = torch.empty(2, device=dev)
        dist.all_to_all_single(o, t)
        assert o.tolist() == [float(rank), 10.0 + rank], o

    def ring_shift():
        t = torch.full((3,), float(rank), device=dev)
        o = torch.empty(3, device=dev)
        peer = 1 - rank
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, peer),
                                       dist.P2POp(dist.irecv, o, peer)])
        for r in reqs:
            r.wait()
        assert o.eq(float(peer)).all().item(), o

    for name, fn in (("all_reduce", all_reduce),
                     ("all_gather_into_tensor", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("all_to_all_single", all_to_all),
                     ("batch_isend_irecv", ring_shift)):
        attempt(name, fn)
    dist.destroy_process_group()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def probe(backend: str) -> dict:
    """Both ranks of one backend -> {"backend", "ranks": [outcome, ...]}."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.tools.rank_probe", "--rank",
         str(r), "--backend", backend, "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, TONY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 TONY_PROCESS_ID=str(r), TONY_NUM_PROCESSES="2"))
        for r in range(2)]
    ranks = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            ranks.append({"outcome": f"timeout after {RANK_TIMEOUT_S} s"})
            continue
        lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
        ranks.append(json.loads(lines[-1]) if lines else
                     {"outcome": f"exit {p.returncode}", "stderr":
                      stderr[-600:]})
    return {"backend": backend, "ranks": ranks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--backend")
    ap.add_argument("--port", type=int)
    args = ap.parse_args(argv)
    if args.rank is not None:
        print(json.dumps(_rank(args.backend, args.rank, args.port)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("rank_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()}"
          f" visible; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}")
    for backend in ("nccl", "gloo"):
        print("rank_probe " + json.dumps(probe(backend)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
