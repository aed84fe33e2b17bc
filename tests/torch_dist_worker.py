"""Multi-process helpers for the port's tests: ``run_ranks`` starts one
process a rank under the TonY env contract (gloo on the CPU, a free
localhost port, a time limit of its own) and collects each rank's result.
Run as a script, this file is one rank: it joins the job through
``tony_tpu_torch.train.init(device="cpu")`` and runs one task. It imports
torch and the port only, never JAX."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(task: str, world: int, inputs: dict, tmp_path: Path,
              timeout: float = 120.0, env: dict | None = None) -> list:
    """Run ``task`` on ``world`` gloo ranks -> each rank's result (rank
    order). Raises with the ranks' stderr on a failure; kills every rank
    when the time limit passes, so a hang fails instead of stalling."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, tmp_path / "inputs.pt")
    port = free_port()
    procs = []
    for r in range(world):
        e = dict(os.environ, PYTHONPATH=str(REPO),
                 TONY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 TONY_PROCESS_ID=str(r), TONY_NUM_PROCESSES=str(world),
                 OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, task, str(tmp_path)], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError(f"{task} on {world} ranks passed {timeout} s")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"{task} rank {r} exited {p.returncode}:\n"
                               f"{errs[r][-4000:]}")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ------------------------------------------------------------------ tasks

def _attention(inp: dict, rank: int, world: int) -> dict:
    """Each case of ``inp["cases"]`` ((kind, causal) with kind "xla",
    "flash" or "ulysses") on this rank's sequence block of q, k, v; the
    output block and the gradients of sum(out * g)."""
    from tony_tpu_torch.parallel import (
        make_ring_attention, make_ulysses_attention, mesh_from_string,
    )

    mesh = mesh_from_string(f"seq={world}", "cpu")
    out = {}
    for kind, causal in inp["cases"]:
        if kind == "ulysses":
            fn = make_ulysses_attention(mesh, causal=causal)
        else:
            fn = make_ring_attention(mesh, causal=causal, impl=kind)
        q, k, v = (x.chunk(world, 1)[rank].clone().requires_grad_(True)
                   for x in (inp["q"], inp["k"], inp["v"]))
        o = fn(q, k, v)
        (o * inp["g"].chunk(world, 1)[rank]).sum().backward()
        out[(kind, causal)] = {"out": o.detach(), "dq": q.grad,
                               "dk": k.grad, "dv": v.grad}
    bad = torch.zeros(1, 2, world + 1, 8)
    try:
        make_ulysses_attention(mesh)(bad, bad, bad)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _train(inp: dict, rank: int, world: int) -> dict:
    """``create_train_step`` on ``inp["mesh"]`` from the converted JAX
    parameters; each step on this rank's block of the global batch."""
    from tony_tpu_torch import train
    from tony_tpu_torch.data import loader_shard_info, seq_shard_info
    from tony_tpu_torch.models.convert import config_from_fields
    from tony_tpu_torch.parallel import mesh_from_string

    cfg = config_from_fields(inp["cfg"])
    mesh = mesh_from_string(inp["mesh"], "cpu")
    bundle = train.create_train_step(cfg, mesh, rules=inp.get("rules"),
                                     params=inp["params"], device="cpu",
                                     sp_impl=inp.get("sp_impl"))
    pi, pc = loader_shard_info(mesh, rank, world, rules=bundle.rules)
    si, sc = seq_shard_info(mesh, rank, rules=bundle.rules)
    params, opt, metrics = bundle.params, bundle.opt_state, []
    for tokens, targets in inp["batches"]:
        seq = tokens.shape[1] // sc
        cols = slice(si * seq, (si + 1) * seq)
        params, opt, m = bundle.step_fn(params, opt, tokens[pi::pc, cols],
                                        targets[pi::pc, cols])
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "rules": bundle.rules, "pc": pc, "sc": sc}


def _restore_step(inp: dict, rank: int, world: int) -> dict:
    """Bundle a steps once on ``inp["mesh"]`` and is checkpointed; bundle b
    (other parameters) restores that state with its own trees as the
    template and is given the restored trees: its eval and next step
    against a's on the same batch, and the restored parameters after the
    step against a's."""
    import torch.distributed as dist

    from tony_tpu_torch import train
    from tony_tpu_torch.data import loader_shard_info
    from tony_tpu_torch.models.convert import config_from_fields
    from tony_tpu_torch.parallel import mesh_from_string
    from tony_tpu_torch.train.checkpoint import CheckpointManager

    cfg = config_from_fields(inp["cfg"])
    mesh = mesh_from_string(inp["mesh"], "cpu")
    a = train.create_train_step(cfg, mesh, device="cpu")
    pi, pc = loader_shard_info(mesh, rank, world, rules=a.rules)
    (t0, y0), (t1, y1) = [(t[pi::pc], y[pi::pc]) for t, y in inp["batches"]]
    pa, oa, _ = a.step_fn(a.params, a.opt_state, t0, y0)
    mgr = CheckpointManager(inp["dir"])
    mgr.save(0, {"params": pa, "opt_state": oa})
    mgr.close()
    dist.barrier()   # rank 0's write is on disk
    b = train.create_train_step(
        cfg, mesh, generator=torch.Generator().manual_seed(5), device="cpu")
    got = CheckpointManager(inp["dir"]).restore(
        template={"params": b.params, "opt_state": b.opt_state})
    evals = (float(a.eval_fn(pa, t1, y1)),
             float(b.eval_fn(got["params"], t1, y1)))
    _, _, ma = a.step_fn(pa, oa, t1, y1)
    _, _, mb = b.step_fn(got["params"], got["opt_state"], t1, y1)
    diff = max(float((x.to_local() - y.to_local()).abs().max())
               for (_, x), (_, y) in zip(train.step._leaves(pa),
                                         train.step._leaves(got["params"])))
    return {"evals": evals, "params_diff": diff,
            "metrics": [(float(m["loss"]), float(m["grad_norm"]))
                        for m in (ma, mb)]}


def _lm_train(inp: dict, rank: int, world: int) -> dict:
    """examples/lm_train.py's main with ``inp["argv"]`` (each rank writes
    its own --metrics-out; rank 0 alone writes one); ``inp["step_log"]``,
    formatted with the rank, is the rank's TONY_STEP_LOG."""
    from tony_tpu_torch.examples import lm_train

    if "step_log" in inp:
        os.environ["TONY_STEP_LOG"] = inp["step_log"].format(rank=rank)
    return {"rc": lm_train.main(inp["argv"])}


TASKS = {"attention": _attention, "train": _train,
         "restore_step": _restore_step, "lm_train": _lm_train}


def main() -> int:
    import warnings

    from tony_tpu_torch import train

    warnings.simplefilter("ignore", FutureWarning)
    task, where = sys.argv[1], Path(sys.argv[2])
    info = train.init(device="cpu", timeout_s=60)
    rank, world = info["process_id"], info["num_processes"]
    inp = torch.load(where / "inputs.pt", weights_only=False)
    out = TASKS[task](inp, rank, world)
    torch.save(out, where / f"rank{rank}.pt")
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
