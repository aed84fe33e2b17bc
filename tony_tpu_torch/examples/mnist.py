"""Distributed MNIST under the port's launcher (port of the JAX package's
examples/mnist_jax.py).

The worker calls ``tony_tpu_torch.train.init()`` once (the torch runtime's
TONY_* contract: NCCL on the card, gloo with ``--device cpu``), builds the
port's mesh with ``data=-1``, and trains the MLP with Adam on its share of
every global batch; the gradients are averaged over ``data`` with one
all-reduce a step, so N processes step as one process on the whole batch.

The dataset lives on the device and batches are sliced there; training runs
in blocks of ``--steps-per-call`` steps with one host sync a block, and the
rate is the JAX example's TWO-POINT fit: blocks of N and N/2 steps timed in
turns, the per-step time from their difference, so the fixed per-block cost
(the sync, the host's launch latency) cancels. The wall rate is reported
beside it. ``--metrics-out`` takes the JAX example's keys. Nothing compiles,
so there is no ``--compile-cache``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--steps-per-call", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--metrics-out", default="")
    parser.add_argument("--device", default=None,
                        help="default: the GPU (raises without one)")
    args = parser.parse_args(argv)

    t_start = time.time()
    import torch

    from tony_tpu_torch import train
    from tony_tpu_torch.device import resolve_device
    from tony_tpu_torch.models.mnist import (
        accuracy, init_mlp, loss_fn, synthetic_mnist,
    )
    from tony_tpu_torch.parallel import MeshSpec, build_mesh
    from tony_tpu_torch.parallel.mesh import mesh_shape

    t_import = time.time()
    info = train.init(device=args.device)
    device = resolve_device(info.get("device") or args.device)
    group, shard, n_shards = None, 0, 1
    if info["backend"] is not None:
        mesh = build_mesh(MeshSpec(data=-1, fsdp=1), device.type)
        group = mesh.get_group("data")
        shard = mesh.get_local_rank("data")
        n_shards = mesh_shape(mesh)["data"]
        print(f"process {info['process_id']}/{info['num_processes']}: "
              f"{info['backend']} on {device}, data shard {shard} of "
              f"{n_shards}", flush=True)

    bs = args.batch_size
    if bs % n_shards:
        raise SystemExit(f"--batch-size {bs} is not divisible by the "
                         f"{n_shards} data shards")
    x, y = synthetic_mnist(torch.Generator().manual_seed(0), n=8192)
    nb = x.shape[0] // bs
    # staged once on the device as (nb, batch, ...); this process keeps its
    # rows of every batch, and per-step slicing happens on the device
    rows = slice(shard * bs // n_shards, (shard + 1) * bs // n_shards)
    xb_all = x[: nb * bs].reshape(nb, bs, -1)[:, rows].to(device)
    yb_all = y[: nb * bs].reshape(nb, bs)[:, rows].to(device)
    x_eval, y_eval = x[:2048].to(device), y[:2048].to(device)

    params = init_mlp(torch.Generator().manual_seed(1), device=device)
    leaves = [t for layer in params for t in (layer["w"], layer["b"])]
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=args.lr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_ready = time.time()   # the group joined, the data staged on the device

    def run_block(n_steps: int, start: int) -> torch.Tensor:
        """``n_steps`` Adam steps over batches start, start+1, ... (mod
        nb); returns the last step's loss (averaged over the shards) on
        the device, unsynced."""
        for i in range(n_steps):
            j = (start + i) % nb
            loss = loss_fn(params, xb_all[j], yb_all[j])
            grads = torch.autograd.grad(loss, leaves)
            if group is not None:
                flat = torch.cat([g.reshape(-1) for g in grads]
                                 + [loss.detach().reshape(1)])
                torch.distributed.all_reduce(flat, group=group)
                flat /= n_shards
                grads = torch.split(flat[:-1], [t.numel() for t in leaves])
                loss = flat[-1]
            for t, g in zip(leaves, grads):
                t.grad = g.reshape(t.shape)
            opt.step()
        return loss.detach()

    spc = min(args.steps_per_call, args.steps)
    spc_short = max(1, spc // 2)
    # the first block, synced: the user's time to first step
    float(run_block(spc, 0))
    t_first_step = time.time()
    float(run_block(spc_short, spc))

    n_rounds = max(1, args.steps // spc)
    times_long, times_short = [], []
    step = spc + spc_short
    final_loss = float("nan")
    for _ in range(n_rounds):
        # long and short in turns within a round: drift cancels in the
        # difference
        for n, times in ((spc, times_long), (spc_short, times_short)):
            t0 = time.time()
            final_loss = float(run_block(n, step))   # hard sync
            times.append(time.time() - t0)
            step += n

    median_long = statistics.median(times_long)
    median_short = statistics.median(times_short)
    # a non-positive difference means host jitter swamped the device
    # signal: report the (pessimistic) wall rate and flag it
    delta = median_long - median_short
    degenerate = delta <= 0 or spc == spc_short
    step_s = (median_long / spc) if degenerate else delta / (spc - spc_short)
    with torch.no_grad():
        acc = float(accuracy(params, x_eval, y_eval))
    metrics = {
        "steps_per_sec": 1.0 / step_s,
        "two_point_degenerate": degenerate,
        "steps_per_sec_wall": spc / median_long,
        "call_overhead_s": round(median_long - spc * step_s, 5),
        "window_call_times_s": [round(t, 5) for t in times_long],
        "window_call_times_short_s": [round(t, 5) for t in times_short],
        "steps_per_call": spc,
        "steps_per_call_short": spc_short,
        "time_to_first_step_s": t_first_step - t_start,
        "t_start_epoch": t_start,
        "import_s": t_import - t_start,
        "backend_and_data_s": t_ready - t_import,
        "compile_first_block_s": t_first_step - t_ready,
        "final_loss": final_loss,
        "accuracy": acc,
        "num_devices": info.get("num_devices", 1),
        "process": info,
    }
    if info["process_id"] == 0:
        print(json.dumps(metrics), flush=True)
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump(metrics, f)
    if group is not None:
        torch.distributed.destroy_process_group()
    return 0 if acc > 0.5 else 1


if __name__ == "__main__":
    raise SystemExit(main())
