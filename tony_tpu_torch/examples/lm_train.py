"""Train the flagship transformer (port of the JAX package's
examples/lm_train.py).

    python -m tony_tpu_torch.examples.lm_train \
        --vocab 32768 --d-model 1024 --n-layers 12 --n-heads 8 --d-ff 4096 \
        --seq-len 2048 --batch-size 8 --steps 30

The same flags, synthetic and ``--data`` paths, held-out eval, checkpoints,
SIGTERM drain to EXIT_PREEMPTED, and result JSON (``final_loss``,
``steps_per_sec``, ``tokens_per_sec``, ``n_params``, ``mesh``) as the JAX
package's script, plus ``losses``, every step's loss of this run (kept on
the device and read once at the end, so no step waits for it).
``--device`` picks the device (default: the GPU, raising without one).
Weights are random from a ``torch.Generator`` seeded 0; synthetic batch i
comes from a generator seeded i, and ``--data`` batch i is the loader's
batch i, so a resumed run sees the same stream as an uninterrupted one.

``--checkpoint-dir`` (train/checkpoint.py): a run resumes from the latest
checkpoint at ``latest_step() + 1`` and takes ``--steps`` steps from there;
it saves ``{"params", "opt_state"}`` every ``--checkpoint-every`` steps
(overlapped with the next steps), at its last step, and at a preemption
drain before it exits EXIT_PREEMPTED (the keep rules drop a save off the
interval, as the JAX package's orbax manager does).

Each step runs the flash forward kernel once per layer and the two flash
backward kernels once per layer on the card. ``--remat`` checkpoints each
layer (models/transformer.py): under ``--remat-policy full`` or ``dots``
the backward runs the flash forward again (twice a layer a step), under
``attn`` it keeps the forward's out and lse (once a layer a step).

``--n-experts`` > 0 trains the Mixture-of-Experts model (top-2 routing,
capacity factor 1.25, the load-balancing loss in the loss: the JAX
package's defaults).

Under the TonY env contract (TONY_COORDINATOR_ADDRESS, TONY_PROCESS_ID,
TONY_NUM_PROCESSES) the script joins the job through ``train.init`` (NCCL
on the card, gloo with ``--device cpu``) and trains on ``--mesh`` over
every rank: ``DP_RULES`` and ring attention when the mesh string names the
``seq`` axis (``seq=-1`` included, which on one rank is a ring of one),
else ``FSDP_TP_RULES``, with ``EP_RULES`` merged in for ``--n-experts``.
Each rank loads its own rows and sequence slice (``loader_shard_info``,
``seq_shard_info``; synthetic batch i is made whole on every rank and
sliced the same way), so the losses are the one-process run's. Rank 0
alone prints, writes ``--metrics-out`` and writes checkpoints (every rank
takes part in a save's gather). Without the contract the script runs one
process on one device, and ``--mesh`` must resolve to one device.

``--mesh expert=N --n-experts E`` splits the experts over the ``expert``
axis (the routing is the global batch's); a ``pipe`` axis replicates the
step over its ranks, as in the JAX package's script (the pipeline
schedules are train/pipeline_step.py's, which neither script drives).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time


def _copy_into(dst: dict, src: dict) -> None:
    """Copy a restored tree into the live one: tensors in place (a DTensor's
    local block), Python scalars (the optimizer's count) by assignment."""
    for key, value in src.items():
        if isinstance(value, dict):
            _copy_into(dst[key], value)
        elif hasattr(value, "to_local"):
            dst[key].to_local().copy_(value.to_local())
        elif hasattr(value, "copy_"):
            dst[key].copy_(value)
        else:
            dst[key] = value


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--mesh", default="fsdp=-1",
                        help="e.g. 'data=2,fsdp=2,tensor=2' or 'seq=8' "
                             "over the job's ranks")
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--n-layers", type=int, default=4)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--d-ff", type=int, default=1024)
    parser.add_argument("--vocab", type=int, default=4096)
    parser.add_argument("--n-experts", type=int, default=0)
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--remat-policy", default="full",
                        choices=("full", "dots", "attn"),
                        help="with --remat: 'full' recomputes everything; "
                             "'dots' saves the matrix products; 'attn' "
                             "saves only the flash forward's out and lse")
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument("--checkpoint-every", type=int, default=50)
    parser.add_argument("--profile-dir", default="")
    parser.add_argument("--metrics-out", default="")
    parser.add_argument("--data", default="",
                        help="token .bin file; empty = synthetic")
    parser.add_argument("--data-seed", type=int, default=0)
    parser.add_argument("--data-raw-dtype", default="uint16",
                        help="dtype for headerless (nanoGPT-style) token files")
    parser.add_argument("--eval-every", type=int, default=0,
                        help="evaluate on a held-out tail split every N "
                             "steps (0=off; needs --data)")
    parser.add_argument("--eval-frac", type=float, default=0.05)
    parser.add_argument("--eval-batches", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="default: the GPU (raises without one)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from tony_tpu_torch import train
    from tony_tpu_torch.constants import ENV_STEP_LOG, EXIT_PREEMPTED
    from tony_tpu_torch.data import (
        device_put_sharded_batch, loader_shard_info, seq_shard_info,
    )
    from tony_tpu_torch.device import resolve_device
    from tony_tpu_torch.models import transformer
    from tony_tpu_torch.models.convert import torch_dtype
    from tony_tpu_torch.parallel import (
        DP_RULES, EP_RULES, FSDP_TP_RULES, merge_rules, mesh_from_string,
        parse_mesh,
    )
    from tony_tpu_torch.parallel.mesh import mesh_shape
    from tony_tpu_torch.train.profiling import StepTimer, trace

    spec = parse_mesh(args.mesh)
    info = train.init(device=args.device)
    try:
        sizes = spec.resolve(info["num_processes"])
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}") from e
    device = resolve_device(info.get("device") or args.device)
    chief = info["process_id"] == 0
    mesh, rules = None, None
    use_ring = spec.seq != 1
    if info["backend"] is not None:
        mesh = mesh_from_string(args.mesh, device.type)
        rules = merge_rules(DP_RULES if use_ring else FSDP_TP_RULES,
                            EP_RULES if args.n_experts else {})
        print(f"process {info['process_id']}/{info['num_processes']}: "
              f"{info['backend']} on {device}, mesh {mesh_shape(mesh)}")
    flag_group = None
    if mesh is not None and info["num_processes"] > 1:
        import torch.distributed as dist

        # the ranks agree on a drain over gloo, on a host tensor, so the
        # check at every step never waits for the card
        flag_group = dist.new_group(backend="gloo")
    cfg = transformer.TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=args.n_heads, n_kv_heads=args.n_heads, d_ff=args.d_ff,
        max_seq_len=args.seq_len, n_experts=args.n_experts,
        dtype=torch_dtype(args.dtype), remat=args.remat,
        remat_policy=args.remat_policy,
    )
    try:
        bundle = train.create_train_step(
            cfg, mesh, rules=rules, device=device,
            sp_impl="ring" if use_ring and mesh is not None else None)
    except NotImplementedError as e:
        raise SystemExit(f"not yet ported: {e}") from e
    params, opt_state = bundle.params, bundle.opt_state
    n_params = transformer.num_params(params)
    if chief:
        print(f"model: {n_params / 1e6:.1f}M params | mesh {sizes} | "
              f"ring={use_ring and mesh is not None} | device {device}")
    # this rank's rows and sequence slice of every global batch
    pi, pc = (loader_shard_info(mesh, info["process_id"],
                                info["num_processes"], rules=bundle.rules)
              if mesh is not None else (0, 1))
    si, sc = (seq_shard_info(mesh, info["process_id"], rules=bundle.rules)
              if mesh is not None else (0, 1))
    cols = slice(si * args.seq_len // sc, (si + 1) * args.seq_len // sc)

    start_step = 0
    mgr = None
    if args.checkpoint_dir:
        from tony_tpu_torch.train.checkpoint import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir,
                                save_interval=args.checkpoint_every)
        latest = mgr.latest_step()
        if latest is not None:
            restored = mgr.restore(
                template={"params": params, "opt_state": opt_state})
            # in place: the step holds these tensors (the autograd leaves
            # and the AdamW moments)
            with torch.no_grad():
                _copy_into({"params": params, "opt_state": opt_state},
                           restored)
            start_step = latest + 1
            if chief:
                print(f"resumed from checkpoint step {latest}")

    loader = None
    if args.data:
        from tony_tpu_torch.data import (
            PrefetchLoader, ShardedBatchLoader, TokenDataset, has_ttpu_magic,
        )

        if has_ttpu_magic(args.data):
            # a TTPU header is parsed strictly: a bad version or dtype must
            # raise, not be read as raw tokens
            dataset = TokenDataset.from_bin(args.data)
        else:
            dataset = TokenDataset.from_raw(args.data,
                                            getattr(np, args.data_raw_dtype))
        corpus_max = dataset.max_token()
        if corpus_max >= args.vocab:
            raise SystemExit(
                f"--data contains token id {corpus_max} >= --vocab "
                f"{args.vocab}; retokenize or raise --vocab")
        val_dataset = None
        if args.eval_every > 0:
            dataset, val_dataset = dataset.split(args.eval_frac)
        shards = dict(process_index=pi, process_count=pc,
                      seq_shard_index=si, seq_shard_count=sc)
        loader = PrefetchLoader(ShardedBatchLoader(
            dataset, args.batch_size, args.seq_len, seed=args.data_seed,
            start_step=start_step, **shards))
        if val_dataset is not None:
            try:
                val_loader = ShardedBatchLoader(
                    val_dataset, args.batch_size, args.seq_len, seed=0,
                    **shards)
            except ValueError as e:
                raise SystemExit(
                    f"eval split too small for evaluation ({e}); raise "
                    "--eval-frac or lower --batch-size/--seq-len") from e

    def to_device(batch):
        return device_put_sharded_batch(batch, mesh, device=device)

    def next_batch(step_i):
        if loader is None:
            gen = torch.Generator(device=device).manual_seed(step_i)
            tokens, targets = train.synthetic_lm_batch(
                gen, args.batch_size, args.seq_len, args.vocab)
            return tokens[pi::pc, cols], targets[pi::pc, cols]
        return to_device(next(loader))

    def run_eval(params) -> float:
        """Mean held-out loss over a fixed deterministic batch set."""
        n = min(args.eval_batches, val_loader.steps_per_epoch)
        total = 0.0
        for i in range(n):
            vt, vy = to_device(val_loader.batch_at(i))
            total += float(bundle.eval_fn(params, vt, vy))
        loss = total / max(n, 1)
        if chief:
            print(f"  eval: loss {loss:.4f} ppl "
                  f"{math.exp(min(loss, 30)):.2f}")
        return loss

    # TONY_STEP_LOG (set by the executor): the step-time JSONL the task
    # monitor samples; standalone runs leave it off
    timer = StepTimer(os.environ.get(ENV_STEP_LOG) or None)

    # preemption drain: a SIGTERM, or the executor's flag file, checkpoints
    # at the next step boundary and exits EXIT_PREEMPTED, so the relaunch
    # resumes instead of restarting
    import signal

    preempted = {"flag": False}
    old_handler = signal.signal(
        signal.SIGTERM, lambda *_: preempted.__setitem__("flag", True))

    def save(step_i: int) -> None:
        # overlapped: the host snapshot happens here, the write behind the
        # next steps
        mgr.save_async(step_i, {"params": params, "opt_state": opt_state})
        timer.note_checkpoint(step_i)

    def preempt_now() -> bool:
        """A drain request on any rank drains every rank at this step (each
        takes part in the save's gather)."""
        flag = preempted["flag"] or timer.preempt_requested
        if flag_group is None:
            return flag
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=flag_group)
        return bool(t)

    def drain_exit(step_i: int) -> int:
        if mgr is not None:
            save(step_i)
            mgr.wait()
            mgr.close()
        print(f"preempted: checkpointed step {step_i}, exiting")
        return EXIT_PREEMPTED

    metrics = None
    losses = []
    last_eval = None
    last_eval_step = -1
    t0 = time.time()
    try:
        with trace(args.profile_dir, enabled=bool(args.profile_dir)):
            for step_i in range(start_step, start_step + args.steps):
                tokens, targets = next_batch(step_i)
                params, opt_state, metrics = bundle.step_fn(
                    params, opt_state, tokens, targets)
                losses.append(metrics["loss"])
                timer.tick(train_step=step_i)
                if preempt_now():
                    return drain_exit(step_i)
                if step_i % 20 == 0 and chief:
                    loss = float(metrics["loss"])   # sync point
                    print(f"step {step_i}: loss {loss:.4f} "
                          f"({timer.steps_per_sec:.2f} steps/s)")
                if (mgr is not None and step_i % args.checkpoint_every == 0
                        and step_i > 0):
                    save(step_i)
                if (loader is not None and args.eval_every > 0
                        and step_i > start_step
                        and step_i % args.eval_every == 0):
                    last_eval = run_eval(params)
                    last_eval_step = step_i
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if loader is not None:
            loader.close()
    final_loss = float(metrics["loss"])
    wall = time.time() - t0
    # final eval, unless the last loop step just ran the same one
    if (loader is not None and args.eval_every > 0
            and last_eval_step != start_step + args.steps - 1):
        last_eval = run_eval(params)
    if mgr is not None:
        save(start_step + args.steps - 1)
        mgr.wait()
        mgr.close()

    tokens_per_step = args.batch_size * args.seq_len
    result = {
        "final_loss": final_loss,
        "steps_per_sec": args.steps / wall,
        "tokens_per_sec": args.steps * tokens_per_step / wall,
        "n_params": n_params,
        "mesh": sizes,
        "losses": [float(x) for x in losses],
    }
    if last_eval is not None:
        result["eval_loss"] = last_eval
        result["eval_ppl"] = math.exp(min(last_eval, 30))
    if not chief:
        return 0
    print(json.dumps(result))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
