"""Train the flagship transformer on one GPU (port of the JAX package's
examples/lm_train.py, single-device paths).

    python -m tony_tpu_torch.examples.lm_train \
        --vocab 32768 --d-model 1024 --n-layers 12 --n-heads 8 --d-ff 4096 \
        --seq-len 2048 --batch-size 8 --steps 30

The same flags, synthetic and ``--data`` paths, held-out eval, SIGTERM drain
to EXIT_PREEMPTED, and result JSON (``final_loss``, ``steps_per_sec``,
``tokens_per_sec``, ``n_params``, ``mesh``) as the JAX package's script,
plus ``losses``, every step's loss (kept on the device and read once at the
end, so no step waits for it). ``--device`` picks the device (default: the
GPU, raising without one).
Weights are random from a ``torch.Generator`` seeded 0; synthetic batch i
comes from a generator seeded i.

Each step runs the flash forward kernel once per layer and the two flash
backward kernels once per layer on the card.

Not ported yet, each raising: ``--checkpoint-dir`` (the checkpoint slice),
``--remat`` (the remat slice), ``--n-experts`` > 0 (MoE) and a ``--mesh``
wider than one device (mesh/TP); a multi-process job raises in
``train.init``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time


def _not_ported(flag: str, slice_name: str):
    raise SystemExit(f"{flag} is not yet ported to tony_tpu_torch "
                     f"(it comes with the {slice_name} slice)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--mesh", default="fsdp=-1",
                        help="one device only: 'fsdp=-1' (the default) is "
                             "the one card")
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--n-layers", type=int, default=4)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--d-ff", type=int, default=1024)
    parser.add_argument("--vocab", type=int, default=4096)
    parser.add_argument("--n-experts", type=int, default=0)
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--remat-policy", default="full",
                        choices=("full", "dots", "attn"))
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

    if args.checkpoint_dir:
        _not_ported("--checkpoint-dir", "checkpoint")
    if args.remat:
        _not_ported("--remat", "remat")
    if args.n_experts > 0:
        _not_ported("--n-experts", "MoE")

    import numpy as np
    import torch

    from tony_tpu_torch import train
    from tony_tpu_torch.constants import ENV_STEP_LOG, EXIT_PREEMPTED
    from tony_tpu_torch.device import resolve_device
    from tony_tpu_torch.models import transformer
    from tony_tpu_torch.models.convert import torch_dtype
    from tony_tpu_torch.train.profiling import StepTimer, trace

    try:
        mesh = train.mesh_from_string(args.mesh)
    except NotImplementedError:
        _not_ported(f"--mesh {args.mesh}", "mesh/TP")
    train.init()   # raises for a multi-process job
    device = resolve_device(args.device)
    cfg = transformer.TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_layers=args.n_layers,
        n_heads=args.n_heads, n_kv_heads=args.n_heads, d_ff=args.d_ff,
        max_seq_len=args.seq_len, dtype=torch_dtype(args.dtype),
        remat_policy=args.remat_policy,
    )
    bundle = train.create_train_step(cfg, mesh, device=device)
    params, opt_state = bundle.params, bundle.opt_state
    n_params = transformer.num_params(params)
    print(f"model: {n_params / 1e6:.1f}M params | mesh {mesh} | device "
          f"{device}")

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
        loader = PrefetchLoader(ShardedBatchLoader(
            dataset, args.batch_size, args.seq_len, seed=args.data_seed))
        if val_dataset is not None:
            try:
                val_loader = ShardedBatchLoader(
                    val_dataset, args.batch_size, args.seq_len, seed=0)
            except ValueError as e:
                raise SystemExit(
                    f"eval split too small for evaluation ({e}); raise "
                    "--eval-frac or lower --batch-size/--seq-len") from e

    def to_device(batch):
        return tuple(torch.from_numpy(x).to(device, torch.int64)
                     for x in batch)

    def next_batch(step_i):
        if loader is None:
            gen = torch.Generator(device=device).manual_seed(step_i)
            return train.synthetic_lm_batch(gen, args.batch_size,
                                            args.seq_len, args.vocab)
        return to_device(next(loader))

    def run_eval(params) -> float:
        """Mean held-out loss over a fixed deterministic batch set."""
        n = min(args.eval_batches, val_loader.steps_per_epoch)
        total = 0.0
        for i in range(n):
            vt, vy = to_device(val_loader.batch_at(i))
            total += float(bundle.eval_fn(params, vt, vy))
        loss = total / max(n, 1)
        print(f"  eval: loss {loss:.4f} ppl {math.exp(min(loss, 30)):.2f}")
        return loss

    # TONY_STEP_LOG (set by the executor): the step-time JSONL the task
    # monitor samples; standalone runs leave it off
    timer = StepTimer(os.environ.get(ENV_STEP_LOG) or None)

    # preemption drain: a SIGTERM, or the executor's flag file, ends the run
    # at the next step boundary with EXIT_PREEMPTED (checkpointing comes with
    # the checkpoint slice)
    import signal

    preempted = {"flag": False}
    old_handler = signal.signal(
        signal.SIGTERM, lambda *_: preempted.__setitem__("flag", True))

    def drain_exit(step_i: int) -> int:
        print(f"preempted at step {step_i}, exiting")
        return EXIT_PREEMPTED

    metrics = None
    losses = []
    last_eval = None
    last_eval_step = -1
    t0 = time.time()
    try:
        with trace(args.profile_dir, enabled=bool(args.profile_dir)):
            for step_i in range(args.steps):
                tokens, targets = next_batch(step_i)
                params, opt_state, metrics = bundle.step_fn(
                    params, opt_state, tokens, targets)
                losses.append(metrics["loss"])
                timer.tick(train_step=step_i)
                if preempted["flag"] or timer.preempt_requested:
                    return drain_exit(step_i)
                if step_i % 20 == 0:
                    loss = float(metrics["loss"])   # sync point
                    print(f"step {step_i}: loss {loss:.4f} "
                          f"({timer.steps_per_sec:.2f} steps/s)")
                if (loader is not None and args.eval_every > 0
                        and step_i > 0 and step_i % args.eval_every == 0):
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
            and last_eval_step != args.steps - 1):
        last_eval = run_eval(params)

    tokens_per_step = args.batch_size * args.seq_len
    result = {
        "final_loss": final_loss,
        "steps_per_sec": args.steps / wall,
        "tokens_per_sec": args.steps * tokens_per_step / wall,
        "n_params": n_params,
        "mesh": mesh,
        "losses": [float(x) for x in losses],
    }
    if last_eval is not None:
        result["eval_loss"] = last_eval
        result["eval_ppl"] = math.exp(min(last_eval, 30))
    print(json.dumps(result))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
