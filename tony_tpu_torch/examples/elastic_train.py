"""Elastic-training drill: a tiny checkpointed trainer built to be killed
(port of the JAX package's examples/elastic_train.py).

    python -m tony_tpu_torch.examples.elastic_train --ckpt-dir /tmp/ckpt

A deterministic update on a small ``{"w", "step"}`` state, checkpointed
every ``--save-interval`` steps through ``CheckpointManager.save_async``,
with the drain contract wired up:

- SIGTERM (a preemption, or the job draining the gang for a resize):
  checkpoint at the next step boundary, exit ``EXIT_PREEMPTED``;
- the executor-relayed ``$TONY_STEP_LOG.preempt`` flag: the same, through
  ``StepTimer.preempt_requested``;
- on relaunch, resume from ``latest_step() + 1``, never step 0.

Every step ticks the StepTimer with ``train_step=<global step>`` at
``window=1``, so the JSONL is one record a step: recovery checks read
step-counter continuity (no silent skips, at most ``--save-interval``
steps recomputed) straight from it. ``--device`` picks the device
(default: the GPU, raising without one).

Fault hooks (environment):
  ELASTIC_TRAIN_KILL=<task_index>:<step>   SIGKILL this process at that
      step, once per job: the marker file named by ELASTIC_TRAIN_KILL_ONCE
      guards it so the relaunched attempt survives.
  ELASTIC_TRAIN_STEP_MS=<ms>               sleep this long every step.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=60,
                        help="total global steps (a relaunch continues "
                             "toward the same total)")
    parser.add_argument("--ckpt-dir", required=True)
    parser.add_argument("--save-interval", type=int, default=5)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--device", default=None,
                        help="default: the GPU (raises without one)")
    args = parser.parse_args(argv)

    import torch

    from tony_tpu_torch.constants import (
        ENV_GANG_GENERATION, ENV_STEP_LOG, ENV_TASK_INDEX, EXIT_PREEMPTED,
    )
    from tony_tpu_torch.device import resolve_device
    from tony_tpu_torch.train.checkpoint import CheckpointManager
    from tony_tpu_torch.train.profiling import StepTimer

    device = resolve_device(args.device)
    task_index = int(os.environ.get(ENV_TASK_INDEX, "0"))
    generation = int(os.environ.get(ENV_GANG_GENERATION, "0"))
    step_ms = float(os.environ.get("ELASTIC_TRAIN_STEP_MS", "0") or 0)
    kill_spec = os.environ.get("ELASTIC_TRAIN_KILL", "")
    kill_once = os.environ.get("ELASTIC_TRAIN_KILL_ONCE", "")
    kill_at = -1
    if kill_spec:
        try:
            idx, at = kill_spec.split(":")
            if int(idx) == task_index:
                kill_at = int(at)
        except ValueError:
            print(f"bad ELASTIC_TRAIN_KILL spec: {kill_spec}",
                  file=sys.stderr)

    def update(state):
        # deterministic and step-dependent: a resumed run recomputes the
        # same trajectory, so the final value proves continuity
        return {"w": state["w"] * 0.999 + torch.sin(state["step"]),
                "step": state["step"] + 1}

    mgr = CheckpointManager(args.ckpt_dir, save_interval=args.save_interval)
    state = {"w": torch.zeros(args.dim, dtype=torch.float32, device=device),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    start_step = 0
    latest = mgr.latest_step()
    if latest is not None:
        state = mgr.restore(template=state)
        start_step = latest + 1
        print(f"resumed from checkpoint step {latest}")

    timer = StepTimer(os.environ.get(ENV_STEP_LOG) or None, window=1)
    preempted = {"flag": False}
    signal.signal(signal.SIGTERM,
                  lambda *_: preempted.__setitem__("flag", True))

    def drain_exit(step_i: int) -> int:
        mgr.save_async(step_i, state)
        timer.note_checkpoint(step_i)
        mgr.wait()
        mgr.close()
        print(f"preempted: checkpointed step {step_i}, exiting")
        return EXIT_PREEMPTED

    # priming tick: the StepTimer records a step only once it has a
    # duration, and continuity checks need a record for every training
    # step of every attempt, each attempt's first included
    timer.tick()
    for step_i in range(start_step, args.steps):
        if step_i == kill_at and (not kill_once
                                  or not os.path.exists(kill_once)):
            if kill_once:
                with open(kill_once + ".tmp", "w") as f:
                    f.write(str(step_i))
                os.replace(kill_once + ".tmp", kill_once)
            print(f"fault injection: SIGKILLing self at step {step_i}",
                  file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        state = update(state)
        if step_ms:
            time.sleep(step_ms / 1000)
        timer.tick(train_step=step_i, generation=generation)
        if preempted["flag"] or timer.preempt_requested:
            return drain_exit(step_i)
        if step_i % args.save_interval == 0 and step_i > 0:
            mgr.save_async(step_i, state)
            timer.note_checkpoint(step_i)

    mgr.save_async(args.steps - 1, state)
    timer.note_checkpoint(args.steps - 1)
    mgr.wait()
    mgr.close()
    result = {"final_step": int(state["step"]),
              "final_w0": float(state["w"][0]),
              "task_index": task_index}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
