"""What an elastic resize costs across cards: a four-worker torch-runtime
job of ``lm_train --mesh data=-1`` over NCCL (the flagship at 12 layers,
bf16, a global batch of 12 x 2048 so that world 4 and world 3 both divide
it, a checkpoint every 5 steps) loses worker:1's child at step 10 (a
SIGKILL; its restart budget is 0), re-forms at world 3 from the
checkpoint, and rejoins at world 4 after ``tony.train.rescale-retry-ms``,
the returning executor prestaging the checkpoint before it registers.
The compacted ranks matter: at world 3 worker:2 is rank 1 and worker:3
rank 2. Once rank 0 of world 3 has reached step HOLD_AT, every rank
waits at its step boundary (the wrapper's hold file) until the rejoin is
launched, so world 3's share of the run is the same on every host, and
its end is the driver's drain.

    python -m tony_tpu_torch.tools.elastic_cost [--out FILE]
        [--device cpu --tiny]        # the rehearsal: gloo, a small width

It reports: loss -> first step at world 3 (the kill to rank 0's first
step of the world-3 formation) and reattach -> first step at world 4 (the
rejoining attempt's launch to rank 0's first world-4 step), in seconds;
the prestage's bytes and seconds (the rejoining task's trace); the step
ms at world 4 and at world 3 (the median gap between rank 0's steps, the
saves included); the steps recomputed; the peak device memory a card; and
rank 0's losses against an uninterrupted four-worker run of the same
steps, within LOSS_ATOL at bf16 (the all-reduce's order changes with the
world); and, for scale, two more uninterrupted runs of CONTROL_STEPS
steps against the four-worker one: a second four-worker run (the same
world: how far the card's run-to-run noise alone moves the losses) and a
three-worker run (two orders of the same sums, no resize). Prints one
JSON line, ``elastic_cost {...}``, with the cards' names and power
limits.

``--child -- <lm_train argv>`` is the wrapper every worker runs (here and
in ``chip_smoke.py``'s launch (d)): lm_train in this process, with a line
``elastic_start {...}`` (pid, world, gang generation), a line
``elastic_step [step, loss, unix time]`` a step (the loss lm_train hands
its StepTimer; a host sync a step) and at its end ``elastic_child {...}`` (the exit code, the kernels' launches,
the device-memory peak). ``--step-delay-ms`` slows each step (a CPU
rehearsal's steps are shorter than the driver's reactions);
``--total-steps N`` trains to step N - 1 whatever the attempt resumes
from (lm_train's ``--steps`` counts from the resume); while the file
``--hold-file`` names exists, the child waits at its step boundary (a
drill holds one worker there while another relaunches).
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FLAGSHIP = ["--vocab", "32768", "--d-model", "1024", "--n-layers", "12",
            "--n-heads", "8", "--d-ff", "4096", "--dtype", "bfloat16"]
TINY = ["--vocab", "256", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "4", "--d-ff", "128", "--dtype", "float32"]
WORKERS = 4
GLOBAL_BATCH, SEQ = 12, 2048
SAVE_EVERY = 5
KILL_AT, HOLD_AT = 10, 20
CONTROL_STEPS = 100
LOSS_ATOL = 3e-2


def _resume_step(argv: list) -> int:
    """The step lm_train resumes at for ``argv``: the newest kept
    checkpoint + 1, else 0."""
    from tony_tpu_torch.train.checkpoint import _kept_steps

    if "--checkpoint-dir" not in argv:
        return 0
    root = Path(argv[argv.index("--checkpoint-dir") + 1])
    kept = _kept_steps(root) if root.is_dir() else []
    return kept[-1] + 1 if kept else 0


def child(argv: list, step_delay_s: float = 0.0,
          total_steps: int | None = None, hold_file: str = "") -> int:
    """lm_train.main(argv) in this process, its steps and losses printed
    (see the module's docstring)."""
    import torch

    from tony_tpu_torch import ops
    from tony_tpu_torch.examples import lm_train
    from tony_tpu_torch.train.profiling import StepTimer

    print("elastic_start " + json.dumps({
        "pid": os.getpid(),
        "world": int(os.environ.get("TONY_NUM_PROCESSES", "1") or 1),
        "rank": int(os.environ.get("TONY_PROCESS_ID", "0") or 0),
        "gen": int(os.environ.get("TONY_GANG_GENERATION", "0") or 0),
        "t": time.time()}), flush=True)
    tick = StepTimer.tick

    # a line for every step, an attempt's first too (the step log has no
    # record of it: a record carries the step's duration)
    def tick_printed(self, **extra):
        if "train_step" in extra and "loss" in extra:
            print("elastic_step " + json.dumps(
                [extra["train_step"], float(extra["loss"]), time.time()]),
                flush=True)
        if step_delay_s:
            time.sleep(step_delay_s)
        while hold_file and os.path.exists(hold_file):
            time.sleep(0.05)
        return tick(self, **extra)

    StepTimer.tick = tick_printed
    if total_steps is not None:
        argv = argv + ["--steps", str(max(1, total_steps
                                          - _resume_step(argv)))]
    ops.reset_launch_counts()
    rc = lm_train.main(argv)
    peak = (torch.cuda.max_memory_allocated() / 2**20
            if torch.cuda.is_available() else None)
    print("elastic_child " + json.dumps({
        "rc": rc, "launches": ops.launch_counts(), "peak_mb": peak}),
        flush=True)
    return rc


def parse_child(text: str) -> list:
    """A worker's stdout (every attempt, appended) -> one dict an attempt:
    its start line's fields, ``steps`` ([step, loss, t]) and, when it
    ended on its own, ``end`` (the elastic_child line)."""
    attempts: list = []
    for ln in text.splitlines():
        kind, _, body = ln.partition(" ")
        if kind == "elastic_start":
            attempts.append(dict(json.loads(body), steps=[], end=None))
        elif kind == "elastic_step" and attempts:
            attempts[-1]["steps"].append(json.loads(body))
        elif kind == "elastic_child" and attempts:
            attempts[-1]["end"] = json.loads(body)
    return attempts


def continuity(steps: list) -> int:
    """Steps recomputed over a multi-attempt sequence; raises on a silent
    skip (tests/test_elastic.py's ``_continuity`` rule)."""
    recomputed = 0
    for prev, cur in zip(steps, steps[1:]):
        if cur <= prev:
            recomputed += prev - cur + 1
        elif cur != prev + 1:
            raise AssertionError(f"silent step skip: {prev} -> {cur} in "
                                 f"{steps}")
    return recomputed


def _card_lines() -> list:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except OSError:
        return ["no nvidia-smi"]


def _job(root: Path, name: str, command: str, extra: dict,
         workers: int = WORKERS):
    from tony_tpu_torch.client import TonyClient
    from tony_tpu_torch.conf import TonyConf

    conf = TonyConf.resolve([], include_site=False)
    for k, v in {"tony.staging.dir": str(root / name / "staging"),
                 "tony.history.intermediate": str(root / name / "history"),
                 "tony.am.monitor-interval-ms": 100,
                 "tony.task.registration-poll-interval-ms": 100,
                 "tony.task.metrics-interval-ms": 500,
                 "tony.worker.instances": workers,
                 "tony.worker.command": command,
                 "tony.application.timeout-ms": 1500 * 1000,
                 **extra}.items():
        conf.set(k, v)
    client = TonyClient(conf, poll_interval_s=0.2)
    client.submit()
    return client


def _median_gap_ms(steps: list) -> float | None:
    gaps = [(b[2] - a[2]) * 1e3 for a, b in zip(steps, steps[1:])
            if b[0] == a[0] + 1]
    return round(statistics.median(gaps), 2) if gaps else None


def _elastic(root: Path, argv: list, steps: int, env: str, retry_ms: int,
             delay_ms: int) -> dict:
    import threading

    ckpt = root / "elastic_ckpt"
    hold = root / "hold"
    cmd = " ".join([sys.executable, "-m", "tony_tpu_torch.tools.elastic_cost",
                    "--child", "--step-delay-ms", str(delay_ms),
                    "--total-steps", str(steps), "--hold-file", str(hold),
                    "--"]
                   + [shlex.quote(a) for a in argv]
                   + ["--checkpoint-dir", str(ckpt),
                      "--checkpoint-every", str(SAVE_EVERY)])
    client = _job(root, "elastic", cmd, {
        "tony.worker.max-restarts": 0,
        "tony.train.elastic-enabled": True,
        "tony.train.elastic-min-instances": 1,
        "tony.train.rescale-retry-ms": retry_ms,
        "tony.train.checkpoint-dir": str(ckpt),
        "tony.task.preempt-grace-ms": 10000,
        "tony.execution.env": env})
    logs = Path(client.job_dir) / "logs"
    done, status = threading.Event(), {}

    def monitor():
        status["status"] = client.monitor().value
        done.set()

    threading.Thread(target=monitor, daemon=True).start()
    kill_t = hold_t = None
    journal_path = Path(client.job_dir) / "driver.journal.jsonl"
    while not done.wait(0.05):
        out = logs / "worker_1.stdout"
        if kill_t is None and out.exists():
            (first, *_) = parse_child(out.read_text()) or [None]
            if first and first["steps"] and first["steps"][-1][0] >= KILL_AT:
                os.kill(first["pid"], signal.SIGKILL)
                kill_t = time.time()
        if kill_t is not None and hold_t is None:
            w0 = parse_child((logs / "worker_0.stdout").read_text())
            if (w0[-1]["world"] == WORKERS - 1 and w0[-1]["steps"]
                    and w0[-1]["steps"][-1][0] >= HOLD_AT):
                hold.write_text("")
                hold_t = time.time()
        if hold.exists() and sum(
                '"launch"' in ln and '"worker:1"' in ln
                for ln in journal_path.read_text().splitlines()) > 1:
            hold.unlink()       # the rejoin is launched: world 4 steps
    journal = [json.loads(ln) for ln in
               (Path(client.job_dir) / "driver.journal.jsonl")
               .read_text().splitlines()]
    hist = root / "elastic" / "history" / client.app_id
    traces = {json.loads(ln)["id"]: json.loads(ln) for ln in
              (hist / "tasks.trace.jsonl").read_text().splitlines()}
    workers = {i: parse_child((logs / f"worker_{i}.stdout").read_text())
               for i in range(WORKERS)}
    return dict(status=status["status"], kill_t=kill_t, hold_t=hold_t,
                journal=journal, traces=traces, workers=workers,
                app_id=client.app_id)


def _straight(root: Path, name: str, argv: list, steps: int, env: str,
              workers: int = WORKERS) -> tuple:
    """An uninterrupted job of ``workers`` -> (its status, rank 0's
    attempt)."""
    cmd = " ".join([sys.executable, "-m", "tony_tpu_torch.tools.elastic_cost",
                    "--child", "--"] + [shlex.quote(a) for a in argv]
                   + ["--steps", str(steps)])
    client = _job(root, name, cmd, {"tony.execution.env": env}, workers)
    status = client.monitor().value
    (attempt,) = parse_child(
        (Path(client.job_dir) / "logs" / "worker_0.stdout").read_text())
    return status, attempt


def _loss_diffs(steps: list, want: dict) -> list:
    return [abs(loss - want[s]) for s, loss, _ in steps if s in want]


def report(e: dict, straight_status: str, straight: dict) -> dict:
    """The elastic job's record against the straight run's."""
    w0 = e["workers"][0]
    world3 = [a for a in w0 if a["world"] == WORKERS - 1 and a["steps"]]
    world4 = [a for a in w0 if a["world"] == WORKERS and a["steps"]]
    launches = [r for r in e["journal"] if r["op"] == "launch"
                and r["task"] == "worker:1"]
    rejoin_t = launches[-1]["t"] if len(launches) > 1 else None
    first3 = world3[0]["steps"][0][2] if world3 else None
    after = [a for a in world4 if rejoin_t and a["steps"][0][2] > rejoin_t]
    first4 = after[0]["steps"][0][2] if after else None
    steps0 = [s for a in w0 for s, _, _ in a["steps"]]
    want = {s: loss for s, loss, _ in straight["steps"]}
    diffs = _loss_diffs([x for a in w0 for x in a["steps"]], want)
    tr1 = e["traces"].get("worker:1", {}).get("attrs", {})
    peaks = [a["end"]["peak_mb"] for w in e["workers"].values() for a in w
             if a["end"] and a["end"]["peak_mb"] is not None]
    ranks3 = {}
    for i, atts in e["workers"].items():
        for a in atts:
            if a["world"] == WORKERS - 1:
                ranks3[f"worker:{i}"] = a["rank"]
    return dict(
        status=e["status"], straight_status=straight_status,
        app_id=e["app_id"],
        worlds=[a["world"] for a in w0], gens=[a["gen"] for a in w0],
        ranks_at_world_3=ranks3,
        loss_to_first_step_world3_s=(round(first3 - e["kill_t"], 2)
                                     if first3 and e["kill_t"] else None),
        reattach_to_first_step_world4_s=(round(first4 - rejoin_t, 2)
                                         if first4 else None),
        prestage_bytes=tr1.get("prestage_bytes"),
        prestage_s=tr1.get("prestage_s"), prestage_step=tr1.get(
            "prestage_step"),
        step_ms_world4=(_median_gap_ms(world4[-1]["steps"]) if world4
                        else None),
        step_ms_world3=(_median_gap_ms(world3[0]["steps"]) if world3
                        else None),
        steps_recomputed=continuity(steps0), last_step=max(steps0),
        peak_mb_a_card=round(max(peaks), 1) if peaks else None,
        max_loss_diff=max(diffs) if diffs else None,
        losses_compared=len(diffs),
        losses_within=bool(diffs) and max(diffs) <= LOSS_ATOL)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--child" in argv:
        head, _, rest = (argv[:argv.index("--")], None,
                         argv[argv.index("--") + 1:])
        p = argparse.ArgumentParser()
        p.add_argument("--child", action="store_true")
        p.add_argument("--step-delay-ms", type=float, default=0.0)
        p.add_argument("--total-steps", type=int, default=None)
        p.add_argument("--hold-file", default="")
        a = p.parse_args(head)
        return child(rest, a.step_delay_ms / 1000, a.total_steps,
                     a.hold_file)
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None, help="cpu: a gloo rehearsal")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--steps", type=int, default=40,
                   help="the job's steps (every attempt trains to the "
                        "last)")
    p.add_argument("--rescale-retry-ms", type=int, default=75000)
    p.add_argument("--step-delay-ms", type=int, default=0)
    p.add_argument("--root", default=str(REPO / "build" / "elastic_cost"))
    args = p.parse_args(argv)
    root = Path(args.root)
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    result = {"cards": _card_lines()}
    if args.device != "cpu":
        from tony_tpu_torch.ops import _build

        result["build_s"] = round(_build.build_all(), 1)
    train = ((TINY + ["--batch-size", str(GLOBAL_BATCH), "--seq-len", "16"])
             if args.tiny else FLAGSHIP + ["--batch-size", str(GLOBAL_BATCH),
                                           "--seq-len", str(SEQ)])
    train += ["--mesh", "data=-1", "--step-log-every", "1"]
    if args.device:
        train += ["--device", args.device]
    env = "PYTHONUNBUFFERED=1" + (",OMP_NUM_THREADS=1"
                                  if args.device == "cpu" else "")
    t0 = time.time()
    e = _elastic(root, train, args.steps, env, args.rescale_retry_ms,
                 args.step_delay_ms)
    s_status, straight = _straight(root, "straight", train,
                                   max(args.steps, CONTROL_STEPS), env)
    result["elastic"] = report(e, s_status, straight)
    want = {s: loss for s, loss, _ in straight["steps"]}
    for name, workers in (("repeat_world4_vs_world4", WORKERS),
                          ("control_world3_vs_world4", WORKERS - 1)):
        status, run = _straight(root, name, train, CONTROL_STEPS, env,
                                workers)
        d = _loss_diffs(run["steps"], want)
        result[name] = dict(
            status=status, steps=len(d), bitwise=not any(d),
            max_loss_diff_by_tens={
                f"{i}-{i + 9}": max(d[i:i + 10]) for i in range(0, len(d),
                                                                 10)})
    result["wall_s"] = round(time.time() - t0, 1)
    line = "elastic_cost " + json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    r = result["elastic"]
    ok = (r["status"] == r["straight_status"] == "SUCCEEDED"
          and result["repeat_world4_vs_world4"]["status"] == "SUCCEEDED"
          and result["control_world3_vs_world4"]["status"] == "SUCCEEDED"
          and r["losses_within"] and r["worlds"][:1] == [WORKERS]
          and WORKERS - 1 in r["worlds"] and r["worlds"][-1] == WORKERS)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
