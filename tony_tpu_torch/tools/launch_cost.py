"""Jobs across cards through the port's launcher, beside one card: the
flagship's training (``examples/configs/lm_train_cuda.json``: four
workers, ``lm_train --mesh fsdp=4``, bf16, 12 layers, B8 x 2048, 4 steps)
and MNIST (``mnist_cuda.json`` at four instances).

    python -m tony_tpu_torch.tools.launch_cost [--out FILE] \
        [--cases lm_train,mnist] [--device cpu --tiny --mnist-steps 20]

Every job goes through ``python -m tony_tpu_torch.cli.main``: the
four-worker ones by ``submit --conf <config>``, the one-card baselines by
``local --instances 1`` with the same command at ``--mesh fsdp=-1`` (one
rank). Each job's record: the CLI's exit code and the job's status (the
history file's name), each rank's card (the rank's own ``process r/n:
nccl on cuda:k`` line, and the nvidia-smi index the executor's TaskMonitor
sampled, with the most memory it saw in use there), rank 0's losses, the
step ms (the wall after the first synced step over the steps after it),
the driver's start-up (the CLI's start -> driver.json) and the
driver-to-first-step seconds (the CLI's start -> rank 0's ``step 0``
line; for MNIST, its time to the first block beside the driver's).
lm_train's losses are held at 3e-2 of one card's. The kernels are built
once first (``build/kernels/``), so no job's first step waits for nvcc.
``--device cpu --tiny``
runs the same jobs over gloo at a small width, one thread a rank (a
rehearsal; ``--mnist-steps`` shortens MNIST's run).

Prints one JSON line, ``launch_cost {...}``, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shlex
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CONFIGS = REPO / "tony_tpu_torch" / "examples" / "configs"
LOSS_ATOL = 3e-2
JOB_TIMEOUT_S = 900
TINY = ["--vocab", "256", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "4", "--d-ff", "128", "--dtype", "float32",
        "--batch-size", "4", "--seq-len", "64"]


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        return "no nvidia-smi"


def _command(conf_file: Path, extra: list, device: str | None,
             tiny: bool) -> list:
    """The config's worker command as argv, this interpreter for its
    ``python``, with ``extra`` (and the rehearsal's flags) appended."""
    conf = json.loads(conf_file.read_text())
    argv = shlex.split(conf["tony.worker.command"])
    argv[0] = sys.executable
    if device:
        argv += ["--device", device]
    if tiny and "lm_train" in argv[2]:
        argv += TINY
    return argv + extra


def _run(name: str, cli: list, root: Path, env: str) -> dict:
    """One job through the CLI -> its record. Watches the job dir for
    driver.json and rank 0's first step line; past JOB_TIMEOUT_S the CLI
    gets a SIGTERM, on which it stops the job."""
    staging = root / name / "staging"
    hist = root / name / "history"
    cli = cli + ["-D", f"tony.execution.env={env}",
                 "-D", f"tony.staging.dir={staging}",
                 "-D", f"tony.history.intermediate={hist}",
                 "-D", "tony.am.monitor-interval-ms=100",
                 "-D", "tony.task.metrics-interval-ms=500"]
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "tony_tpu_torch.cli.main"]
                            + cli, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    driver_s = first_step_s = None
    job_dir = None
    while proc.poll() is None and time.perf_counter() - t0 < JOB_TIMEOUT_S:
        if job_dir is None and staging.exists():
            dirs = list(staging.iterdir())
            job_dir = dirs[0] if dirs else None
        if job_dir is not None:
            if driver_s is None and (job_dir / "driver.json").exists():
                driver_s = time.perf_counter() - t0
            out = job_dir / "logs" / "worker_0.stdout"
            if (first_step_s is None and out.exists()
                    and re.search(r"^step 0: ", out.read_text(), re.M)):
                first_step_s = time.perf_counter() - t0
        time.sleep(0.02)
    if proc.poll() is None:
        proc.terminate()
    _, err = proc.communicate(timeout=120)
    wall = time.perf_counter() - t0
    (app,) = [p.name for p in hist.iterdir()]
    (jhist,) = (hist / app).glob("*.jhist")
    events = [json.loads(ln) for ln in jhist.read_text().splitlines()]
    ranks = {}
    for e in events:
        if e["type"] != "TASK_FINISHED":
            continue
        task = e["payload"]["task_id"]
        pushed = {m["name"]: m["value"] for m in e["payload"]["metrics"]}
        log = (job_dir / "logs" / f"{task.replace(':', '_')}.stdout")
        joined = re.findall(r"^process (\d+)/(\d+): (\w+) on (\S+?),",
                            log.read_text(), re.M)
        ranks[task] = dict(
            status=e["payload"]["status"],
            exit_code=e["payload"]["exit_code"],
            joined=[list(j) for j in joined],
            gpu_index=pushed.get("max_gpu_index"),
            gpu_memory_used_mb_max=pushed.get("max_gpu_memory_used_mb"),
            gpu_utilization_pct_max=pushed.get("max_gpu_utilization_pct"),
            heartbeat_rtt_ms_avg=pushed.get("avg_heartbeat_rtt_ms"))
    ranks = dict(sorted(ranks.items()))
    return dict(rc=proc.returncode,
                status=jhist.name.rsplit("-", 1)[-1].split(".")[0],
                app_id=app, wall_s=round(wall, 2),
                driver_s=None if driver_s is None else round(driver_s, 3),
                driver_to_first_step_s=None if first_step_s is None
                else round(first_step_s, 2),
                ranks=ranks, stderr_tail=err[-1500:] if proc.returncode
                else "")


def _lm_train(root: Path, device: str | None, tiny: bool, env: str) -> dict:
    cfg = CONFIGS / "lm_train_cuda.json"
    out = {}
    for name, n, mesh in (("one_card", 1, "fsdp=-1"), ("four", 4, None)):
        metrics = root / f"lm_train_{name}.json"
        argv = _command(cfg, ["--metrics-out", str(metrics)], device, tiny)
        if mesh:
            argv[argv.index("--mesh") + 1] = mesh
        cmd = " ".join(shlex.quote(a) for a in argv)
        if n == 1:
            cli = ["local", "--instances", "1", "--command", cmd]
        else:
            cli = ["submit", "--conf", str(cfg),
                   "-D", f"tony.worker.command={cmd}"]
        rec = _run(f"lm_train_{name}", cli, root, env)
        if metrics.exists():
            m = json.loads(metrics.read_text())
            rec.update(losses=m["losses"], mesh=m["mesh"],
                       steps=len(m["losses"]), wall_loop_s=m["wall_s"])
            first = m["sync_points"][0][1] if m["sync_points"] else None
            if first is not None and len(m["losses"]) > 1:
                rec["step_ms"] = round(
                    (m["wall_s"] - first) / (len(m["losses"]) - 1) * 1e3, 2)
        out[name] = rec
    a, b = out["one_card"].get("losses"), out["four"].get("losses")
    if a and b:
        out["max_loss_diff"] = max(abs(x - y) for x, y in zip(a, b))
        out["losses_within"] = out["max_loss_diff"] <= LOSS_ATOL
    return out


def _mnist(root: Path, device: str | None, steps: int | None,
           env: str) -> dict:
    cfg = CONFIGS / "mnist_cuda.json"
    out = {}
    for name, n in (("one_card", 1), ("four", 4)):
        metrics = root / f"mnist_{name}.json"
        extra = ["--metrics-out", str(metrics)]
        if steps:
            extra += ["--steps", str(steps), "--steps-per-call", "10"]
        argv = _command(cfg, extra, device, False)
        cmd = " ".join(shlex.quote(a) for a in argv)
        rec = _run(f"mnist_{name}", [
            "submit", "--conf", str(cfg), "-D", f"tony.worker.instances={n}",
            "-D", f"tony.worker.command={cmd}"], root, env)
        if metrics.exists():
            m = json.loads(metrics.read_text())
            rec.update({k: m[k] for k in (
                "final_loss", "accuracy", "steps_per_sec",
                "steps_per_sec_wall", "time_to_first_step_s")})
        out[name] = rec
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="")
    parser.add_argument("--cases", default="lm_train,mnist")
    parser.add_argument("--device", default=None,
                        help="cpu: a rehearsal over gloo")
    parser.add_argument("--tiny", action="store_true",
                        help="lm_train at a small width")
    parser.add_argument("--mnist-steps", type=int, default=None)
    parser.add_argument("--root", default=str(REPO / "build" / "launch_cost"))
    args = parser.parse_args(argv)
    root = Path(args.root)
    root.mkdir(parents=True, exist_ok=True)
    cases = args.cases.split(",")
    result = {"card": _card_line(), "cuda_visible_devices":
              os.environ.get("CUDA_VISIBLE_DEVICES")}
    if args.device != "cpu":
        from tony_tpu_torch.ops import _build

        result["build_s"] = round(_build.build_all(), 1)
    env = "PYTHONUNBUFFERED=1" + (",OMP_NUM_THREADS=1"
                                  if args.device == "cpu" else "")
    if "lm_train" in cases:
        result["lm_train"] = _lm_train(root, args.device, args.tiny, env)
    if "mnist" in cases:
        result["mnist"] = _mnist(root, args.device, args.mnist_steps, env)
    line = "launch_cost " + json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    ok = all(r.get("rc") == 0 for case in ("lm_train", "mnist")
             for r in result.get(case, {}).values() if isinstance(r, dict))
    ok = ok and result.get("lm_train", {}).get("losses_within", True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
