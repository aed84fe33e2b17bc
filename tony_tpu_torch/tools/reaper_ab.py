"""The telemetry phase's reaper-cost check of ``chip_smoke.py``
(``_reaper_host_cost``) on several trees of the repo, in turns, on one
card: each tree a fresh process whose working directory is the tree, so
it imports that tree's ``tony_tpu_torch`` and ``chip_smoke``. The process
imports what the smoke's ``main`` imports, trains two steps of a small
model through ``lm_train`` on the card (the training stack's imports),
counts its threads, then runs the check ``--repeat`` times (default 6),
recording each reading whether it passes the check's bound or not.
Compare two commits in one call, parent and change in alternation::

    git archive <parent> | (mkdir -p build/parent && tar -x -C build/parent)
    python -m tony_tpu_torch.tools.reaper_ab build/parent . . build/parent

Prints one JSON line a reading (its tree, its place in the process, the
loop's idle and waiting seconds, both ratios, the CPU shares, whether the
check passed) and the card's name and power limit as ``nvidia-smi``
prints them.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

_RUN = """
import ast, json, os, threading
import torch, chip_smoke as C
from tony_tpu_torch import ops
from tony_tpu_torch.cli import serve
from tony_tpu_torch.examples import lm_generate, lm_train
from tony_tpu_torch.models import generate, transformer
from tony_tpu_torch.ops import attention, decode_attention
assert lm_train.main(["--steps", "2", "--batch-size", "2", "--seq-len",
                      "128", "--d-model", "256", "--n-layers", "2",
                      "--n-heads", "4", "--d-ff", "512", "--vocab",
                      "1024"]) == 0
print("threads " + json.dumps({
    "python": threading.active_count(),
    "os": len(os.listdir("/proc/self/task"))}))
for i in range(REPEAT):
    try:
        rec, ok = C._reaper_host_cost(torch), True
    except RuntimeError as e:
        rec, ok = ast.literal_eval(str(e)[len("reaper cost: "):]), False
    print("reading " + json.dumps(dict(rec, passed=ok)), flush=True)
"""


def run_tree(tree: Path, repeat: int, timeout_s: float = 600.0) -> tuple:
    """``repeat`` readings in one process in ``tree`` -> (its thread
    counts, the readings in order)."""
    proc = subprocess.run([sys.executable, "-c",
                           _RUN.replace("REPEAT", str(repeat))],
                          cwd=tree, capture_output=True, text=True,
                          timeout=timeout_s)
    if proc.returncode:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    threads = [json.loads(ln[8:]) for ln in lines if ln.startswith("threads ")]
    return threads[0], [json.loads(ln[8:]) for ln in lines
                        if ln.startswith("reading ")]


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    repeat = 6
    if args[:1] == ["--repeat"]:
        repeat, args = int(args[1]), args[2:]
    trees = [Path(t).resolve() for t in args]
    if not trees or repeat < 1:
        raise SystemExit("usage: python -m tony_tpu_torch.tools.reaper_ab "
                         "[--repeat N] TREE [TREE ...]")
    for i, tree in enumerate(trees):
        threads, readings = run_tree(tree, repeat)
        for j, rec in enumerate(readings):
            print(json.dumps({"run": i, "reading": j, "tree": str(tree),
                              "threads": threads, **rec}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
