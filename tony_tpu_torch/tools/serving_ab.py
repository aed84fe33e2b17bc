"""The serving phase of ``chip_smoke.py`` on several trees of the repo, in
turns, on one card: run A (24 concurrent HTTP requests through serve's
app), run B and one profiled decode block, each run a fresh process whose
working directory is its tree, so it imports that tree's
``tony_tpu_torch`` and ``chip_smoke``. Compare two commits in one call,
parent and change in alternation::

    git archive <parent> | (mkdir -p build/parent && tar -x -C build/parent)
    python -m tony_tpu_torch.tools.serving_ab build/parent . . build/parent

``--repeat N`` runs the phase N times in each process, one after the
other (a later phase in one process against the first).

Prints one JSON line a phase (its tree, its place in the process and run
A's record: tokens/s, latency, a block's host dispatch, the profiled
block's wall and device time) and the card's name and power limit as
``nvidia-smi`` prints them.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

_RUN = ("import torch, chip_smoke as C; from tony_tpu_torch import ops\n"
        "for _ in range({n}):\n"
        "    C.phase_serving(torch, ops)\n")


def run_tree(tree: Path, repeat: int = 1,
             timeout_s: float = 900.0) -> list[dict]:
    """``repeat`` serving phases in one process in ``tree`` -> their run
    A records, in order."""
    proc = subprocess.run([sys.executable, "-c", _RUN.format(n=repeat)],
                          cwd=tree, capture_output=True, text=True,
                          timeout=timeout_s * repeat)
    if proc.returncode:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return [json.loads(ln[len("serving "):])["run_a"]
            for ln in proc.stdout.splitlines() if ln.startswith("serving {")]


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    repeat = 1
    if args[:1] == ["--repeat"]:
        repeat, args = int(args[1]), args[2:]
    trees = [Path(t).resolve() for t in args]
    if not trees or repeat < 1:
        raise SystemExit("usage: python -m tony_tpu_torch.tools.serving_ab "
                         "[--repeat N] TREE [TREE ...]")
    keys = ("output_tokens_per_s", "latency_s_p50", "latency_s_max",
            "block_dispatch_ms_p50", "block_wall_ms", "block_device_ms",
            "admission_syncs")
    for i, tree in enumerate(trees):
        for j, rec in enumerate(run_tree(tree, repeat)):
            print(json.dumps({"run": i, "phase": j, "tree": str(tree),
                              **{k: rec[k] for k in keys}}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
