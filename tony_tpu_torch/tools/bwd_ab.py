"""The flash backward (K3-K5) of several trees of the repo, in turns, on
one card: each run a fresh process whose working directory is its tree, so
it imports that tree's ``tony_tpu_torch`` and ``chip_smoke``. Compare two
commits in one call, parent and change in alternation::

    git archive <parent> | (mkdir -p build/parent && tar -x -C build/parent)
    python -m tony_tpu_torch.tools.bwd_ab build/parent . . build/parent

A run times, with ``chip_smoke.cuda_ms`` (CUDA events over back-to-back
calls): the whole backward as autograd calls it (``_flash_bwd_cuda``:
both kernels, and delta wherever the tree computes it), each kernel alone
and ``_delta`` (the PyTorch delta the float32 route keeps) at the training
shape, B8 H8 L2048 D128 bf16 causal, and at the draft's, B8 H4 L512 D32 in
bf16 and float32; SDPA's backward beside each (forward+backward minus
forward); the host's enqueue time of one backward call (microseconds over
50 calls queued behind a device sleep, few enough that the launch queue
never fills and makes the host wait); and the
flagship training step's device time from ``chip_smoke``'s profiled step
(batch 8 x 2048, remat off).

Prints one JSON line a run (``bwd_ab {...}``) and the card's name and
power limit as ``nvidia-smi`` prints them.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

_RUN = r'''
import json, time, torch
import chip_smoke as C
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.ops import attention as A

gen = torch.Generator(device="cuda").manual_seed(5)
rec = {}
sdpa = torch.nn.functional.scaled_dot_product_attention
for label, b, h, l, d, dt in (("D128 bf16", 8, 8, 2048, 128, torch.bfloat16),
                              ("D32 bf16", 8, 4, 512, 32, torch.bfloat16),
                              ("D32 f32", 8, 4, 512, 32, torch.float32)):
    q, k, v, g = (torch.randn((b, h, l, d), generator=gen, device="cuda",
                              dtype=dt) for _ in range(4))
    out, lse = A._flash_fwd_cuda(q, k, v, True, None, None)
    call = lambda: A._flash_bwd_cuda(q, k, v, out, lse, g, None, True, None,
                                     None)
    ms = C.cuda_ms(call, 20)
    # each kernel alone: the bf16 dQ kernel writes delta itself, the
    # float32 route takes _delta's
    dl = (torch.empty_like(lse) if dt == torch.bfloat16
          else A._delta(out, g, None).contiguous())
    dq_ms = C.cuda_ms(lambda: A._flash_bwd_dq_cuda(
        q, k, v, out, g, lse, None, dl, True, None, None), 20)
    dkdv_ms = C.cuda_ms(lambda: A._flash_bwd_dkdv_cuda(
        q, k, v, g, lse, dl, True, None, None), 20)
    delta_ms = C.cuda_ms(lambda: A._delta(out, g, None), 20)
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        fb = C.cuda_ms(lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), g), 20)
        f = C.cuda_ms(lambda: sdpa(qg, kg, vg, is_causal=True), 20)
    rec[label] = dict(ms=ms, dq_ms=dq_ms, dkdv_ms=dkdv_ms,
                      torch_delta_ms=delta_ms, sdpa_ms=fb - f)
    if label == "D128 bf16":
        # 50 calls: a few hundred launches at most, inside the launch
        # queue, so the host never waits for the card while it enqueues
        n = 50
        torch.cuda.synchronize()
        torch.cuda._sleep(int(1e9))          # about 0.5 s of device work
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        rec["host_us_per_call"] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    del q, k, v, g, out, lse, qg, kg, vg
cfg = T.TransformerConfig(
    vocab_size=32768, d_model=1024, n_layers=C.N_LAYERS, n_heads=8,
    n_kv_heads=8, d_ff=4096, max_seq_len=C.TRAIN_SEQ)
step = C._train_step_profile(torch, cfg, None)
rec["train_step_device_ms"] = step.get("device_ms")
rec["train_step_wall_ms"] = step.get("wall_ms")
print("bwd_ab " + json.dumps(rec), flush=True)
'''


def run_tree(tree: Path, timeout_s: float = 900.0) -> dict:
    """One run in ``tree`` -> its record."""
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=tree,
                          capture_output=True, text=True, timeout=timeout_s)
    if proc.returncode:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("bwd_ab {")][-1]
    return json.loads(line[len("bwd_ab "):])


def main(argv=None) -> int:
    trees = [Path(t).resolve() for t in (sys.argv[1:] if argv is None
                                         else argv)]
    if not trees:
        raise SystemExit("usage: python -m tony_tpu_torch.tools.bwd_ab "
                         "TREE [TREE ...]")
    for i, tree in enumerate(trees):
        print("bwd_ab " + json.dumps({"run": i, "tree": str(tree),
                                      **run_tree(tree)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
