#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tony_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc, then runs these phases
and exits non-zero if any of them fails:

1. card: the GPU's name and power limit, and the kernels' build time;
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the flagship's shapes and at the edge cases, with its time beside the
   plain version's, a PyTorch library call's and the card's bound; the
   decode kernel against the plain einsum decode path at M in {1024, 4096,
   16384};
3. main path, generation: tony_tpu_torch.examples.lm_generate at the
   flagship's full width (vocab 32768, d_model 1024, 12 layers, 8 heads,
   d_ff 4096, bf16, random weights from a seed) answering four requests,
   with every kernel's launch count checked against the count the requests
   need;
4. main path, training: tony_tpu_torch.examples.lm_train at the same width,
   batch 8 x 2048 tokens, TRAIN_STEPS steps on synthetic data, with the
   flash forward and both flash backward kernels launched once per layer
   per step, every loss finite and the last below the first;
5. parity: the flagship's width at 2 layers on the card (kernels, bf16)
   against the CPU's plain path in float32, from the same weights, for the
   generation logits and for the training loss and every gradient;
6. profile: a flagship decode step's and a flagship training step's host
   wall time against the device time torch.profiler records.

The last three lines of standard output are the kernels' JSON record, the
card's name and power limit as nvidia-smi gives them, and the result line.
Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
FLAGSHIP = ["--vocab", "32768", "--d-model", "1024", "--n-layers", "12",
            "--n-heads", "8", "--d-ff", "4096", "--dtype", "bfloat16"]
N_LAYERS = 12
MAX_NEW = 64
MAX_LEN = 4160                # the longest prompt (4096) + MAX_NEW
# (batch, prompt_len, extra flags) of the main path's requests
REQUESTS = [(8, 1024, []), (8, 2048, []), (1, 4096, []),
            (8, 1024, ["--kv-dtype", "int8"])]
# bf16 outputs: the kernel and the plain version both sum in float32 and
# round once to bf16, so they may differ by one bf16 ulp (2^-8 relative)
BF16_TOL = (1e-2, 1e-2)       # (atol, rtol)
F32_TOL = (1e-4, 1e-4)        # float32: summation order over up to 8192 keys
LSE_TOL = (1e-3, 1e-5)        # float32 lse from bf16 or f32 inputs
PART_TOL = (1e-4, 1e-4)       # float32 partials of the decode's pass 1
# bf16 weights and activations against float32 through 2 layers and a
# 1024-term unembed sum, for logits of standard deviation about 1: a bf16
# rounding is 2^-9 relative, and a 512-wide model showed 0.06
PARITY_LOGITS_ATOL = 0.25
# the card's kernel path against its plain path, both bf16: they differ only
# where an attention output rounds to the neighbouring bf16 value
KERNEL_PATH_ATOL = 0.1
# flash backward, kernel against plain version on the same inputs: both
# compute in float32 and round once; bf16 outputs may differ by one bf16 ulp
# (2^-7 relative), float32 ones by the order of sums over up to 2048 products
# of magnitude up to about 10
BWD_BF16_TOL = (1e-2, 1e-2)
BWD_F32_TOL = (1e-3, 1e-4)
TRAIN_STEPS = 30
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
# training parity at flagship width and 2 layers, bf16 on the card against
# float32 on the CPU: weights and activations round to bf16 (2^-9 relative)
# at every cast of a two-layer forward and backward, so a gradient may move
# by a few percent of its norm; the loss is a mean over 512 tokens of a
# logsumexp near 10.4, which averages the rounding out
TRAIN_PARITY_LOSS_ATOL = 0.05
TRAIN_PARITY_GRAD_RTOL = 0.1


def fail(msg: str):
    raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn over ``iters`` back-to-back calls, by CUDA
    events. The timed calls are queued behind a device-side sleep that
    outlasts their enqueueing, so the host's per-call overhead (Python,
    ctypes) leaves no gaps on the device inside the timed window."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warmup * iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at 2 GHz, above the H100's boost clock: the sleep lasts at
    # least 1.5x the measured enqueue time plus 2 ms
    torch.cuda._sleep(int((1.5 * host_s + 2e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, tol) -> float:
    """max |got - want|; raises unless |got - want| <= atol + rtol |want|
    everywhere."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values from the kernel")
    err = (got - want).abs()
    atol, rtol = tol
    worst = float((err - rtol * want.abs()).max())
    if worst > atol:
        fail(f"{name}: max |kernel - plain| = {float(err.max()):.3g} beyond "
             f"atol {atol} + rtol {rtol}")
    return float(err.max())


def visible_pairs(lq: int, lk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through, for one (batch, head)."""
    total = 0
    for r in range(lq):
        hi = min(r, lk - 1) if causal else lk - 1
        lo = max(0, r - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def train_flops_per_token(d, n_layers, d_ff, vocab, seq) -> float:
    """Model FLOPs of one training token (bench_transformer.py's count):
    projections, SwiGLU, causal attention at L/2 average context and the
    unembed, times 3 for forward plus backward."""
    per_layer = 2 * d * 3 * d + 2 * d * d + 6 * d * d_ff + 2 * d * seq
    return 3.0 * (n_layers * per_layer + 2 * d * vocab)


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------------ phases

def phase_card(build) -> None:
    print("== card")
    print(f"card: {nvidia_smi_line()}")
    secs = build.build_all()
    print(f"kernels built in {secs:.1f} s (nvcc, one process per source, "
          "in parallel)")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")


def phase_kernels(torch, A, DA, G, T) -> dict:
    """Each kernel against its plain version; timings at the main path's
    shapes -> the per-kernel records of the JSON line."""
    print("== kernels")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    errs = {"flash_fwd": 0.0, "flash_decode_partial": 0.0,
            "flash_decode_combine": 0.0}

    # ---- flash forward: out and lse against _flash_fwd_reference
    fwd_cases = [
        # (label, B, H, Lq, Lk, D, dtype, causal, window, plain on rows)
        ("causal L300", 8, 8, 300, 300, 128, torch.bfloat16, True, None, 8),
        ("causal L1024", 8, 8, 1024, 1024, 128, torch.bfloat16, True, None, 8),
        ("causal L2048", 8, 8, 2048, 2048, 128, torch.bfloat16, True, None, 8),
        ("causal L8192", 8, 8, 8192, 8192, 128, torch.bfloat16, True, None, 1),
        ("cross ragged Lq1024 Lk700", 2, 8, 1024, 700, 128, torch.bfloat16,
         False, None, 2),
        ("causal cross Lq300 Lk1000", 2, 8, 300, 1000, 128, torch.bfloat16,
         True, None, 2),
        ("window 256 L2048", 2, 8, 2048, 2048, 128, torch.bfloat16, True,
         256, 2),
        ("empty rows Lq1024 Lk300 w128", 1, 4, 1024, 300, 128,
         torch.bfloat16, True, 128, 1),
        ("f32 causal L1024", 2, 4, 1024, 1024, 128, torch.float32, True,
         None, 2),
        ("f32 D64 non-causal L777", 2, 4, 777, 777, 64, torch.float32, False,
         None, 2),
        ("bf16 D64 causal L512", 2, 4, 512, 512, 64, torch.bfloat16, True,
         None, 2),
    ]
    for label, b, h, lq, lk, d, dt, causal, window, rows in fwd_cases:
        q, k, v = randn(b, h, lq, d, dtype=dt), randn(b, h, lk, d, dtype=dt), \
            randn(b, h, lk, d, dtype=dt)
        out, lse = A.flash_attention_with_lse(q, k, v, causal=causal,
                                              window=window)
        torch.cuda.synchronize()
        p_out, p_lse = A._flash_fwd_reference(q[:rows], k[:rows], v[:rows],
                                              causal, None, window)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        e = compare(f"flash_fwd {label} out", out[:rows], p_out, tol)
        compare(f"flash_fwd {label} lse", lse[:rows], p_lse, LSE_TOL)
        if label.startswith("empty rows"):
            empty = torch.arange(lq, device=dev) >= lk + window - 1
            if not ((out[:, :, empty] == 0).all()
                    and (lse[:, :, empty] == A.NEG_INF).all()):
                fail("flash_fwd: a row with no visible key must give out 0 "
                     "and lse NEG_INF")
        errs["flash_fwd"] = max(errs["flash_fwd"], e)
        print(f"flash_fwd {label} {str(dt)[6:]}: max|err| {e:.3g}")
        del q, k, v, out, lse, p_out, p_lse

    # the model's layout: [B, L, H, D] views of a packed projection, read
    # through their strides, written into a [B, L, H, D] buffer
    qkv = randn(2, 1024, 3, 8, 128)
    q, k, v = qkv.unbind(2)
    out = A.attention_blhd(q, k, v, causal=True)
    want = A._flash_fwd_reference(*(t.transpose(1, 2) for t in (q, k, v)),
                                  True, None, None)[0].transpose(1, 2)
    e = compare("attention_blhd strided", out, want, BF16_TOL)
    errs["flash_fwd"] = max(errs["flash_fwd"], e)
    print(f"flash_fwd attention_blhd strided views: max|err| {e:.3g}")

    # ---- flash decode: whole function, and each pass on its own
    dec_cases = [
        # (label, Ly, B, kvH, rep, M, length, window, int8, layer)
        ("M1024 full", 1, 8, 8, 1, 1024, 1023, 0, False, None),
        ("M4096 full", 1, 8, 8, 1, 4096, 4095, 0, False, None),
        ("M4000 mid", 1, 8, 8, 1, 4000, 2500, 0, False, None),
        ("M16384 full", 1, 8, 8, 1, 16384, 16383, 0, False, None),
        ("length 0", 1, 8, 8, 1, 4096, 0, 0, False, None),
        ("GQA kvH2 rep4", 1, 8, 2, 4, 4096, 3000, 0, False, None),
        ("int8 M4096", 1, 8, 8, 1, 4096, 4000, 0, True, None),
        ("window 1000", 1, 8, 8, 1, 4096, 3000, 1000, False, None),
        ("int8 window GQA", 1, 4, 4, 2, 4000, 3999, 700, True, None),
        ("layer 2 of 3", 3, 8, 8, 1, 4096, 2049, 0, False, 2),
        ("int8 layer 1 of 3", 3, 8, 8, 1, 4096, 1500, 0, True, 1),
    ]
    for label, ly, b, kvh, rep, m, length, window, int8, layer in dec_cases:
        shape = (ly, b, kvh, m, 128) if layer is not None else (b, kvh, m, 128)
        q = randn(b, kvh, rep, 128)
        ck, cv, ks, vs = randn(*shape), randn(*shape), None, None
        if int8:
            (ck, ks), (cv, vs) = G._quantize_kv(ck), G._quantize_kv(cv)
        out = DA.flash_decode(q, ck, cv, length, ks, vs, window=window,
                              layer=layer)
        torch.cuda.synchronize()
        want = DA._flash_decode_reference(q, ck, cv, length, ks, vs,
                                          window=window, layer=layer)
        e_all = compare(f"flash_decode {label}", out, want, BF16_TOL)
        # pass 1 and pass 2 each against their own plain version
        lo, hi = DA._valid_range(length, window)
        chunk, n_chunks = DA._chunking(hi - lo + 1, b * kvh, rep,
                                       DA._sm_count(0))
        parts = DA._decode_partial_cuda(q, ck, cv, ks, vs, lo, length, chunk,
                                        n_chunks, layer)
        p_parts = DA._decode_partial_reference(q, ck, cv, ks, vs, lo, length,
                                               chunk, n_chunks, layer)
        e_p = max(compare(f"flash_decode_partial {label} {nm}", g, w,
                          PART_TOL)
                  for nm, g, w in zip("oml", parts, p_parts))
        comb = DA._decode_combine_cuda(*parts, q.dtype)
        e_c = compare(f"flash_decode_combine {label}", comb,
                      DA._decode_combine_reference(*parts, q.dtype), BF16_TOL)
        errs["flash_decode_partial"] = max(errs["flash_decode_partial"], e_p)
        errs["flash_decode_combine"] = max(errs["flash_decode_combine"],
                                           max(e_c, e_all))
        print(f"flash_decode {label}: chunks {n_chunks}x{chunk}, max|err| "
              f"whole {e_all:.3g} partial {e_p:.3g} combine {e_c:.3g}")
        del q, ck, cv, ks, vs, out, want, parts, p_parts

    # ---- timings at the main path's shapes
    records = []
    # prefill of the main path's second request: B8 H8 L2048 D128 causal
    for b, l in ((8, 2048), (8, 1024), (1, 4096)):
        q, k, v = randn(b, 8, l, 128), randn(b, 8, l, 128), randn(b, 8, l, 128)
        ms = cuda_ms(lambda: A.flash_attention_with_lse(q, k, v, True), 10)
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10)
        plain = cuda_ms(lambda: A._flash_fwd_reference(q, k, v, True, None,
                                                       None), 3, warmup=1)
        flops = 4 * 128 * visible_pairs(l, l, True, None) * b * 8
        nbytes = 4 * b * 8 * l * 128 * 2 + b * 8 * l * 4
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        print(f"time flash_fwd B{b} H8 L{l} D128 bf16 causal: kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {flops / ms / 1e9:.1f} TFLOP/s")
        if (b, l) == (8, 2048):
            records.append(dict(
                name="flash_fwd", route="cuda",
                source="tony_tpu_torch/csrc/flash_fwd.cu",
                replaces="tony_tpu/ops/attention.py:241 (_fwd_kernel) and "
                         "tony_tpu/ops/attention.py:484 (_fwd_kernel_resident)",
                shape="B8 H8 L2048 D128 bf16 causal",
                max_abs_err=errs["flash_fwd"],
                tolerance="bf16 out: atol 1e-2 + rtol 1e-2; f32 out: 1e-4 + "
                          "1e-4; lse: 1e-3 + 1e-5",
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib))
        del q, k, v

    # decode step in the middle of the second request: B8 kvH8 rep1 D128
    # bf16, cache capacity MAX_LEN, 2048 + 32 positions valid, layer-indexed
    # over a 12-layer stack as the main path reads it (the stack is 1.6 GB,
    # so every timed call finds its layer cold in L2)
    b, kvh, length = 8, 8, 2048 + 32
    stack = (N_LAYERS, b, kvh, MAX_LEN, 128)
    q = randn(b, kvh, 1, 128)
    ck, cv = randn(*stack), randn(*stack)
    chunk, n_chunks = DA._chunking(length + 1, b * kvh, 1, DA._sm_count(0))
    layer_it = iter(range(10 ** 9))

    def partial():
        return DA._decode_partial_cuda(q, ck, cv, None, None, 0, length, chunk,
                                       n_chunks, next(layer_it) % N_LAYERS)

    ms_p = cuda_ms(partial, 48)
    plain_p = cuda_ms(lambda: DA._decode_partial_reference(
        q, ck, cv, None, None, 0, length, chunk, n_chunks,
        next(layer_it) % N_LAYERS), 12)
    parts = partial()
    ms_c = cuda_ms(lambda: DA._decode_combine_cuda(*parts, q.dtype), 48)
    plain_c = cuda_ms(lambda: DA._decode_combine_reference(*parts, q.dtype),
                      48)
    ms_whole = cuda_ms(lambda: DA.flash_decode(
        q, ck, cv, length, layer=next(layer_it) % N_LAYERS), 48)
    plain_whole = cuda_ms(lambda: DA._flash_decode_reference(
        q, ck, cv, length, layer=next(layer_it) % N_LAYERS), 12)

    def sdpa_step():
        i = next(layer_it) % N_LAYERS
        return torch.nn.functional.scaled_dot_product_attention(
            q, ck[i, :, :, :length + 1], cv[i, :, :, :length + 1])

    sdpa = cuda_ms(sdpa_step, 48)
    n_valid = length + 1
    kv_bytes = 2 * b * kvh * n_valid * 128 * 2
    part_bytes = b * kvh * n_chunks * (128 + 2) * 4
    fl = 4 * 128 * n_valid * b * kvh
    b_p, by_p = bound(fl, kv_bytes + q.numel() * 2 + part_bytes,
                      PEAK_BF16_FLOPS)
    b_c, by_c = bound(b * kvh * n_chunks * 128 * 3,
                      part_bytes + b * kvh * 128 * 2, PEAK_F32_FLOPS)
    b_w, by_w = bound(fl, kv_bytes + 2 * q.numel() * 2, PEAK_BF16_FLOPS)
    print(f"time flash_decode B8 kvH8 rep1 D128 bf16 length {n_valid} of "
          f"{MAX_LEN} ({n_chunks} chunks of {chunk}): partial {ms_p:.4f} ms "
          f"(plain {plain_p:.4f}), combine {ms_c:.4f} ms (plain "
          f"{plain_c:.4f}), whole {ms_whole:.4f} ms (plain {plain_whole:.4f}, "
          f"sdpa {sdpa:.4f}, bound {b_w:.4f} ms {by_w}), "
          f"{kv_bytes / ms_whole / 1e6:.1f} GB/s of cache")
    print("decode_whole " + json.dumps(dict(
        shape=f"B8 kvH8 rep1 D128 bf16 length {n_valid} M {MAX_LEN}",
        ms=ms_whole, plain_ms=plain_whole, library_ms=sdpa, bound_ms=b_w,
        bound_by=by_w)))
    for name, ms, plain, bms, bby, tol in (
            ("flash_decode_partial", ms_p, plain_p, b_p, by_p,
             "f32 partials: atol 1e-4 + rtol 1e-4"),
            ("flash_decode_combine", ms_c, plain_c, b_c, by_c,
             "bf16 out: atol 1e-2 + rtol 1e-2")):
        records.append(dict(
            name=name, route="cuda",
            source="tony_tpu_torch/csrc/flash_decode.cu",
            replaces="tony_tpu/ops/decode_attention.py:43 (_decode_kernel; "
                     ":118 _kernel_no_scale)",
            shape=f"B8 kvH8 rep1 D128 bf16 length {n_valid} M {MAX_LEN}",
            max_abs_err=errs[name], tolerance=tol, ms=ms, plain_ms=plain,
            bound_ms=bms, bound_by=bby, library_ms=None))
    del ck, cv, parts

    # ---- decode crossover: kernel against the plain einsum decode path
    cfg = T.TransformerConfig(d_model=1024, n_heads=8, n_kv_heads=8,
                              n_layers=1, dtype=torch.bfloat16)
    rows = []
    for m in (1024, 4096, 16384):
        ly = max(1, min(N_LAYERS, math.ceil(200e6 / (2 * b * kvh * m * 256))))
        ck, cv = randn(ly, b, kvh, m, 128), randn(ly, b, kvh, m, 128)
        qm = randn(b, 1, 8, 128)
        it = iter(range(10 ** 9))
        kern = cuda_ms(lambda: G._cached_attention(
            cfg, qm, ck, cv, m - 1, 1, layer_idx=next(it) % ly), 24)
        eins = cuda_ms(lambda: G._cached_attention(
            cfg, qm, ck, cv, m - 1, 1, allow_kernel=False,
            layer_idx=next(it) % ly), 12)
        rows.append(dict(M=m, kernel_ms=kern, einsum_ms=eins,
                         kernel_faster=kern < eins))
        del ck, cv
    print("decode_crossover " + json.dumps(rows))
    return records


def phase_bwd_kernels(torch, A) -> list:
    """The two flash backward kernels against _flash_bwd_reference on the
    card, then their timings at the training shape -> their records."""
    print("== backward kernels")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    errs = {"flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    bf16 = torch.bfloat16
    cases = [
        # (label, B, H, Lq, Lk, D, dtype, causal, window, g_lse, plain rows)
        ("causal L300", 8, 8, 300, 300, 128, bf16, True, None, False, 8),
        ("causal L1024", 8, 8, 1024, 1024, 128, bf16, True, None, False, 8),
        ("causal L2048", 8, 8, 2048, 2048, 128, bf16, True, None, False, 4),
        ("window 256 L2048", 2, 8, 2048, 2048, 128, bf16, True, 256, False,
         2),
        ("causal cross Lq300 Lk1000", 2, 8, 300, 1000, 128, bf16, True, None,
         False, 2),
        ("cross ragged Lq1024 Lk700", 2, 8, 1024, 700, 128, bf16, False,
         None, False, 2),
        ("empty rows Lq1024 Lk300 w128", 1, 4, 1024, 300, 128, bf16, True,
         128, True, 1),
        ("f32 D64 non-causal L777", 2, 4, 777, 777, 64, torch.float32,
         False, None, False, 2),
        ("g_lse causal L1024", 2, 8, 1024, 1024, 128, bf16, True, None, True,
         2),
        ("bf16 D64 causal L512", 2, 4, 512, 512, 64, bf16, True, None, False,
         2),
    ]
    for label, b, h, lq, lk, d, dt, causal, window, with_glse, rows in cases:
        q, k, v = randn(b, h, lq, d, dtype=dt), randn(b, h, lk, d, dtype=dt), \
            randn(b, h, lk, d, dtype=dt)
        g = randn(b, h, lq, d, dtype=dt)
        g_lse = randn(b, h, lq, dtype=torch.float32) if with_glse else None
        out, lse = A._flash_fwd_cuda(q, k, v, causal, None, window)
        dq, dk, dv = A._flash_bwd_cuda(q, k, v, out, lse, g, g_lse, causal,
                                       None, window)
        torch.cuda.synchronize()
        want = A._flash_bwd_reference(
            q[:rows], k[:rows], v[:rows], out[:rows], lse[:rows], g[:rows],
            None if g_lse is None else g_lse[:rows], causal, None, window)
        tol = BWD_BF16_TOL if dt == bf16 else BWD_F32_TOL
        e_dq = compare(f"flash_bwd_dq {label} dq", dq[:rows], want[0], tol)
        e_kv = max(compare(f"flash_bwd_dkdv {label} dk", dk[:rows], want[1],
                           tol),
                   compare(f"flash_bwd_dkdv {label} dv", dv[:rows], want[2],
                           tol))
        if label.startswith("empty rows"):
            # query rows past the last key's window see no key
            empty = torch.arange(lq, device=dev) >= lk + window - 1
            if not (dq[:, :, empty] == 0).all():
                fail("flash_bwd_dq: a row with no visible key must get dq 0")
        if label.startswith("causal cross"):
            # keys past the last query row are seen by no query
            if not ((dk[:, :, lq:] == 0).all() and (dv[:, :, lq:] == 0).all()):
                fail("flash_bwd_dkdv: a key no query sees must get dk = dv = 0")
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e_dq)
        errs["flash_bwd_dkdv"] = max(errs["flash_bwd_dkdv"], e_kv)
        print(f"flash_bwd {label} {str(dt)[6:]}: max|err| dq {e_dq:.3g}, "
              f"dk/dv {e_kv:.3g}")
        del q, k, v, g, g_lse, out, lse, dq, dk, dv, want

    # the model's layout through autograd: [B, L, H, D] views of a packed
    # projection, and the expanded all-zero-stride cotangent of out.sum()
    with torch.enable_grad():
        qkv = randn(2, 1024, 3, 8, 128).requires_grad_()
        A.attention_blhd(*qkv.unbind(2), causal=True).sum().backward()
    qt, kt, vt = (t.transpose(1, 2) for t in qkv.detach().unbind(2))
    out, lse = A._flash_fwd_reference(qt, kt, vt, True, None, None)
    want = A._flash_bwd_reference(qt, kt, vt, out, lse, torch.ones_like(out),
                                  None, True, None, None)
    for i, (nm, w) in enumerate(zip(("dq", "dk", "dv"), want)):
        e = compare(f"flash_bwd attention_blhd {nm}", qkv.grad[:, :, i],
                    w.transpose(1, 2), BWD_BF16_TOL)
        key = "flash_bwd_dq" if nm == "dq" else "flash_bwd_dkdv"
        errs[key] = max(errs[key], e)
    print("flash_bwd attention_blhd strided views, out.sum() cotangent: ok")
    del qkv, out, lse, want

    # ---- timings at the training shape: B8 H8 L2048 D128 bf16 causal
    b, h, l, d = TRAIN_BATCH, 8, TRAIN_SEQ, 128
    q, k, v, g = (randn(b, h, l, d) for _ in range(4))
    out, lse = A._flash_fwd_cuda(q, k, v, True, None, None)
    delta = A._delta(out, g, None).contiguous()
    ms_kv = cuda_ms(lambda: A._flash_bwd_dkdv_cuda(q, k, v, g, lse, delta,
                                                   True, None, None), 10)
    ms_dq = cuda_ms(lambda: A._flash_bwd_dq_cuda(q, k, v, g, lse, delta,
                                                 True, None, None), 10)
    ms_whole = cuda_ms(lambda: A._flash_bwd_cuda(q, k, v, out, lse, g, None,
                                                 True, None, None), 10)
    plain = cuda_ms(lambda: A._flash_bwd_reference(q, k, v, out, lse, g, None,
                                                   True, None, None), 3,
                    warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        lib_fb = cuda_ms(lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), g), 10)
        lib_f = cuda_ms(lambda: sdpa(qg, kg, vg, is_causal=True), 10)
    lib = lib_fb - lib_f
    pairs = visible_pairs(l, l, True, None) * b * h
    x = b * h * l * d * 2            # one bf16 [B, H, L, D] tensor
    rowf = b * h * l * 4             # one float32 [B, H, L] tensor
    b_kv, by_kv = bound(8 * d * pairs, 4 * x + 2 * rowf + 2 * x,
                        PEAK_BF16_FLOPS)
    b_dq, by_dq = bound(6 * d * pairs, 4 * x + 2 * rowf + x, PEAK_BF16_FLOPS)
    # the whole backward: K3's work, five products per visible pair, on
    # q, k, v, out, dO and lse in and dq, dk, dv out
    b_w, by_w = bound(10 * d * pairs, 5 * x + rowf + 3 * x, PEAK_BF16_FLOPS)
    print(f"time flash_bwd B{b} H{h} L{l} D{d} bf16 causal: dkdv {ms_kv:.4f} "
          f"ms (bound {b_kv:.4f} {by_kv}), dq {ms_dq:.4f} ms (bound "
          f"{b_dq:.4f} {by_dq}), whole {ms_whole:.4f} ms (plain {plain:.4f}, "
          f"sdpa backward {lib:.4f} = {lib_fb:.4f} fwd+bwd - {lib_f:.4f} fwd, "
          f"bound {b_w:.4f} {by_w}), "
          f"{10 * d * pairs / ms_whole / 1e9:.1f} TFLOP/s of K3's work")
    print("bwd_whole " + json.dumps(dict(
        shape=f"B{b} H{h} L{l} D{d} bf16 causal", ms=ms_whole,
        dkdv_ms=ms_kv, dq_ms=ms_dq, plain_ms=plain, library_ms=lib,
        library_fwd_bwd_ms=lib_fb, library_fwd_ms=lib_f, bound_ms=b_w,
        bound_by=by_w)))
    records = []
    for name, ms, bms, bby, replaces in (
            ("flash_bwd_dkdv", ms_kv, b_kv, by_kv,
             "tony_tpu/ops/attention.py:524 (_bwd_kernel_resident, dK/dV) and "
             "tony_tpu/ops/attention.py:342 (_kv_sweep_kernel)"),
            ("flash_bwd_dq", ms_dq, b_dq, by_dq,
             "tony_tpu/ops/attention.py:297 (_dq_kernel) and the dQ of "
             "tony_tpu/ops/attention.py:524 (_bwd_kernel_resident)")):
        records.append(dict(
            name=name, route="cuda", source="tony_tpu_torch/csrc/flash_bwd.cu",
            replaces=replaces, shape=f"B{b} H{h} L{l} D{d} bf16 causal",
            max_abs_err=errs[name],
            tolerance="bf16: atol 1e-2 + rtol 1e-2; f32: atol 1e-3 + rtol "
                      "1e-4",
            ms=ms, plain_ms=plain, bound_ms=bms, bound_by=bby,
            library_ms=lib,
            library="scaled_dot_product_attention backward (forward+backward "
                    "minus forward), the whole backward; plain_ms is the "
                    "whole plain backward too"))
    del q, k, v, g, out, lse, delta, qg, kg, vg
    return records


def phase_main_path(ops, lm_generate) -> dict:
    """The flagship generation path through its user entry point; returns
    the launches of each kernel over all requests."""
    print("== main path: generation")
    out_dir = REPO / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    totals = dict.fromkeys(ops.launch_counts(), 0)
    for i, (b, lp, extra) in enumerate(REQUESTS):
        metrics = out_dir / f"request{i}.json"
        argv = FLAGSHIP + ["--batch", str(b), "--prompt-len", str(lp),
                           "--max-new", str(MAX_NEW), "--max-len",
                           str(MAX_LEN), "--seed", str(i),
                           "--metrics-out", str(metrics)] + extra
        ops.reset_launch_counts()
        rc = lm_generate.main(argv)
        counts = ops.launch_counts()
        if rc != 0:
            fail(f"lm_generate exited {rc} on request {i}")
        m = json.loads(metrics.read_text())
        # lm_generate runs generate three times: warm-up, timed, and a
        # prefill-only run (max_new_tokens=1)
        want = {"flash_fwd": 3 * N_LAYERS,
                "flash_decode_partial": 2 * N_LAYERS * (MAX_NEW - 1),
                "flash_decode_combine": 2 * N_LAYERS * (MAX_NEW - 1),
                "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
        if counts != want:
            fail(f"request {i}: launches {counts}, expected {want}")
        toks = m["tokens"]
        if (len(toks) != MAX_NEW or m["decode_steps"] != MAX_NEW - 1
                or not all(0 <= t < 32768 for t in toks)):
            fail(f"request {i}: bad output {m}")
        for name, n in counts.items():
            totals[name] += n
        print(f"request {i}: batch {b} prompt {lp} "
              f"{m['kv_dtype']} kv: prefill {m['prefill_ms']:.2f} ms, decode "
              f"{m['decode_step_ms']:.3f} ms/step, "
              f"{m['batch_decode_tokens_per_sec']:.1f} tok/s "
              f"(batch), {m['decode_tokens_per_sec']:.1f} tok/s (per row, "
              f"with prefill); launches {counts}")
        print("request " + json.dumps(dict(
            request=i, batch=b, prompt_len=lp, kv_dtype=m["kv_dtype"],
            prefill_ms=m["prefill_ms"], decode_step_ms=m["decode_step_ms"],
            batch_decode_tokens_per_sec=m["batch_decode_tokens_per_sec"],
            decode_tokens_per_sec=m["decode_tokens_per_sec"],
            launches=counts)))
    return totals


def phase_train_path(torch, ops, lm_train) -> dict:
    """The flagship training path through its user entry point; returns the
    launches of each kernel over the run."""
    print("== main path: training")
    metrics = REPO / "build" / "chip_smoke" / "train.json"
    metrics.parent.mkdir(parents=True, exist_ok=True)
    argv = FLAGSHIP + ["--batch-size", str(TRAIN_BATCH), "--seq-len",
                       str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
                       "--metrics-out", str(metrics)]
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    rc = lm_train.main(argv)
    counts = ops.launch_counts()
    if rc != 0:
        fail(f"lm_train exited {rc}")
    per_step = TRAIN_STEPS * N_LAYERS
    want = {"flash_fwd": per_step, "flash_bwd_dkdv": per_step,
            "flash_bwd_dq": per_step, "flash_decode_partial": 0,
            "flash_decode_combine": 0}
    if counts != want:
        fail(f"training: launches {counts}, expected {want}")
    m = json.loads(metrics.read_text())
    losses = m["losses"]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"training: losses not all finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training: loss did not fall: {losses[0]} -> {losses[-1]}")
    flops_step = train_flops_per_token(1024, N_LAYERS, 4096, 32768,
                                       TRAIN_SEQ) * TRAIN_BATCH * TRAIN_SEQ
    achieved = flops_step * m["steps_per_sec"]
    print(f"training B{TRAIN_BATCH} L{TRAIN_SEQ}, {TRAIN_STEPS} steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, {m['steps_per_sec']:.3f} "
          f"steps/s, {m['tokens_per_sec']:.1f} tokens/s, model FLOPs "
          f"{flops_step / 1e12:.2f} TFLOP/step = {achieved / 1e12:.1f} TFLOP/s"
          f", {achieved / PEAK_BF16_FLOPS:.4f} of the bf16 peak; launches "
          f"{counts}")
    print("train " + json.dumps(dict(
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        first_loss=losses[0], final_loss=losses[-1],
        steps_per_sec=m["steps_per_sec"], tokens_per_sec=m["tokens_per_sec"],
        step_ms=1e3 / m["steps_per_sec"], model_flops_per_step=flops_step,
        model_flops_share_of_bf16_peak=achieved / PEAK_BF16_FLOPS,
        n_params=m["n_params"], launches=counts)))
    return counts


def _leaf_copies(torch, params, device, dtype=None):
    return {k: _leaf_copies(torch, v, device, dtype) if isinstance(v, dict)
            else v.detach().to(device, dtype).requires_grad_()
            for k, v in params.items()}


def phase_train_parity(torch, T) -> None:
    """Flagship width at 2 layers, one batch of 2 x 256 tokens, from the
    same float32 weights: the loss and every gradient of the card's kernel
    path (bf16) against the CPU's plain path in float32, and against the
    card's own plain path (attn_impl="ref", bf16)."""
    print("== parity: training")
    from tony_tpu_torch.train.step import _leaves

    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=2,
                              n_heads=8, n_kv_heads=8, d_ff=4096,
                              dtype=torch.float32)
    gen = torch.Generator().manual_seed(5)
    params = T.init(cfg, gen, "cpu")
    tokens = torch.randint(0, 32768, (2, 256), generator=gen)
    targets = torch.randint(0, 32768, (2, 256), generator=gen)

    def loss_and_grads(c, device):
        p = _leaf_copies(torch, params, device)
        names, leaves = zip(*_leaves(p))
        loss = T.loss_fn(p, tokens.to(device), targets.to(device), c)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), names, [g.float().cpu() for g in grads]

    dev = torch.device("cuda")
    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    want_loss, names, want = loss_and_grads(cfg, "cpu")
    before = _kernel_launch_total(torch)
    got_loss, _, got = loss_and_grads(bcfg, dev)
    if _kernel_launch_total(torch) - before < 3 * cfg.n_layers:
        fail("training parity: the card's kernel path did not run the "
             "flash kernels")
    plain_loss, _, plain = loss_and_grads(
        dataclasses.replace(bcfg, attn_impl="ref"), dev)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    e_cpu = {n: rel(g, w) for n, g, w in zip(names, got, want)}
    e_plain = {n: rel(g, w) for n, g, w in zip(names, got, plain)}
    worst_cpu, worst_plain = max(e_cpu.values()), max(e_plain.values())
    print(f"training parity: loss cpu f32 {want_loss:.5f}, card kernels bf16 "
          f"{got_loss:.5f}, card plain bf16 {plain_loss:.5f} (atol "
          f"{TRAIN_PARITY_LOSS_ATOL}); worst gradient relative norm error "
          f"card kernels vs cpu f32 {worst_cpu:.4f} "
          f"({max(e_cpu, key=e_cpu.get)}), vs card plain {worst_plain:.4f} "
          f"({max(e_plain, key=e_plain.get)}) (limit "
          f"{TRAIN_PARITY_GRAD_RTOL})")
    print("train_parity " + json.dumps(dict(
        loss_cpu_f32=want_loss, loss_card_kernels=got_loss,
        loss_card_plain=plain_loss, grad_rel_err_vs_cpu=e_cpu,
        grad_rel_err_vs_card_plain=e_plain)))
    if (abs(got_loss - want_loss) > TRAIN_PARITY_LOSS_ATOL
            or abs(got_loss - plain_loss) > TRAIN_PARITY_LOSS_ATOL):
        fail("training parity: the card's loss differs")
    if not all(map(math.isfinite, e_cpu.values())) or \
            max(worst_cpu, worst_plain) > TRAIN_PARITY_GRAD_RTOL:
        fail("training parity: the card's gradients differ")


def _kernel_launch_total(torch) -> int:
    from tony_tpu_torch import ops

    c = ops.launch_counts()
    return c["flash_fwd"] + c["flash_bwd_dkdv"] + c["flash_bwd_dq"]


def _profile_rows(prof, n):
    """(device ms per step, top kernels) from a torch.profiler run over n
    steps; device kernels only."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    top = [dict(kernel=k[:80], ms_per_step=us / 1e3 / n, calls_per_step=c / n)
           for us, k, c in rows[:10]]
    return sum(r[0] for r in rows) / 1e3 / n, top


def phase_train_profile(torch, T) -> None:
    """Where a flagship training step's time goes (batch 8 x 2048): host
    wall time against the device time the profiler records."""
    print("== profile: training step")
    from torch.profiler import ProfilerActivity, profile

    from tony_tpu_torch import train

    torch.cuda.empty_cache()
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=12,
                              n_heads=8, n_kv_heads=8, d_ff=4096,
                              max_seq_len=TRAIN_SEQ)
    bundle = train.create_train_step(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens, targets = train.synthetic_lm_batch(gen, TRAIN_BATCH, TRAIN_SEQ,
                                               32768)

    def steps(n):
        for _ in range(n):
            bundle.step_fn(bundle.params, bundle.opt_state, tokens, targets)
        torch.cuda.synchronize()

    steps(1)                                    # warm
    n = 3
    t0 = time.perf_counter()
    steps(n)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dev_ms, top = _profile_rows(prof, 2)
    if not top:
        print(f"profile: training step {wall_ms:.3f} ms wall; device time "
              "not measured (the profiler recorded no device activity)")
        return
    print(f"profile: training step B{TRAIN_BATCH} L{TRAIN_SEQ}: "
          f"{wall_ms:.3f} ms wall, {dev_ms:.3f} ms on the device, busy share "
          f"{dev_ms / wall_ms:.3f}, peak memory {peak_gb:.1f} GB")
    print("train_profile_top " + json.dumps(top))


def phase_parity(torch, G, T) -> None:
    """Flagship width at 2 layers, from the same weights and tokens: the
    card's kernel path (bf16) against the CPU's plain path in float32, and
    against the card's own plain path (attn_impl="ref", bf16)."""
    print("== parity")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=2,
                              n_heads=8, n_kv_heads=8, d_ff=4096,
                              dtype=torch.float32)
    gen = torch.Generator().manual_seed(7)
    params = T.init(cfg, gen, "cpu")
    prompt = torch.randint(0, 32768, (1, 256), generator=gen)
    dev = torch.device("cuda")
    gcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    gparams = G.prepare_decode(
        {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict)
             else v.to(dev)) for k, v in params.items()}, gcfg)
    cpu_prep = G.prepare_decode(params, cfg)

    ref_tokens = G.generate(cpu_prep, cfg, prompt, 16)
    gpu_tokens = G.generate(gparams, gcfg, prompt.to(dev), 16).cpu()
    agree = int((ref_tokens == gpu_tokens).long().cumprod(-1).sum())

    # teacher-forced logits: prefill (flash forward kernel) and 15 decode
    # steps (flash decode kernel) fed the CPU's greedy tokens
    def forced(w, c, device):
        cache = G.init_cache(c, 1, 272, device=device)
        logits, cache = G._forward_with_cache(w.params, c, prompt.to(device),
                                              cache, w.fused, prefill=True)
        out = [logits.float().cpu()]
        for t in ref_tokens[0, :-1]:
            logits, cache = G._forward_with_cache(
                w.params, c, t.view(1, 1).to(device), cache, w.fused)
            out.append(logits.float().cpu())
        return torch.cat(out)

    want = forced(cpu_prep, cfg, "cpu")
    got = forced(gparams, gcfg, dev)
    plain = forced(gparams, dataclasses.replace(gcfg, attn_impl="ref"), dev)
    err = (got - want).abs().max(dim=-1).values
    err_plain = float((got - plain).abs().max())
    print(f"parity: logits std {float(want.std()):.3f}; max |card bf16 - cpu "
          f"f32| prefill {float(err[0]):.4f}, decode steps "
          f"{float(err[1:].max()):.4f} (atol {PARITY_LOGITS_ATOL}); max "
          f"|card kernels - card plain| {err_plain:.4f} (atol "
          f"{KERNEL_PATH_ATOL}); greedy agreement {agree}/16 tokens")
    if not torch.isfinite(got).all() or float(err.max()) > PARITY_LOGITS_ATOL:
        fail("parity: card logits differ from the CPU float32 plain path")
    if err_plain > KERNEL_PATH_ATOL:
        fail("parity: the card's kernel path differs from its plain path")


def phase_profile(torch, G, T) -> None:
    """Where a flagship decode step's time goes: host wall time against the
    device time the profiler records, batch 8 with 2048 cached positions.
    Prints "not measured" if the profiler sees no device activity."""
    print("== profile: decode step")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=12,
                              n_heads=8, n_kv_heads=8, d_ff=4096)
    gen = torch.Generator(device=dev).manual_seed(11)
    w = G.prepare_decode(T.init(cfg, gen, dev), cfg)
    prompt = torch.randint(0, 32768, (8, 2048), generator=gen, device=dev)
    cache = G.init_cache(cfg, 8, 2048 + 64, device=dev)
    logits, cache = G._forward_with_cache(w.params, cfg, prompt, cache,
                                          w.fused, prefill=True)
    tok = logits.argmax(-1)[:, None]

    def steps(n, cache):
        for _ in range(n):
            logits, cache = G._forward_with_cache(w.params, cfg, tok, cache,
                                                  w.fused)
        torch.cuda.synchronize()
        return cache

    cache = steps(4, cache)                     # warm
    n = 16
    t0 = time.perf_counter()
    cache = steps(n, cache)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cache = steps(n, cache)
    dev_ms, top = _profile_rows(prof, n)
    if not top:
        print(f"profile: decode step {wall_ms:.3f} ms wall; device time not "
              "measured (the profiler recorded no device activity)")
        return
    print(f"profile: decode step B8 with 2048 cached: {wall_ms:.3f} ms wall, "
          f"{dev_ms:.3f} ms on the device, busy share {dev_ms / wall_ms:.3f}")
    print("profile_top " + json.dumps(top))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from tony_tpu_torch import ops
    from tony_tpu_torch.examples import lm_generate, lm_train
    from tony_tpu_torch.models import generate as G
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.ops import _build
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import decode_attention as DA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_card(_build)
    with torch.no_grad():
        records = phase_kernels(torch, A, DA, G, T)
        records += phase_bwd_kernels(torch, A)
    gen_launches = phase_main_path(ops, lm_generate)
    train_launches = phase_train_path(torch, ops, lm_train)
    launches = {k: gen_launches[k] + train_launches[k] for k in gen_launches}
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched {name}")
    for r in records:
        r["launches"] = launches[r["name"]]
    phase_parity(torch, G, T)
    phase_train_parity(torch, T)
    with torch.no_grad():
        phase_profile(torch, G, T)
    phase_train_profile(torch, T)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tolerance", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    for r in records:
        r["kernel_ms"] = r["ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys + ("library",)
                                   if k in r} for r in records]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
