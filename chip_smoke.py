#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tony_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc, then runs five phases
and exits non-zero if any of them fails:

1. card: the GPU's name and power limit, and the kernels' build time;
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the flagship's shapes and at the edge cases, with its time beside the
   plain version's, a PyTorch library call's and the card's bound; the
   decode kernel against the plain einsum decode path at M in {1024, 4096,
   16384};
3. main path: tony_tpu_torch.examples.lm_generate at the flagship's full
   width (vocab 32768, d_model 1024, 12 layers, 8 heads, d_ff 4096, bf16,
   random weights from a seed) answering four requests, with every
   kernel's launch count checked against the count the requests need;
4. parity: the flagship's width at 2 layers on the card (kernels, bf16)
   against the CPU's plain path in float32, from the same weights;
5. profile: a flagship decode step's host wall time against the device
   time torch.profiler records.

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
    for name in ("flash_fwd", "flash_decode"):
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


def phase_main_path(ops, lm_generate) -> dict:
    """The flagship generation path through its user entry point; returns
    the launches of each kernel over all requests."""
    print("== main path")
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
                "flash_decode_combine": 2 * N_LAYERS * (MAX_NEW - 1)}
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
    print("== profile")
    from torch.autograd import DeviceType
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
    rows = []
    for e in prof.key_averages():           # device kernels only, no ops
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3 / n
    if not rows:
        print(f"profile: decode step {wall_ms:.3f} ms wall; device time not "
              "measured (the profiler recorded no device activity)")
        return
    top = [dict(kernel=k[:80], ms_per_step=us / 1e3 / n, calls_per_step=c / n)
           for us, k, c in rows[:8]]
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
    from tony_tpu_torch.examples import lm_generate
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
    launches = phase_main_path(ops, lm_generate)
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched {name}")
    for r in records:
        r["launches"] = launches[r["name"]]
    phase_parity(torch, G, T)
    with torch.no_grad():
        phase_profile(torch, G, T)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tolerance", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    for r in records:
        r["kernel_ms"] = r["ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
