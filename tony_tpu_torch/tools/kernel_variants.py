"""Build variants of the port's kernels and compare them on one card.

    python -m tony_tpu_torch.tools.kernel_variants [NAME ...]

Each variant is a kernel source from ``tony_tpu_torch/csrc`` with textual
substitutions (a tile size, a loop's unroll, a compile-time switch). All
are compiled with the port's own nvcc flags, one nvcc per variant in
parallel, into ``build/variants/<name>/``; ptxas's registers and spills are
printed for each; each is held against the plain PyTorch version at the
edge cases at ``chip_smoke.py``'s tolerances, then timed in alternating
order (A B B A ...) with CUDA events, so that the comparison is made on one
card within one call. The attention variants: edge cases causal, window,
ragged cross attention, rows with no visible key, D = 64; timed at B8 H8
L2048 D128 bf16 causal. The decode variants: edge cases an unaligned
window, a tail tile, rep 8, D = 64, int8 and float32 caches, the whole
output and the float32 partials; timed at the four shapes of
``DECODE_SHAPES`` (B8 kvH8 rep1 D128 bf16 over 2081 of 4160 positions first),
the layers of a stack in turn (cold in L2), each variant over the split
that its own build's tile and CTAs an SM give (its
``tony_flash_decode_geometry``). It needs a CUDA device and nvcc; it
changes nothing in the package.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops import attention as A
from ..ops import decode_attention as DA

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "build" / "variants"

# the forward without its register spill: the K/V sources recomputed at each
# prefetch instead of kept as 64-bit pointers across the sweep
_FWD_NO_SPILL = {
    """  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
""": """  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  auto load_kv = [&](int st, int j) {
    const int bhj = static_cast<int>(opaque(bh)), b = bhj / a.H, h = bhj % a.H;
    cp_tile<MK, D, MTHREADS>(ks + st * MK * DP,
                             static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh,
                             a.k_sl, j * MK, a.Lk);
    cp_tile<MK, D, MTHREADS>(vs + st * MK * DP,
                             static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh,
                             a.v_sl, j * MK, a.Lk);
  };
""",
    """  if (lo < hi) {
    cp_tile<MK, D, MTHREADS>(ks, kg, a.k_sl, lo * MK, a.Lk);
    cp_tile<MK, D, MTHREADS>(vs, vg, a.v_sl, lo * MK, a.Lk);
  }""": "  if (lo < hi) load_kv(0, lo);",
    """    if (j + 1 < hi) {
      cp_tile<MK, D, MTHREADS>(ks + (st ^ 1) * MK * DP, kg, a.k_sl, (j + 1) * MK, a.Lk);
      cp_tile<MK, D, MTHREADS>(vs + (st ^ 1) * MK * DP, vg, a.v_sl, (j + 1) * MK, a.Lk);
    }""": "    if (j + 1 < hi) load_kv(st ^ 1, j + 1);",
    "      __nv_bfloat16* orow = og + row * a.o_sl + 2 * t;":
        "      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + "
        "h * a.o_sh + row * a.o_sl + 2 * t;",
}

# the dK/dV kernel with the swept tiles' sources kept as 64-bit pointers
# across the sweep (the committed kernel recomputes them at each prefetch)
_BWD_POINTERS_KEPT = {
    """  auto load_q = [&](int st, int j) {
    const int bhj = static_cast<int>(opaque(bh)), b = bhj / a.H, h = bhj % a.H;
    const int q0 = j * MR;
    cp_tile<MR, D, MTHREADS>(qs + st * TILE,
                             static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh,
                             a.q_sl, q0, a.Lq);
    cp_tile<MR, D, MTHREADS>(gs + st * TILE,
                             static_cast<const __nv_bfloat16*>(a.g) + b * a.g_sb + h * a.g_sh,
                             a.g_sl, q0, a.Lq);
    const int r = tid % MR, row = q0 + r;
    const float* src = (tid < MR ? a.lse : a.delta) + static_cast<long long>(bhj) * a.Lq;""":
    """  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                             (bh / a.H) * a.q_sb + (bh % a.H) * a.q_sh;
  const __nv_bfloat16* gg = static_cast<const __nv_bfloat16*>(a.g) +
                             (bh / a.H) * a.g_sb + (bh % a.H) * a.g_sh;
  const float* lseg = a.lse + static_cast<long long>(bh) * a.Lq;
  const float* deltag = a.delta + static_cast<long long>(bh) * a.Lq;
  auto load_q = [&](int st, int j) {
    const int q0 = j * MR;
    cp_tile<MR, D, MTHREADS>(qs + st * TILE, qg, a.q_sl, q0, a.Lq);
    cp_tile<MR, D, MTHREADS>(gs + st * TILE, gg, a.g_sl, q0, a.Lq);
    const int r = tid % MR, row = q0 + r;
    const float* src = tid < MR ? lseg : deltag;""",
}

# the decode kernel's compile-time switches, as committed
_STAGES = "constexpr int STAGES = 2;"
_TILE = "constexpr int TILE_BYTES = 16384;"

# name -> (source, {text: replacement}); the committed sources first
VARIANTS = {
    "fwd": ("flash_fwd", {}),
    "fwd_no_spill": ("flash_fwd", _FWD_NO_SPILL),
    "fwd_key_tile_64": ("flash_fwd", {"constexpr int MK = 32;":
                                      "constexpr int MK = 64;"}),
    "fwd_mask_every_tile": ("flash_fwd", {"softmax_step<false>(":
                                          "softmax_step<true>("}),
    "bwd": ("flash_bwd", {}),
    "bwd_pointers_kept": ("flash_bwd", _BWD_POINTERS_KEPT),
    "bwd_chunk_16": ("flash_bwd", {"constexpr int QC = 32;":
                                   "constexpr int QC = 16;"}),
    "bwd_chunks_unrolled": ("flash_bwd", {
        "#pragma unroll 1  // chunk by chunk: unrolled, the chunks overlap "
        "and spill": "#pragma unroll"}),
    "decode": ("flash_decode", {}),
    "decode_stages_3": ("flash_decode", {_STAGES: _STAGES[:-2] + "3;"}),
    "decode_stages_4": ("flash_decode", {_STAGES: _STAGES[:-2] + "4;"}),
    "decode_tile_8k": ("flash_decode", {_TILE: _TILE.replace("16384", "8192")}),
    "decode_tile_32k": ("flash_decode", {
        _TILE: _TILE.replace("16384", "32768")}),
    "decode_128_threads": ("flash_decode", {
        "constexpr int THREADS = 256;": "constexpr int THREADS = 128;"}),
    # over other splits (DECODE_SPLITS below)
    "decode_one_per_sm": ("flash_decode", {}),
    "decode_one_chunk": ("flash_decode", {}),
    "decode_int8_by_i2f": ("flash_decode", {
        "      x[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4b000000u, "
        "0x7440 + i % 4)) - 8388736.f;":
        "      x[i] = static_cast<float>(static_cast<int8_t>("
        "(u_[i / 4] >> (8 * (i % 4))) & 0xff));",
        "    const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};":
        "    const uint32_t u_[2] = {u.x, u.y};"}),
}


def _build_variant(name, src, subs):
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        (d / f.name).write_text(f.read_text())
    text = (_build.CSRC / f"{src}.cu").read_text()
    for old, new in subs.items():
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {src}.cu")
        text = text.replace(old, new)
    (d / f"{src}.cu").write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
           str(d / "lib.so"), str(d / f"{src}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _fn(lib, symbol):
    f = getattr(lib, symbol)
    f.argtypes = _build.SIGNATURES[symbol][1]
    f.restype = ctypes.c_int
    return f


def _fwd(lib, q, k, v, causal, window):
    b, h, lq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _build.check("variant flash_fwd", _fn(lib, "tony_flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, lq, k.shape[2], d, A.KERNEL_DTYPES[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        d ** -0.5, int(causal), int(window or 0),
        torch.cuda.current_stream().cuda_stream))
    return out, lse


def _bwd(lib, q, k, v, g, lse, delta, causal, window):
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    rest = A._bwd_args(q, k, v, g, dq, dk, dv, causal, None, window)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    _build.check("variant flash_bwd_dkdv", _fn(lib, "tony_flash_bwd_dkdv")(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *rest))
    _build.check("variant flash_bwd_dq", _fn(lib, "tony_flash_bwd_dq")(
        *ptrs, dq.data_ptr(), *rest))
    return dq, dk, dv


def _decode_cases(C, name, lib, geometry, gen):
    """Hold a decode variant against the plain versions at the edge cases;
    -> the largest error of the whole output."""
    from ..models import generate as G

    worst = 0.0
    cases = [  # (label, B, kvH, rep, M, length, window, cache dtype, D)
        ("M4096 full", 8, 8, 1, 4096, 4095, 0, torch.bfloat16, 128),
        ("window 777 unaligned lo", 8, 8, 1, 4096, 3000, 777, torch.bfloat16,
         128),
        ("length M-1, M not a tile multiple", 4, 8, 1, 4100, 4099, 0,
         torch.bfloat16, 128),
        ("rep 8", 2, 2, 8, 4096, 3001, 0, torch.bfloat16, 128),
        ("D64 bf16", 4, 8, 2, 3000, 2999, 0, torch.bfloat16, 64),
        ("int8 window GQA", 4, 4, 2, 4000, 3999, 700, torch.int8, 128),
        ("float32 q and cache", 2, 4, 2, 2000, 1500, 0, torch.float32, 128),
    ]
    for label, b, kvh, rep, m, length, window, cdt, d in cases:
        qdt = torch.float32 if cdt == torch.float32 else torch.bfloat16
        q = torch.randn((b, kvh, rep, d), generator=gen, device="cuda",
                        dtype=qdt)
        ck, cv = (torch.randn((b, kvh, m, d), generator=gen, device="cuda",
                              dtype=qdt) for _ in range(2))
        ks = vs = None
        if cdt == torch.int8:
            (ck, ks), (cv, vs) = G._quantize_kv(ck), G._quantize_kv(cv)
        lo, hi = DA._valid_range(length, window)
        chunk, n_chunks = _decode_split(name, hi - lo + 1, b * kvh, rep, d,
                                        ck.dtype, geometry)
        out, *parts = DA._decode_cuda(q, ck, cv, ks, vs, lo, length, chunk,
                                      n_chunks, None, entry=lib)
        want = DA._flash_decode_reference(q, ck, cv, length, ks, vs,
                                          window=window)
        tol = C.BF16_TOL if qdt == torch.bfloat16 else C.F32_TOL
        e = C.compare(f"{label} out", out.reshape(want.shape), want, tol)
        p_want = DA._decode_partial_reference(q, ck, cv, ks, vs, lo, length,
                                              chunk, n_chunks)
        for nm, g, w in zip("oml", parts, p_want):
            C.compare(f"{label} part_{nm}", g, w, C.PART_TOL)
        worst = max(worst, e)
    return worst


# decode variants run over another split than the wrapper's: one chunk a
# head (64 CTAs at batch 8), or the split made for one CTA an SM
DECODE_SPLITS = {"decode_one_chunk": "one chunk",
                 "decode_one_per_sm": "one CTA an SM"}


def _decode_split(name, n_valid, heads, rep, d, dtype, geometry):
    """(chunk, n_chunks) a decode variant runs with; ``geometry``: its
    build's tony_flash_decode_geometry."""
    if DECODE_SPLITS.get(name) == "one chunk":
        return n_valid, 1
    tile, per_sm = DA._geometry_of(geometry, d, dtype, rep)
    if name in DECODE_SPLITS:
        per_sm = 1
    return DA._kernel_split(n_valid, heads, rep, d, dtype,
                            geometry=(tile, per_sm))


# decode timing shapes: (label, B, valid positions, capacity M, layers, int8)
DECODE_SHAPES = [
    ("B8 kvH8 rep1 D128 bf16 2081 of 4160", 8, 2081, 4160, 12, False),
    ("B8 kvH8 rep1 D128 bf16 16384 of 16384", 8, 16384, 16384, 2, False),
    ("B8 kvH8 rep1 D128 int8 16384 of 16384", 8, 16384, 16384, 2, True),
    ("B1 kvH8 rep1 D128 bf16 4097 of 4160", 1, 4097, 4160, 12, False),
]


def _decode_timing_shape(gen, b, n_valid, m, ly, int8):
    """q and a [ly, B, 8, m, 128] stack, its layers taken in turn so that
    each call finds its layer cold in L2 -> (the first seven arguments of
    DA._decode_cuda, a layer cycle)."""
    from ..models import generate as G

    q = torch.randn((b, 8, 1, 128), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    ck, cv = (torch.randn((ly, b, 8, m, 128), generator=gen, device="cuda",
                          dtype=torch.bfloat16) for _ in range(2))
    ks = vs = None
    if int8:
        (ck, ks), (cv, vs) = G._quantize_kv(ck), G._quantize_kv(cv)
    return (q, ck, cv, ks, vs, 0, n_valid - 1), \
        (i % ly for i in range(10 ** 9))


def main(argv=None) -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke as C

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    names = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    jobs = {n: _build_variant(n, *VARIANTS[n]) for n in names}
    libs = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for fn, (regs, st, ld) in sorted(C.ptxas_report(log).items()):
            if "mma" in fn or "decode" in fn:
                print(f"ptxas {name}: {fn}: {regs} registers, spill stores "
                      f"{st} B, spill loads {ld} B")
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
    kind = {n: VARIANTS[n][0] for n in libs}

    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    cases = [  # (label, B, H, Lq, Lk, D, causal, window)
        ("causal L2048", 2, 8, 2048, 2048, 128, True, None),
        ("window 256", 2, 8, 2048, 2048, 128, True, 256),
        ("cross ragged Lq1024 Lk700", 2, 8, 1024, 700, 128, False, None),
        ("empty rows Lq1024 Lk300 w128", 1, 4, 1024, 300, 128, True, 128),
        ("D64 causal L777", 2, 4, 777, 777, 64, True, None),
    ]
    times = {n: [] for n in libs}
    with torch.no_grad():
        attn = [n for n in libs if kind[n] != "flash_decode"]
        for label, b, h, lq, lk, d, causal, window in cases if attn else ():
            q, k, v, g = randn(b, h, lq, d), randn(b, h, lk, d), \
                randn(b, h, lk, d), randn(b, h, lq, d)
            out, lse = A._flash_fwd_reference(q, k, v, causal, None, window)
            want = A._flash_bwd_reference(q, k, v, out, lse, g, None, causal,
                                          None, window)
            delta = A._delta(out, g, None).contiguous()
            for name in attn:
                lib = libs[name]
                if kind[name] == "flash_fwd":
                    got_out, got_lse = _fwd(lib, q, k, v, causal, window)
                    e = C.compare(f"{name} {label} out", got_out, out,
                                  C.BF16_TOL)
                    C.compare(f"{name} {label} lse", got_lse, lse, C.LSE_TOL)
                else:
                    got = _bwd(lib, q, k, v, g, lse, delta, causal, window)
                    e = max(C.compare(f"{name} {label} d{n}", x, w,
                                      C.BWD_BF16_TOL)
                            for n, x, w in zip("qkv", got, want))
                print(f"{name} {label}: max|err| {e:.3g}")
        if attn:
            q, k, v, g = (randn(8, 8, 2048, 128) for _ in range(4))
            out, lse = A._flash_fwd_cuda(q, k, v, True, None, None)
            delta = A._delta(out, g, None).contiguous()
            for order in (attn, attn[::-1]) * 2:
                for name in order:
                    lib = libs[name]
                    if kind[name] == "flash_fwd":
                        times[name].append(C.cuda_ms(
                            lambda: _fwd(lib, q, k, v, True, None), 20))
                    else:
                        times[name].append(C.cuda_ms(
                            lambda: _bwd(lib, q, k, v, g, lse, delta, True,
                                         None), 20))
            del q, k, v, g, out, lse, delta

        dec = [n for n in libs if kind[n] == "flash_decode"]
        entries = {n: _fn(libs[n], "tony_flash_decode") for n in dec}
        geometry = {n: _fn(libs[n], "tony_flash_decode_geometry")
                    for n in dec}
        for name in dec:
            e = _decode_cases(C, name, entries[name], geometry[name], gen)
            print(f"{name}: every edge case within tolerance, max|err| of the "
                  f"output {e:.3g}")
        for label, *shape in DECODE_SHAPES if dec else ():
            args, layers = _decode_timing_shape(gen, *shape)
            split = {n: _decode_split(n, shape[1], shape[0] * 8, 1, 128,
                                      args[1].dtype, geometry[n])
                     for n in dec}
            for order in (dec, dec[::-1]) * 3:
                for name in order:
                    times[(name, label)] = times.get((name, label), []) + [
                        C.cuda_ms(lambda: DA._decode_cuda(
                            *args, *split[name], next(layers),
                            entry=entries[name]), 48)]
            del args
    for key, t in times.items():
        if not t:
            continue
        name, shape = key if isinstance(key, tuple) else \
            (key, "B8 H8 L2048 D128 bf16 causal")
        print(f"time {name} {shape}: " + " ".join(f"{x:.4f}" for x in t)
              + f" ms (min {min(t):.4f})")
    print(C.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
