"""Build variants of the bf16 attention kernels and compare them on one card.

    python -m tony_tpu_torch.tools.kernel_variants [NAME ...]

Each variant is a kernel source from ``tony_tpu_torch/csrc`` with textual
substitutions (a tile size, a loop's unroll). All are compiled with the
port's own nvcc flags, one nvcc per variant in parallel, into
``build/variants/<name>/``; ptxas's registers and spills are printed for
each; each is held against the plain PyTorch version at the edge cases
(causal, window, ragged cross attention, rows with no visible key, D = 64)
at ``chip_smoke.py``'s tolerances, then timed at B8 H8 L2048 D128 bf16
causal in alternating order (A B B A ...) with CUDA events, so that the
comparison is made on one card within one call. It needs a CUDA device and
nvcc; it changes nothing in the package.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops import attention as A

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
            if "mma" in fn:
                print(f"ptxas {name}: {fn}: {regs} registers, spill stores "
                      f"{st} B, spill loads {ld} B")
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))

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
    with torch.no_grad():
        for label, b, h, lq, lk, d, causal, window in cases:
            q, k, v, g = randn(b, h, lq, d), randn(b, h, lk, d), \
                randn(b, h, lk, d), randn(b, h, lq, d)
            out, lse = A._flash_fwd_reference(q, k, v, causal, None, window)
            want = A._flash_bwd_reference(q, k, v, out, lse, g, None, causal,
                                          None, window)
            delta = A._delta(out, g, None).contiguous()
            for name, lib in libs.items():
                if VARIANTS[name][0] == "flash_fwd":
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

        q, k, v, g = (randn(8, 8, 2048, 128) for _ in range(4))
        out, lse = A._flash_fwd_cuda(q, k, v, True, None, None)
        delta = A._delta(out, g, None).contiguous()
        times = {n: [] for n in libs}
        for order in (list(libs), list(libs)[::-1]) * 2:
            for name in order:
                lib = libs[name]
                if VARIANTS[name][0] == "flash_fwd":
                    times[name].append(C.cuda_ms(
                        lambda: _fwd(lib, q, k, v, True, None), 20))
                else:
                    times[name].append(C.cuda_ms(
                        lambda: _bwd(lib, q, k, v, g, lse, delta, True,
                                     None), 20))
    for name, t in times.items():
        print(f"time {name} B8 H8 L2048 D128 bf16 causal: "
              + " ".join(f"{x:.4f}" for x in t) + f" ms (min {min(t):.4f})")
    print(C.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
