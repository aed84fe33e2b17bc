"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in ``tony_tpu_torch/csrc`` becomes one shared library with a
plain C interface, compiled for ``sm_90a`` at first use into
``build/kernels/`` at the root of the checkout. A library's file name
carries a hash of its source and of every header in ``csrc``, so an edited
source or header is rebuilt and a stale library is never loaded.
``build_all`` starts one nvcc per source, all at once, and waits for them
together.

Nothing here runs at import: the tests import every module on machines
with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_fwd", "flash_decode", "flash_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)
_IP = ctypes.POINTER(ctypes.c_int)
# symbol -> (library, argtypes) of each C entry point (see the .cu sources)
SIGNATURES = {
    "tony_flash_fwd": (
        "flash_fwd", [_P] * 5 + [_I] * 6 + [_L] * 12 + [_F, _I, _I, _P]),
    "tony_flash_decode": (
        "flash_decode", [_P] * 10 + [_I] * 10 + [_L] * 5 + [_F, _P]),
    "tony_flash_decode_geometry": ("flash_decode", [_I] * 3 + [_IP]),
    "tony_flash_bwd_dkdv": (
        "flash_bwd", [_P] * 8 + [_I] * 6 + [_LP, _F, _I, _I, _P]),
    "tony_flash_bwd_dq": (
        "flash_bwd", [_P] * 7 + [_I] * 6 + [_LP, _F, _I, _I, _P]),
}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    rc = proc.wait()
    log = out.with_suffix(".log").read_text()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {rc}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


def build_all() -> float:
    """Build every kernel library that is not built yet, one nvcc per
    source in parallel -> seconds spent."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in SOURCES}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers and shared memory) for a library."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def kernel(symbol: str):
    """The C entry point ``symbol``, its library built on first use."""
    fn = _fns.get(symbol)
    if fn is None:
        name, argtypes = SIGNATURES[symbol]
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


__all__ = ["build_all", "build_log", "kernel", "check", "BUILD_DIR"]
