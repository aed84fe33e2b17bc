"""The port's package stands alone: it imports neither JAX nor anything of
the JAX package, its entry points run on the GPU unless the caller names
the CPU, and its CUDA sources ship with it."""

import json
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest
import torch

from tony_tpu_torch import resolve_device
from tony_tpu_torch.examples import lm_generate
from tony_tpu_torch.models.generate import init_cache
from tony_tpu_torch.models.transformer import TransformerConfig
from tony_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "tony_tpu_torch"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "tony_tpu", "orbax", "safetensors",
                   "transformers"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import tony_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tony_tpu_torch.__path__,
                                               "tony_tpu_torch.")]
for name in ("tony_tpu_torch.train.checkpoint",
             "tony_tpu_torch.examples.elastic_train",
             "tony_tpu_torch.observability", "tony_tpu_torch.metrics",
             "tony_tpu_torch.events.trace",
             "tony_tpu_torch.tools.serving_ab",
             "tony_tpu_torch.tools.reaper_ab",
             "tony_tpu_torch.tools.tp_mesh_cost",
             "tony_tpu_torch.tools.train_mesh_cost",
             "tony_tpu_torch.models.hf_import",
             "tony_tpu_torch.parallel.mesh", "tony_tpu_torch.parallel.sharding",
             "tony_tpu_torch.parallel.spmd",
             "tony_tpu_torch.parallel.lockstep",
             "tony_tpu_torch.parallel.tp_replay",
             "tony_tpu_torch.parallel.collectives",
             "tony_tpu_torch.parallel.ring_attention",
             "tony_tpu_torch.parallel.ulysses",
             "tony_tpu_torch.parallel.pipeline",
             "tony_tpu_torch.parallel.expert",
             "tony_tpu_torch.train.pipeline_step",
             "tony_tpu_torch.train.bootstrap", "tony_tpu_torch.data.loader"):
    assert name in names, name
for name in names:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "tony_tpu", "orbax", "safetensors",
                                  "transformers") for m in sys.modules)
print(len(names))
"""


def test_package_imports_with_jax_and_tony_tpu_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 12     # every module was imported


def test_source_names_neither_jax_nor_the_jax_package():
    bad = re.compile(r"^\s*(import|from)\s+jax\b|\btony_tpu\b(?!_torch)",
                     re.MULTILINE)
    offenders = [str(p.relative_to(REPO))
                 for p in sorted(PKG.rglob("*")) if p.suffix in
                 (".py", ".cu", ".cuh") and bad.search(p.read_text())]
    assert offenders == []
    # the smoke script names the JAX kernels it replaces, and imports none
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|tony_tpu)\b", smoke,
                         re.MULTILINE)


def test_entry_points_need_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_generate.main(["--d-model", "16", "--n-layers", "1",
                          "--n-heads", "2", "--d-ff", "32", "--vocab", "32",
                          "--max-new", "2"])
    cfg = TransformerConfig(d_model=16, n_heads=2, n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    assert init_cache(cfg, 1, 8, device="cpu").k.device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")


def test_lm_generate_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "m.json"
    rc = lm_generate.main(["--device", "cpu", "--d-model", "16",
                           "--n-layers", "2", "--n-heads", "2", "--d-ff",
                           "32", "--vocab", "32", "--dtype", "float32",
                           "--prompt", "1 2 3", "--max-new", "5",
                           "--metrics-out", str(out)])
    assert rc == 0
    m = json.loads(out.read_text())
    assert len(m["tokens"]) == 5 and m["generated_tokens"] == 5
    assert m["decode_steps"] == 4 and m["device"] == "cpu"
    assert all(0 <= t < 32 for t in m["tokens"])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == " ".join(str(t) for t in m["tokens"])
    # the same seed gives the same tokens; random batched prompts work too
    rc = lm_generate.main(["--device", "cpu", "--d-model", "16",
                           "--n-layers", "2", "--n-heads", "2", "--d-ff",
                           "32", "--vocab", "32", "--dtype", "float32",
                           "--prompt", "1 2 3", "--max-new", "5",
                           "--metrics-out", str(out)])
    assert json.loads(out.read_text())["tokens"] == m["tokens"]
    rc = lm_generate.main(["--device", "cpu", "--d-model", "16",
                           "--n-layers", "1", "--n-heads", "2", "--d-ff",
                           "32", "--vocab", "32", "--batch", "3",
                           "--prompt-len", "7", "--max-new", "3",
                           "--kv-dtype", "int8", "--stop-tokens", "5",
                           "--metrics-out", str(out)])
    m = json.loads(out.read_text())
    assert rc == 0 and m["batch"] == 3 and m["prompt_len"] == 7


@pytest.mark.parametrize("flags,what", [
    (["--tensor-parallel", "2", "--draft-checkpoint-dir", "/nonexistent"],
     "TP decode and serving"),
])
def test_lm_generate_flags_not_yet_ported(flags, what):
    """Flags whose ROADMAP.md queue-1 item (``what``) is ported now raise
    the JAX package's refusals: tensor-parallel decode with a draft."""
    with pytest.raises(SystemExit,
                       match="single-device greedy.*--tensor-parallel"):
        lm_generate.main(["--device", "cpu"] + flags)


def test_kernel_sources_ship_and_build_for_sm90a():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    data = cfg["tool"]["setuptools"]["package-data"]["tony_tpu_torch"]
    assert "csrc/*.cu" in data and "csrc/*.cuh" in data
    assert "tony_tpu*" in cfg["tool"]["setuptools"]["packages"]["find"][
        "include"]
    for name, _ in _build.SIGNATURES.values():
        assert (_build.CSRC / f"{name}.cu").exists()
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    # the library's name follows its source, so an edited source rebuilds
    assert _build._lib_path("flash_fwd") != _build._lib_path("flash_decode")
    assert _build._lib_path("flash_fwd").parent == _build.BUILD_DIR
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored and "*.so" in ignored


def test_launch_errors_raise():
    _build.check("k", 0)
    with pytest.raises(RuntimeError, match="cudaError 98"):
        _build.check("k", 98)


def test_library_path_follows_every_header(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include "b.cuh"\n')
    (tmp_path / "a.cuh").write_text("// a\n")
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._lib_path("k")
    assert _build._lib_path("k") == before       # stable while nothing changes
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    edited = _build._lib_path("k")
    assert edited != before
    (tmp_path / "c.cuh").write_text("// a new header\n")
    assert _build._lib_path("k") not in (before, edited)
