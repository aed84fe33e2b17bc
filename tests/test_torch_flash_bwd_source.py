"""Source checks of the bf16 flash backward (tony_tpu_torch/csrc/flash_bwd.cu).

The card's kernels cannot run here, but two of their promises can be read
from the source: the bf16 backward kernels accumulate without atomics (so
dq, dk and dv are the same bits from run to run, which the remat, checkpoint
resume and elastic runs rely on), and each C entry point takes as many
arguments as ``_build.SIGNATURES`` hands it through ctypes.
"""

import re

import pytest

from tony_tpu_torch.ops import _build

SRC = (_build.CSRC / "flash_bwd.cu").read_text()
HELPERS = (_build.CSRC / "hopper.cuh").read_text()
ATOMICS = re.compile(r"atomic\w*\s*\(|\batom\.|\bred\.|cp\.reduce")


def _code(text: str) -> str:
    """text without its comments."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _body(text: str, name: str) -> str:
    """The brace-matched body of the function or kernel ``name``."""
    m = re.search(rf"\b{name}\s*\(", text)
    assert m, name
    i = text.index("{", m.end())
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise AssertionError(f"unbalanced braces after {name}")


@pytest.mark.parametrize("kernel", ["flash_bwd_dq_wgmma_kernel",
                                    "flash_bwd_dkdv_wgmma_kernel"])
def test_bf16_backward_kernels_use_no_atomics(kernel):
    body = _body(_code(SRC), kernel)
    assert "wgmma" in body.lower() or "Wgmma" in body
    assert not ATOMICS.findall(body)
    # nor do the device helpers they call
    assert not ATOMICS.findall(_code(HELPERS))


def _c_params(symbol: str) -> list:
    m = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*\{{', _code(SRC),
                  flags=re.S)
    assert m, symbol
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("symbol", ["tony_flash_bwd_dq",
                                    "tony_flash_bwd_dkdv"])
def test_entry_point_arguments_match_signatures(symbol):
    params = _c_params(symbol)
    lib, argtypes = _build.SIGNATURES[symbol]
    assert lib == "flash_bwd"
    assert len(params) == len(argtypes), (params, argtypes)
    # pointers where ctypes passes pointers, and the reverse
    for p, t in zip(params, argtypes):
        is_ptr = "*" in p
        assert is_ptr == (t in (_build._P, _build._LP)), (p, t)
