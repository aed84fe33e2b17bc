"""The port's attention ops: each has a hand-written CUDA kernel for a CUDA
tensor and a plain PyTorch version for a CPU tensor."""

from . import attention, decode_attention
from .attention import (
    attention_blhd, flash_attention, flash_attention_with_lse, flash_supported,
)
from .decode_attention import flash_decode


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``, by kernel."""
    return {"flash_fwd": attention.launches,
            "flash_decode_partial": decode_attention.partial_launches,
            "flash_decode_combine": decode_attention.combine_launches}


def reset_launch_counts() -> None:
    attention.reset_launches()
    decode_attention.reset_launches()


__all__ = ["attention_blhd", "flash_attention", "flash_attention_with_lse",
           "flash_supported", "flash_decode", "launch_counts",
           "reset_launch_counts"]
