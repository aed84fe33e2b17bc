"""The port's ops. Attention: each has a hand-written CUDA kernel for a CUDA
tensor and a plain PyTorch version for a CPU tensor. Cross-entropy: plain
PyTorch block products, as the JAX package leaves them to XLA."""

from . import attention, decode_attention
from .attention import (
    attention_blhd, flash_attention, flash_attention_with_lse, flash_supported,
)
from .cross_entropy import blockwise_cross_entropy, dense_cross_entropy
from .decode_attention import flash_decode


def launch_counts() -> dict:
    """Kernel launches since the last ``reset_launch_counts``, by kernel."""
    return {"flash_fwd": attention.launches,
            "flash_decode_partial": decode_attention.partial_launches,
            "flash_decode_combine": decode_attention.combine_launches,
            "flash_bwd_dkdv": attention.bwd_dkdv_launches,
            "flash_bwd_dq": attention.bwd_dq_launches}


def reset_launch_counts() -> None:
    attention.reset_launches()
    decode_attention.reset_launches()


__all__ = ["attention_blhd", "flash_attention", "flash_attention_with_lse",
           "flash_supported", "flash_decode", "blockwise_cross_entropy",
           "dense_cross_entropy", "launch_counts", "reset_launch_counts"]
