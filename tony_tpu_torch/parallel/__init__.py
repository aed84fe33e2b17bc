"""Parallelism for the port: the plain attention and the Mixture-of-Experts
FFN (single device); the mesh, ring, Ulysses and expert-sharded paths come
with the mesh slice."""

from .expert import load_balancing_loss, moe_ffn, top_k_routing
from .ring_attention import NEG_INF, reference_attention

__all__ = ["NEG_INF", "reference_attention", "top_k_routing", "moe_ffn",
           "load_balancing_loss"]
