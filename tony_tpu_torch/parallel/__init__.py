"""Parallelism for the port. Only the plain attention is ported so far;
the mesh, ring and Ulysses paths come with their own slice."""

from .ring_attention import NEG_INF, reference_attention

__all__ = ["NEG_INF", "reference_attention"]
