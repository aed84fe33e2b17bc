"""The port's models: the flagship transformer's forward and its KV-cache
generation."""

from . import convert, generate, transformer

__all__ = ["convert", "generate", "transformer"]
