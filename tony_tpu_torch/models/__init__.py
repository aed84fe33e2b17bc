"""The port's models: the flagship transformer's forward, its KV-cache
generation and the serving slot pool."""

from . import convert, generate, serving, transformer

__all__ = ["convert", "generate", "serving", "transformer"]
