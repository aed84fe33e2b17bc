"""The port's models: the flagship transformer's forward, its KV-cache
generation and the serving slot pool."""

from . import convert, generate, registry, serving, speculative, transformer

__all__ = ["convert", "generate", "registry", "serving", "speculative",
           "transformer"]
