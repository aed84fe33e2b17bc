"""Keyed model registry: the serving stack's weights, named (port of the
JAX package's models/registry.py, a host-side name table the port keeps
its own copy of).

- **Speculative decoding** is two models: the draft and the target are
  two registry entries, ``ModelEntry.draft`` naming the pairing, so a
  server built over the registry resolves its draft without a side
  channel.
- **Multi-model serving**: ``serve --model name=spec`` (repeatable)
  registers several entries; each gets its own engine (its own slot pool:
  cache shapes are per config), requests carry ``model=``, and /stats and
  /metrics label everything per model.
- **Checkpoint hot-swap**: re-registering a name replaces the entry and
  bumps its ``generation``, so tooling sees a swapped entry without
  diffing weights.

The registry never touches device memory: entries hold what the serving
layer already accepts (raw parameter dicts or ``DecodeWeights``), so
registering is free.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from .transformer import TransformerConfig


@dataclass
class ModelEntry:
    """One named model: decode-ready ``weights`` (raw params or a
    ``DecodeWeights`` bundle), its config, an optional ``draft`` naming
    the registry entry that speculates for it, a human-readable
    ``source`` (checkpoint path / init spec — hot-swap lineage), and a
    ``generation`` bumped on every re-registration under the same
    name."""
    name: str
    weights: Any
    cfg: TransformerConfig
    draft: str | None = None
    source: str = ""
    generation: int = 0


class ModelRegistry:
    """{name -> ModelEntry}. Registration order is preserved (the first
    entry is the default model a nameless request gets); re-registering
    a name replaces the entry and bumps its generation: the in-process
    half of a checkpoint hot-swap (the cross-process half is a rolling
    relaunch of the serve process)."""

    def __init__(self):
        self._entries: dict[str, ModelEntry] = {}

    def register(self, name: str, weights, cfg: TransformerConfig, *,
                 draft: str | None = None, source: str = "") -> ModelEntry:
        name = str(name)
        if not name:
            raise ValueError("model name must be non-empty")
        if draft is not None and str(draft) == name:
            raise ValueError(f"model {name!r} cannot be its own draft")
        prev = self._entries.get(name)
        entry = ModelEntry(
            name=name, weights=weights, cfg=cfg,
            draft=None if draft is None else str(draft), source=source,
            generation=(prev.generation + 1 if prev is not None else 0))
        self._entries[name] = entry
        return entry

    def get(self, name: str) -> ModelEntry:
        entry = self._entries.get(str(name))
        if entry is None:
            raise KeyError(
                f"unknown model {name!r}; registered: "
                f"{sorted(self._entries) or '(none)'}")
        return entry

    def resolve_draft(self, name: str) -> ModelEntry | None:
        """The draft entry paired with ``name`` (via ``ModelEntry.
        draft``), or None when the model speculates for nobody. A
        dangling draft name is an error at resolution time, not at
        registration (entries may register in any order)."""
        entry = self.get(name)
        if entry.draft is None:
            return None
        try:
            return self.get(entry.draft)
        except KeyError:
            raise KeyError(
                f"model {name!r} names draft {entry.draft!r}, which is "
                "not registered") from None

    @property
    def default(self) -> ModelEntry:
        if not self._entries:
            raise KeyError("empty model registry")
        return next(iter(self._entries.values()))

    def names(self) -> list[str]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return str(name) in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self):
        return iter(self._entries.values())


__all__ = ["ModelEntry", "ModelRegistry"]
