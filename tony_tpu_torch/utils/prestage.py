"""Checkpoint prestage: a pure-filesystem helper the executor runs (the
port's own copy of the JAX package's utils/prestage.py).

It lives under utils, not train/: the executor runs ``python -S`` with no
torch, and ``tony_tpu_torch.train`` imports torch. An elastic rejoin's
executor reads the newest checkpoint before it registers
(``$TONY_PRESTAGE_CKPT``), so the gang barrier opens onto a worker whose
checkpoint bytes are already local (the page cache on a local disk, the
fetch itself on a remote mount) and the child's restore after the barrier
reads warm data.
"""

from __future__ import annotations

import logging
from pathlib import Path

log = logging.getLogger(__name__)


def prestage_checkpoint(directory: str) -> dict | None:
    """Read every file of the newest complete checkpoint under
    ``directory`` -> ``{"step", "files", "bytes"}``, or None when there is
    nothing saved yet. Never raises: a failed prestage leaves the child a
    cold restore, never a failed relaunch.

    The layout is train/checkpoint.py's: one directory a kept step, named
    by the bare integer (``<step>/state.pt``). A save in flight writes
    ``<step>.tmp-<pid>`` and renames it into place, so ``isdigit`` alone
    skips every unfinished save (the JAX package's orbax temporaries,
    ``<step>.orbax-checkpoint-tmp-<n>``, are skipped the same way)."""
    try:
        root = Path(directory)
        if not root.is_dir():
            return None
        steps = [int(p.name) for p in root.iterdir()
                 if p.is_dir() and p.name.isdigit()]
        if not steps:
            return None
        step = max(steps)
        n_files = n_bytes = 0
        for p in sorted((root / str(step)).rglob("*")):
            if not p.is_file():
                continue
            n_files += 1
            with open(p, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    n_bytes += len(chunk)
        return {"step": step, "files": n_files, "bytes": n_bytes}
    except OSError:
        log.exception("checkpoint prestage of %s failed; the child "
                      "restores cold", directory)
        return None
