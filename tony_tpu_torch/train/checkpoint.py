"""Checkpoint and resume (port of the JAX package's train/checkpoint.py,
without orbax).

One directory per kept step, named by the bare integer, holding
``state.pt``: ``torch.save`` of the saved tree (nested dicts, lists and
tuples of tensors and Python scalars; the optimizer state's ``count`` is a
Python int). A save writes into ``<step>.tmp-<pid>`` and renames it into
place, so a kill mid-write leaves no integer-named directory behind: the
newest integer-named directory is always a complete save, for
``latest_step`` here and for the executor's prestage walk alike. Loading
uses ``torch.load(weights_only=True)``, which reads only tensors and plain
containers.

Which saves are kept follows the JAX package's orbax manager exactly, so
both frameworks resume at the same ``latest_step() + 1`` for the same
sequence of saves:

- a step at or below the newest kept step is dropped (a second save of the
  same step included);
- otherwise a step is kept when it is a multiple of ``save_interval``, or
  when nothing is kept yet (the first save of a fresh manager on an empty
  directory, whatever its number);
- after each write only the newest ``max_to_keep`` steps stay on disk.

So a drain checkpoint at a step off the interval is dropped, as in the
JAX package, and the relaunch recomputes from the last kept step.

``save_async`` is the overlapped path for training loops: it copies the
state to host memory synchronously (``AdamW.step`` updates parameters and
moments in place, so the snapshot must be a copy that the next step cannot
touch) and hands the write to one writer thread behind a depth-1 queue. A
writer's error is raised by the next ``save_async`` or ``wait``.

A sharded state (DTensors: train/step.py on a mesh) is saved whole, in the
same ``state.pt`` format: every rank calls ``save``/``save_async``, each
DTensor is all-gathered over the mesh on the device one leaf at a time (a
collective), and rank 0 alone copies the gathered leaf to host memory and
writes; the other ranks drop it at once, so they hold no host copy and
never wait on a copy from the card (FSDP's ``rank0_only`` full state
dict does the same). Each rank's device memory holds one whole leaf at a
time beside its shards. The file does not record the mesh, so it restores
onto any mesh shape or onto one device: ``restore(template=...)`` gives a
DTensor leaf of the template this rank's block of the saved tensor, placed
as the template is (what the JAX package's ``sharded_restore_template``
arranges). Every rank reads the file, so the directory must be
one that every rank sees. (The other design, each rank writing its own
shards, would tie a checkpoint to its mesh's shape.)
"""

from __future__ import annotations

import logging
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

from ..parallel.collectives import gather_nograd
from ..parallel.sharding import local_slice

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _kept_steps(root: Path) -> list[int]:
    """The complete saves under ``root``, ascending: integer-named
    directories only (a torn save's ``<step>.tmp-<pid>`` is skipped)."""
    return sorted(int(p.name) for p in root.iterdir()
                  if p.is_dir() and p.name.isdigit())


def _is_dtensor(t) -> bool:
    # duck-typed: importing torch.distributed.tensor is slow, and a process
    # without a mesh never needs it
    return hasattr(t, "placements") and hasattr(t, "to_local")


def _spec(dt) -> tuple:
    """A DTensor's placements as spec entries (parallel/sharding.py)."""
    names = dt.device_mesh.mesh_dim_names
    spec = [()] * dt.ndim
    for name, p in zip(names, dt.placements):
        if p.is_shard():
            spec[p.dim] = spec[p.dim] + (name,)
    return tuple(e or None for e in spec)


def _gather_full(dt) -> torch.Tensor:
    """The whole tensor of a DTensor, on every rank (a collective)."""
    mesh, out = dt.device_mesh, dt.to_local().detach()
    for name, p in reversed(list(zip(mesh.mesh_dim_names, dt.placements))):
        if p.is_shard():
            out = gather_nograd(out, p.dim, mesh.get_group(name))
    return out


def _writes() -> bool:
    """Rank 0 writes (and a process outside any group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _host_copy(node: Any, keep: bool = True) -> Any:
    """A copy of the tree in host memory that shares no storage with it:
    ``Tensor.cpu()`` of a CPU tensor returns the tensor itself, and a
    ``non_blocking`` copy from the card could be read before it lands.
    A DTensor is gathered whole first (every rank must call this); without
    ``keep`` (a rank that does not write) every tensor leaf comes back
    None and nothing is copied to the host."""
    if _is_dtensor(node):
        full = _gather_full(node)
        return full.to("cpu", copy=True) if keep else None
    if isinstance(node, torch.Tensor):
        return node.detach().to("cpu", copy=True) if keep else None
    if isinstance(node, dict):
        return {k: _host_copy(v, keep) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_host_copy(v, keep) for v in node)
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    raise TypeError(f"cannot checkpoint a {type(node).__name__}")


def _fit(template: Any, value: Any, path: str) -> Any:
    """``value`` in ``template``'s structure: each tensor on the template
    leaf's device and dtype. Raises, naming the leaf, on a missing or
    extra key or a shape mismatch."""
    where = path or "the root"
    if isinstance(template, dict):
        if not isinstance(value, dict) or set(value) != set(template):
            got = sorted(value) if isinstance(value, dict) else type(value)
            raise ValueError(f"checkpoint keys at {where}: {got}, expected "
                             f"{sorted(template)}")
        return {k: _fit(t, value[k], f"{path}{k}.") for k, t in
                template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(value, (list, tuple)) or len(value) != len(template):
            raise ValueError(f"checkpoint {where}: a sequence of "
                             f"{len(template)} expected")
        return type(template)(_fit(t, v, f"{path}{i}.")
                              for i, (t, v) in enumerate(zip(template, value)))
    name = path[:-1] or "the root"
    if _is_dtensor(template):
        if not isinstance(value, torch.Tensor) or value.shape != template.shape:
            raise ValueError(f"checkpoint leaf {name}: a tensor of shape "
                             f"{tuple(template.shape)} expected")
        local = template.to_local()
        block = local_slice(value, template.device_mesh, _spec(template))
        block = block.to(device=local.device, dtype=local.dtype, copy=True)
        return type(template).from_local(block, template.device_mesh,
                                  template.placements, run_check=False,
                                  shape=template.shape,
                                  stride=template.stride())
    if isinstance(template, torch.Tensor):
        if not isinstance(value, torch.Tensor):
            raise ValueError(f"checkpoint leaf {name}: a tensor expected, "
                             f"got {type(value).__name__}")
        if value.shape != template.shape:
            raise ValueError(f"checkpoint leaf {name}: shape "
                             f"{tuple(value.shape)}, expected "
                             f"{tuple(template.shape)}")
        return value.to(device=template.device, dtype=template.dtype)
    if isinstance(value, torch.Tensor):
        value = value.item()
    return value if template is None else type(template)(value)


class CheckpointManager:
    """Saves every ``save_interval`` steps, keeps the newest
    ``max_to_keep``, restores the latest (the JAX package's
    ``CheckpointManager`` surface; module docstring for the rules).

    ``save`` writes synchronously. ``save_async`` snapshots to host now and
    writes behind the caller; a third save arriving while one writes and
    one waits blocks until the writer takes the waiting one. ``wait``
    drains the writer; ``close`` drains and stops it. ``saves`` records
    each written step's host-snapshot seconds, write seconds and bytes."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval: int = 1):
        if max_to_keep < 1 or save_interval < 1:
            raise ValueError("max_to_keep and save_interval must be >= 1")
        self._dir = Path(directory).resolve()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval
        # the keep rule's view: steps on disk plus those accepted and still
        # queued for the writer (the orbax manager's checkpoint list)
        self._steps = _kept_steps(self._dir)
        self._q: queue.Queue | None = None
        self._writer: threading.Thread | None = None
        self._writer_err: Exception | None = None
        self.last_saved_step: int | None = self.latest_step()
        self.saves: list[dict] = []

    def _accept(self, step: int) -> bool:
        """The keep rule for a save of ``step``, recorded when it passes."""
        if self._steps and self._steps[-1] >= step:
            return False
        if self._steps and step % self.save_interval:
            return False
        self._steps = (self._steps + [step])[-self.max_to_keep:]
        return True

    def _write(self, step: int, host_state: Any, snapshot_s: float) -> None:
        t0 = time.perf_counter()
        # a save of this step killed mid-write leaves its tmp directory
        for torn in self._dir.glob(f"{step}.tmp-*"):
            shutil.rmtree(torn, ignore_errors=True)
        tmp = self._dir / f"{step}.tmp-{os.getpid()}"
        tmp.mkdir()
        torch.save(host_state, tmp / STATE_FILE)
        nbytes = (tmp / STATE_FILE).stat().st_size
        os.replace(tmp, self._dir / str(step))
        for old in _kept_steps(self._dir)[:-self.max_to_keep]:
            shutil.rmtree(self._dir / str(old), ignore_errors=True)
        self.last_saved_step = step
        self.saves.append({"step": step, "snapshot_s": snapshot_s,
                           "write_s": time.perf_counter() - t0,
                           "bytes": nbytes})

    def save(self, step: int, state: Any) -> bool:
        """Write ``state`` as ``step`` now, after any queued save; False
        when the keep rule drops it."""
        if self._q is not None:
            self._q.join()
        if not self._accept(step):
            return False
        t0 = time.perf_counter()
        host = _host_copy(state, _writes())
        if _writes():
            self._write(step, host, time.perf_counter() - t0)
        return True

    # ------------------------------------------------- overlapped save
    def _writer_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host_state, snapshot_s = item
            try:
                self._write(step, host_state, snapshot_s)
            except Exception as e:  # raised on the next save_async/wait
                log.exception("overlapped checkpoint save of step %d failed",
                              step)
                self._writer_err = e
            finally:
                self._q.task_done()

    def save_async(self, step: int, state: Any) -> bool:
        """Snapshot ``state`` to host now, write it behind the caller;
        False when the keep rule drops it (nothing is copied then). Raises
        the previous overlapped save's error, if any."""
        if self._writer_err is not None:
            err, self._writer_err = self._writer_err, None
            raise err
        if not self._accept(step):
            return False
        t0 = time.perf_counter()
        host = _host_copy(state, _writes())
        snapshot_s = time.perf_counter() - t0
        if not _writes():
            return True
        if self._q is None:
            self._q = queue.Queue(maxsize=1)
            self._writer = threading.Thread(
                target=self._writer_loop, name="ckpt-writer", daemon=True)
            self._writer.start()
        self._q.put((step, host, snapshot_s))
        return True

    def restore(self, step: int | None = None, template: Any = None) -> Any:
        """The saved tree of ``step`` (default: the latest), or None when
        there is none. With ``template``, in its structure, each tensor on
        the template leaf's device and dtype."""
        if self._q is not None:
            self._q.join()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        state = torch.load(self._dir / str(step) / STATE_FILE,
                           map_location="cpu", weights_only=True)
        return state if template is None else _fit(template, state, "")

    def latest_step(self) -> int | None:
        """The newest kept step (one still queued for the writer
        included)."""
        return self._steps[-1] if self._steps else None

    def wait(self) -> None:
        """Drain the overlapped-save queue, so a clean exit (a preemption
        drain included) never abandons a checkpoint mid-write."""
        if self._q is not None:
            self._q.join()
        if self._writer_err is not None:
            err, self._writer_err = self._writer_err, None
            raise err

    def close(self) -> None:
        if self._q is not None:
            self._q.join()
            self._q.put(None)
            if self._writer is not None:
                self._writer.join(timeout=30)
            self._q = None
            self._writer = None


def restore_lm_params(directory: str, template: dict) -> dict:
    """The ``params`` of an lm_train checkpoint's latest step, on the
    template's device and dtypes (lm_generate's and serve's
    ``--checkpoint-dir``). lm_train saves ``{"params", "opt_state"}``; the
    optimizer state is checked against the template's shapes and dropped.
    SystemExit when the directory holds no checkpoint."""
    from .step import make_optimizer

    mgr = CheckpointManager(directory)
    latest = mgr.latest_step()
    if latest is None:
        raise SystemExit(f"no checkpoint found in {directory}")
    restored = mgr.restore(template={
        "params": template, "opt_state": make_optimizer().init(template)})
    mgr.close()
    print(f"restored checkpoint step {latest}")
    return restored["params"]


__all__ = ["CheckpointManager", "STATE_FILE", "restore_lm_params"]
