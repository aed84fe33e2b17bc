"""Deterministic, resumable batch loading for LM training (a copy of the
JAX package's data/loader.py ``ShardedBatchLoader`` and ``PrefetchLoader``,
which are numpy code).

1. **Determinism as a function of (seed, step).** Batch ``i`` is fully
   determined by the seed and the global step, so a resume replays the same
   stream, and the same seed gives byte-identical batches to the JAX
   package's loader.
2. **Per-process sharding.** Process p takes rows ``p::process_count`` of
   each global batch, and with ``seq_shard_count`` > 1 only its slice of
   the sequence. ``loader_shard_info`` and ``seq_shard_info`` read both
   from the mesh.
3. **Host-side prefetch.** A background thread assembles the next batch
   while the device runs the current step. ``close()`` joins the thread.

The port runs one process a card, so a process's place on the mesh is its
rank's coordinate: its batch shard is its coordinate over the batch axes
(the JAX package's ``(process_index, process_count)`` whenever those axes
span every process, as on a data or fsdp mesh) and its sequence shard its
coordinate on the ``act_seq`` axis. Ranks that differ only along the
tensor axis load the same rows.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..parallel.mesh import mesh_shape
from ..parallel.sharding import DP_RULES as _DP_RULES, mesh_shards_rule
from .dataset import TokenDataset


class ShardedBatchLoader:
    """Deterministic (seed, step) -> local batch of (inputs, targets).

    global_batch is the TOTAL batch across all processes; this loader
    yields the local_batch = global_batch / process_count rows belonging to
    ``process_index``.
    """

    def __init__(
        self,
        dataset: TokenDataset,
        global_batch: int,
        seq_len: int,
        *,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        start_step: int = 0,
        seq_shard_index: int = 0,
        seq_shard_count: int = 1,
    ):
        if global_batch % process_count != 0:
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"process_count {process_count}"
            )
        if seed < 0:
            raise ValueError(f"seed must be non-negative, got {seed}")
        if seq_len % seq_shard_count != 0:
            raise ValueError(
                f"seq_len {seq_len} not divisible by seq_shard_count "
                f"{seq_shard_count}"
            )
        if not 0 <= seq_shard_index < seq_shard_count:
            raise ValueError(
                f"seq_shard_index {seq_shard_index} out of range "
                f"[0, {seq_shard_count})"
            )
        self.dataset = dataset
        self.global_batch = global_batch
        self.local_batch = global_batch // process_count
        self.seq_len = seq_len
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.step = start_step
        # sequence sharding (ring/Ulysses SP data plane): this loader reads
        # only its L/seq_shard_count-token slice of every window — at long
        # context a host never materializes (or reads) the full sequence
        self.seq_shard_index = seq_shard_index
        self.seq_shard_count = seq_shard_count
        self.local_seq = seq_len // seq_shard_count

        self._num_windows = dataset.num_windows(seq_len)
        if self._num_windows < global_batch:
            raise ValueError(
                f"dataset has {self._num_windows} windows of seq_len "
                f"{seq_len}, need at least global_batch={global_batch}"
            )
        self.steps_per_epoch = self._num_windows // global_batch
        self._perm_epoch = -1
        self._perm: np.ndarray | None = None

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if epoch != self._perm_epoch:
            rng = np.random.default_rng(np.uint64(self.seed) ^ np.uint64(epoch * 0x9E3779B9 + 1))
            self._perm = rng.permutation(self._num_windows)
            self._perm_epoch = epoch
        return self._perm

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """The local (inputs, targets) for global step `step`, each
        [local_batch, seq_len / seq_shard_count] int32.

        With sequence sharding, shard s of window w reads tokens
        [w*L + s*L/c, w*L + (s+1)*L/c] (one extra token for the shifted
        targets), which is exactly columns [s*L/c, (s+1)*L/c) of the full
        window's inputs AND targets — concatenating the shards along the
        sequence dim reproduces the unsharded batch bit-for-bit."""
        epoch = step // self.steps_per_epoch
        i = step % self.steps_per_epoch
        perm = self._epoch_perm(epoch)
        global_rows = perm[i * self.global_batch:(i + 1) * self.global_batch]
        local_rows = global_rows[self.process_index::self.process_count]
        off = self.seq_shard_index * self.local_seq
        xs = np.stack([
            self.dataset.window(int(w) * self.seq_len + off, self.local_seq + 1)
            for w in local_rows
        ])
        return xs[:, :-1].copy(), xs[:, 1:].copy()

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch

    # ------------------------------------------------------------- resume
    def state(self) -> dict:
        """Checkpointable state — pair with restore() for exact resume."""
        return {
            "step": self.step, "seed": self.seed,
            "global_batch": self.global_batch, "seq_len": self.seq_len,
            "process_index": self.process_index,
            "process_count": self.process_count,
            "seq_shard_index": self.seq_shard_index,
            "seq_shard_count": self.seq_shard_count,
        }

    def restore(self, state: dict) -> None:
        # every field that addresses the stream must match, or the resumed
        # run silently trains on a different window sequence
        for field in ("seed", "global_batch", "seq_len",
                      "process_index", "process_count",
                      "seq_shard_index", "seq_shard_count"):
            mine = getattr(self, field)
            theirs = int(state.get(field, mine))
            if theirs != mine:
                raise ValueError(
                    f"restoring loader state with {field}={theirs} into a "
                    f"loader with {field}={mine} would silently change the "
                    "data stream"
                )
        self.step = int(state["step"])


class PrefetchLoader:
    """Wrap any batch iterator with a background producer thread so batch
    assembly overlaps device compute. Yields exactly the wrapped iterator's
    stream; `close()` (or exhaustion) stops the thread.

    Checkpointing note: the producer runs AHEAD of the consumer (queue depth
    + one in flight), so the wrapped loader's own ``state()`` would record a
    step the trainer hasn't seen. Use THIS object's ``state()`` — it counts
    consumed batches against the state captured at wrap time, so a restore
    replays exactly the first unconsumed batch."""

    _DONE = object()

    def __init__(self, it, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._finished = False
        self._consumed = 0
        self._base_state = it.state() if hasattr(it, "state") else None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that aborts when close() is requested — a plain
        put() could deadlock the thread forever on a full queue (close()
        drains once, but a small depth can refill before the final _DONE)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set() or not self._put(item):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            if self._err is not None:
                raise self._err
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._finished = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        self._consumed += 1
        return item

    def state(self) -> dict:
        """Consumption-corrected checkpoint state of the wrapped loader."""
        if self._base_state is None:
            raise TypeError(
                f"wrapped iterator {type(self._it).__name__} has no state()"
            )
        out = dict(self._base_state)
        out["step"] = int(out["step"]) + self._consumed
        return out

    def close(self):
        self._stop.set()
        self._finished = True
        # unblock a producer waiting on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


# the "batch" row of the rule tables is the one source of which mesh axes
# consume the batch (parallel/sharding.py DP_RULES); callers with their own
# table pass rules= so the loader and the train step cannot diverge
BATCH_AXES = tuple(_DP_RULES["batch"])


def sharded_batch_axes(mesh, batch_axes=BATCH_AXES, rules=None) -> tuple:
    """The subset of the batch axes the mesh actually shards (>1 devices)."""
    return mesh_shards_rule(mesh, rules, "batch", default=batch_axes)


def _coord(mesh, process_index: int) -> dict:
    """{axis: coordinate} of a rank on the mesh."""
    where = (mesh.mesh == process_index).nonzero()
    if where.shape[0] != 1:
        raise ValueError(f"rank {process_index} is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, where[0].tolist()))


def loader_shard_info(mesh, process_index: int, process_count: int,
                      batch_axes=BATCH_AXES, rules=None) -> tuple[int, int]:
    """(process_index, process_count) a ShardedBatchLoader should use on this
    mesh: the rank's shard of the batch axes the mesh shards (its coordinate
    over them, major to minor, and their size), or (0, 1) when it shards
    none (seq/tensor-only meshes: every process loads the same full batch;
    the loader's (seed, step) determinism makes that coordination-free)."""
    axes = sharded_batch_axes(mesh, batch_axes, rules)
    if not axes:
        return 0, 1
    if mesh.mesh.numel() != process_count:
        raise ValueError(f"a mesh of {mesh.mesh.numel()} ranks for "
                         f"{process_count} processes")
    shape, coord = mesh_shape(mesh), _coord(mesh, process_index)
    index, count = 0, 1
    for a in axes:
        index, count = index * shape[a] + coord[a], count * shape[a]
    return index, count


def seq_shard_info(mesh, process_index: int, rules=None) -> tuple[int, int]:
    """(seq_shard_index, seq_shard_count) a ShardedBatchLoader should use on
    this mesh, the data-plane half of ring/Ulysses sequence parallelism:
    the rank's coordinate on the ``act_seq`` axis (default ``seq``) and its
    size, or (0, 1) when the mesh does not shard the sequence."""
    seq_axes = mesh_shards_rule(mesh, rules, "act_seq", default=("seq",))
    if not seq_axes:
        return 0, 1
    axis = seq_axes[0]
    return _coord(mesh, process_index)[axis], mesh_shape(mesh)[axis]


def device_put_sharded_batch(batch, mesh, device=None):
    """This process's [local_batch, seq] numpy arrays (what the loader gave
    it under ``loader_shard_info``/``seq_shard_info``) as int64 tensors on
    its card (the mesh's device type; ``device`` overrides), the block the
    sharded train step takes."""
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh is not None and mesh.device_type == "cuda"
                  else torch.device("cpu"))
    return tuple(torch.from_numpy(x).to(device, torch.int64) for x in batch)


__all__ = ["ShardedBatchLoader", "PrefetchLoader", "BATCH_AXES",
           "sharded_batch_axes", "loader_shard_info", "seq_shard_info",
           "device_put_sharded_batch"]
