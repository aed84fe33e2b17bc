"""Differentiable collectives for the port's SPMD code (the JAX package leaves
these to XLA: GSPMD inserts them from the shardings, ``lax.ppermute`` and
``lax.all_to_all`` differentiate by themselves). Each takes a process group
(a mesh axis's, ``mesh.get_group(axis)``) and is the identity on a group of
one, so a one-card mesh moves no byte.

The tensor-parallel pair is Megatron's: ``copy_to`` (identity forward,
all-reduce of the gradient) goes before a product whose weight is split on
its output features, ``reduce_from`` (all-reduce forward, identity
backward) after a product whose weight is split on its input features.

A ``ReplayGroup`` stands in for a process group when a group's ranks are
replayed in one process (parallel/tp_replay.py): the same collectives
then meet in memory instead of on a transport.
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist


# a replayed rank waits at most this long for its turn (a rank stuck in
# a kernel or a deadlocked replay fails instead of hanging)
REPLAY_TURN_TIMEOUT_S = 600.0


class ReplayWorld:
    """``n`` ranks as threads of one process, one running at a time. A rank
    runs until a collective of one of its groups (``group(ranks)``), leaves
    its part there and hands the turn on; the last of the group's ranks to
    arrive combines the parts, and each rank takes the result when its turn
    comes again. A rank whose collective is still open passes its turn, so
    ranks in different groups interleave as their programs allow; if every
    unfinished rank waits on an open collective, the replay raises (a
    deadlock). ``run`` starts the ranks, each running its backward passes
    on its own thread (``set_multithreading_enabled(False)``), so a
    collective inside a backward takes its turn like any other. A rank
    that raises stops the others."""

    def __init__(self, n: int):
        self.n = n
        self._cond = threading.Condition()
        self._turn = 0
        self._open: dict = {}
        self._waiting: set = set()
        self._finished: set = set()
        self._groups: dict = {}
        self._error: BaseException | None = None
        self._local = threading.local()

    @property
    def rank(self) -> int:
        return self._local.rank

    def group(self, ranks) -> "ReplayGroup":
        """The group of these world ranks (one object per set of ranks, so
        its collectives are numbered alike on each of them)."""
        ranks = tuple(ranks)
        if ranks not in self._groups:
            self._groups[ranks] = ReplayGroup(self, ranks)
        return self._groups[ranks]

    def _wait_turn(self, rank: int) -> None:
        if not self._cond.wait_for(
                lambda: self._turn == rank or self._error is not None,
                timeout=REPLAY_TURN_TIMEOUT_S):
            raise TimeoutError(f"replay rank {rank} waited "
                               f"{REPLAY_TURN_TIMEOUT_S} s for its turn")
        if self._error is not None:
            raise RuntimeError("another replay rank failed") from self._error

    def _pass(self, rank: int) -> None:
        nxt = rank
        for _ in range(self.n):
            nxt = (nxt + 1) % self.n
            if nxt not in self._finished:
                break
        self._turn = nxt
        self._cond.notify_all()

    def _collect(self, group: "ReplayGroup", x, combine):
        rank = self.rank
        with self._cond:
            key = (group.ranks, group._seq[rank])
            group._seq[rank] += 1
            slot = self._open.setdefault(key, {"parts": {}, "taken": 0})
            slot["parts"][rank] = x
            if len(slot["parts"]) == group.t:
                slot["result"] = combine([slot["parts"][r]
                                          for r in group.ranks])
                self._waiting -= set(group.ranks)
            while "result" not in slot:
                self._waiting.add(rank)
                if self._waiting >= set(range(self.n)) - self._finished:
                    raise RuntimeError(
                        f"replay deadlock: ranks {sorted(self._waiting)} "
                        "all wait on open collectives")
                self._pass(rank)
                self._wait_turn(rank)
            slot["taken"] += 1
            if slot["taken"] == group.t:
                del self._open[key]
            return slot["result"]

    def run(self, fn) -> list:
        """``fn(rank)`` on every rank, in turns -> the results by rank. A
        world runs again after a run has ended (its groups keep counting
        their collectives alike on every rank)."""
        self._turn, self._error = 0, None
        self._finished, self._waiting = set(), set()
        out: list = [None] * self.n

        def body(rank):
            self._local.rank = rank
            with self._cond:
                try:
                    self._wait_turn(rank)
                except BaseException:
                    return
            try:
                # a rank's backward runs on its own thread (on CUDA the
                # engine's device thread would run every rank's, and a
                # collective inside one would stall the others)
                with torch.autograd.set_multithreading_enabled(False):
                    out[rank] = fn(rank)
            except BaseException as e:
                with self._cond:
                    self._error = self._error or e
                    self._cond.notify_all()
                return
            with self._cond:
                self._finished.add(rank)
                self._pass(rank)

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if self._error is not None:
            raise self._error
        return out


class ReplayGroup:
    """A process group of replayed ranks (``ReplayWorld.group``), or with
    an int ``t``, a world of ``t`` ranks and the group of all of them. Its
    collectives: an all-reduce (a sum in float32, or a maximum), an
    all-gather (a concatenation) and a ring shift; each rank's part is
    combined in memory."""

    def __init__(self, world, ranks=None):
        if isinstance(world, int):
            world, ranks = ReplayWorld(world), range(world)
            world._groups[tuple(ranks)] = self
        self.world, self.ranks = world, tuple(ranks)
        self.t = len(self.ranks)
        self._seq = dict.fromkeys(self.ranks, 0)

    @property
    def rank(self) -> int:
        """The calling thread's rank within the group."""
        return self.ranks.index(self.world.rank)

    def all_reduce_(self, t: torch.Tensor, op) -> torch.Tensor:
        """A sum (in float32) or a maximum, in place."""
        if op in (dist.ReduceOp.SUM, None):
            total = self.world._collect(self, t, lambda ps: torch.stack(
                [p.float() for p in ps]).sum(0))
        elif op == dist.ReduceOp.MAX:
            total = self.world._collect(self, t, lambda ps: torch.stack(
                list(ps)).amax(0))
        else:
            raise NotImplementedError(f"replayed all-reduce of {op}")
        return t.copy_(total)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated along dimension 0."""
        return self.world._collect(self, x, lambda ps: torch.cat(ps, 0))

    def shift(self, tensors, backward: bool = False) -> tuple:
        """``Ring.shift`` in memory: the previous rank's tensors (the next
        rank's with ``backward``), copied."""
        parts = self.world._collect(self, tuple(tensors), list)
        src = (self.rank + (1 if backward else -1)) % self.t
        return tuple(x.clone() for x in parts[src])

    def run(self, fn) -> list:
        """``fn(rank)`` on every rank of the world (whose group this is)."""
        return self.world.run(fn)


def group_size(group) -> int:
    if group is None:
        return 1
    if isinstance(group, ReplayGroup):
        return group.t
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group`` (0 without one)."""
    if group is None:
        return 0
    if isinstance(group, ReplayGroup):
        return group.rank
    return dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce, no autograd; a no-op on a group of one."""
    if isinstance(group, ReplayGroup):
        return group.all_reduce_(t, op)
    if group_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group``."""
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward; the gradient passes unchanged."""
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def _gather(x, dim, group):
    n = group_size(group)
    x = x.contiguous()
    if isinstance(group, ReplayGroup):
        parts = group.all_gather(x)
    else:
        parts = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                            dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(parts, x, group=group)
    if dim == 0:
        return parts
    return torch.cat(parts.chunk(n, 0), dim=dim)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce_grad):
        ctx.dim, ctx.group, ctx.reduce_grad = dim, group, reduce_grad
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n, dim = group_size(ctx.group), ctx.dim
        rank = group_rank(ctx.group)
        if not ctx.reduce_grad:
            return g.chunk(n, dim)[rank].contiguous(), None, None, None
        if isinstance(ctx.group, ReplayGroup):
            total = all_reduce_(g.contiguous().clone(), ctx.group)
            return total.chunk(n, dim)[rank].contiguous(), None, None, None
        parts = torch.cat(g.chunk(n, dim), 0).contiguous()
        out = torch.empty_like(parts.chunk(n, 0)[0])
        dist.reduce_scatter_tensor(out, parts, group=ctx.group)
        return out, None, None, None


def gather_dim(x: torch.Tensor, dim: int, group, reduce_grad: bool):
    """Concatenate the group's blocks along ``dim`` (rank order). The
    gradient of a block is the sum over the group of its slice
    (``reduce_grad``: the ranks saw different data, FSDP's reduce-scatter)
    or this rank's slice alone (the ranks computed the same thing)."""
    if group_size(group) == 1:
        return x
    return _GatherDim.apply(x, dim, group, reduce_grad)


def gather_nograd(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks concatenated along ``dim``, without autograd."""
    return x if group_size(group) == 1 else _gather(x, dim, group)


def _a2a(x, split_dim, concat_dim, group):
    n = group_size(group)
    parts = torch.stack(x.chunk(n, split_dim), 0).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _a2a(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _a2a(g, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group):
    """``lax.all_to_all(tiled=True)``: split ``x`` into the group's size of
    chunks along ``split_dim``, send chunk j to rank j, and concatenate the
    received chunks along ``concat_dim`` in rank order. Differentiable (its
    gradient is the reverse all-to-all)."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)


class Ring:
    """A ring over ``group``'s ranks: ``shift`` sends tensors to the next
    rank and receives the previous rank's (``lax.ppermute`` with
    ``i -> i + 1``), by one batched P2P exchange."""

    def __init__(self, group):
        self.group = group
        self.n = group_size(group)
        self.rank = group_rank(group)
        self.replay = isinstance(group, ReplayGroup)
        if self.n > 1 and not self.replay:
            self.next = dist.get_global_rank(group, (self.rank + 1) % self.n)
            self.prev = dist.get_global_rank(group, (self.rank - 1) % self.n)

    def start_shift(self, tensors, backward: bool = False):
        """Start the exchange -> a callable that waits and returns the
        received tensors. ``backward`` sends to the previous rank instead."""
        if self.n == 1:
            return lambda: tuple(tensors)
        if self.replay:
            return lambda: self.group.shift(tensors, backward)
        dst, src = (self.prev, self.next) if backward else (self.next,
                                                           self.prev)
        send = [t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in send]
        ops = [dist.P2POp(dist.isend, t, dst, self.group) for t in send]
        ops += [dist.P2POp(dist.irecv, t, src, self.group) for t in recv]
        reqs = dist.batch_isend_irecv(ops)

        def wait():
            for r in reqs:
                r.wait()
            return tuple(recv)

        return wait

    def shift(self, tensors, backward: bool = False):
        return self.start_shift(tensors, backward)()


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, *xs):
        ctx.ring = ring
        return ring.shift(xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + ctx.ring.shift(gs, backward=True)


def ring_shift(ring: Ring, *xs):
    """Differentiable ``shift``: the gradient goes back to the sender."""
    if ring.n == 1:
        return xs
    return _Shift.apply(ring, *xs)


__all__ = ["ReplayWorld", "ReplayGroup", "group_size", "group_rank", "all_reduce_", "copy_to", "reduce_from",
           "gather_dim", "gather_nograd", "all_to_all", "Ring", "ring_shift"]
