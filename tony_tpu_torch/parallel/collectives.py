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


class ReplayGroup:
    """``t`` ranks of a group as threads of one process, one running at a
    time: a rank runs until a collective, leaves its part and hands the
    turn to the next rank; the last to arrive combines the parts (a sum in
    float32, or a concatenation) and hands the turn back to the first, and
    each rank takes the result when its turn comes again. ``run`` starts
    the ranks. A rank that raises stops the others."""

    def __init__(self, t: int):
        self.t = t
        self._cond = threading.Condition()
        self._turn = 0
        self._parts: list = [None] * t
        self._result = None
        self._error: BaseException | None = None
        self._local = threading.local()

    @property
    def rank(self) -> int:
        return self._local.rank

    def _wait_turn(self, rank: int) -> None:
        if not self._cond.wait_for(
                lambda: self._turn == rank or self._error is not None,
                timeout=REPLAY_TURN_TIMEOUT_S):
            raise TimeoutError(f"replay rank {rank} waited "
                               f"{REPLAY_TURN_TIMEOUT_S} s for its turn")
        if self._error is not None:
            raise RuntimeError("another replay rank failed") from self._error

    def _pass(self, rank: int) -> None:
        self._turn = (rank + 1) % self.t
        self._cond.notify_all()

    def _collect(self, x: torch.Tensor, combine):
        rank = self.rank
        with self._cond:
            self._parts[rank] = x
            if rank == self.t - 1:
                self._result = combine(self._parts)
                self._parts = [None] * self.t
            self._pass(rank)
            self._wait_turn(rank)
            return self._result

    def all_reduce_(self, t: torch.Tensor, op) -> torch.Tensor:
        if op not in (dist.ReduceOp.SUM, None):
            raise NotImplementedError(f"replayed all-reduce of {op}")
        total = self._collect(t, lambda ps: torch.stack(
            [p.float() for p in ps]).sum(0))
        return t.copy_(total)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated along dimension 0."""
        return self._collect(x, lambda ps: torch.cat(ps, 0))

    def run(self, fn) -> list:
        """``fn(rank)`` on every rank, in turns -> the results by rank."""
        out: list = [None] * self.t

        def body(rank):
            self._local.rank = rank
            with self._cond:
                try:
                    self._wait_turn(rank)
                except BaseException:
                    return
            try:
                out[rank] = fn(rank)
            except BaseException as e:
                with self._cond:
                    self._error = self._error or e
                    self._cond.notify_all()
                return
            with self._cond:
                self._pass(rank)

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.t)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if self._error is not None:
            raise self._error
        return out


def group_size(group) -> int:
    if group is None:
        return 1
    if isinstance(group, ReplayGroup):
        return group.t
    return dist.get_world_size(group)


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
        if not ctx.reduce_grad:
            rank = dist.get_rank(ctx.group)
            return g.chunk(n, dim)[rank].contiguous(), None, None, None
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
        self.rank = dist.get_rank(group) if group is not None else 0
        if self.n > 1:
            self.next = dist.get_global_rank(group, (self.rank + 1) % self.n)
            self.prev = dist.get_global_rank(group, (self.rank - 1) % self.n)

    def start_shift(self, tensors, backward: bool = False):
        """Start the exchange -> a callable that waits and returns the
        received tensors. ``backward`` sends to the previous rank instead."""
        if self.n == 1:
            return lambda: tuple(tensors)
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


__all__ = ["ReplayGroup", "group_size", "all_reduce_", "copy_to", "reduce_from",
           "gather_dim", "gather_nograd", "all_to_all", "Ring", "ring_shift"]
