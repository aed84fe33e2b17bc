"""Pipeline parallelism over the ``pipe`` mesh axis (port of the JAX
package's parallel/pipeline.py).

Three schedules, the JAX package's:

- GPipe (``make_pipeline``, ``make_pipeline_stacked``): microbatches flow
  stage to stage, one stage application a tick; S + M - 1 ticks, bubble
  (S-1)/(M+S-1).
- Circular (``make_pipeline_circular``, Megatron's interleaved schedule):
  a stage holds V non-adjacent layer chunks and an item loops the ring V
  times; stage 0 lets a wrapped item pass before a fresh microbatch, and
  with M a multiple of S the last item completes at tick V·M + S - 2.
- 1F1B (``make_pipeline_1f1b``, PipeDream-flush): forward and backward in
  one schedule; round r runs microbatch r - i forward and r - (2S-2-i)
  backward on stage i, each stage keeps at most 2S-1 stage INPUTS and
  recomputes the stage from its saved input in the backward.

The port runs one process a stage (or replays the stages in one process:
collectives.ReplayWorld). Every rank calls a schedule with its own block
of the stacked parameters (DTensors placed over ``pipe``, or their local
tensors) and the whole batch, which is replicated over ``pipe`` as the
JAX ``shard_map``'s ``in_specs=P()`` has it; mesh axes other than
``pipe`` replicate. The last stage's outputs reach every stage (a masked
sum over ``pipe``, the JAX psum), so every rank returns the whole result.

**Sends and receives.** The JAX ring's wrap edge S-1 → 0 carries garbage
that stage 0 ignores, and its idle ticks compute garbage. In PyTorch a
received tensor that feeds nothing never runs its backward, while its
sender waits for the matching receive, so the port leaves no P2P to
autograd: at every tick of the forward, and of the backward, every stage
posts the same exchange (collectives.Ring: its tensor to the next stage,
the previous stage's received; backward the reverse), a zero tensor
where it has nothing to send. An idle tick skips its compute (each rank
knows its window on the host), never its exchange.

**Backward.** GPipe and circular are differentiable: one
``torch.autograd.Function`` over the whole schedule, whose forward keeps
each application's graph (its input a leaf; O(M) residuals, as the JAX
autodiff keeps) and whose backward walks the ticks in reverse, each stage
backpropagating its applications and sending each input's gradient back
to the stage it came from. 1F1B returns its gradients itself.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .collectives import Ring, all_reduce_, group_rank, group_size
from .sharding import _tree_map

StageFn = Callable[[Any, torch.Tensor], Any]  # (stage_params, x) -> y


# --------------------------------------------------------------- trees

def _leaves(tree) -> list:
    """The tensors of a tree of dicts, in a fixed (sorted-key) order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unflatten(tree, leaves: list):
    """``tree``'s structure with ``leaves`` (``_leaves`` order) in it."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    return walk(tree)


def _local(t):
    """A DTensor's local block (differentiably); a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def stack_stage_params(per_stage_params: list) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    dim."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack(per_stage_params, dim=0)


def _pipe(mesh, axis_name: str):
    """(the ring over the pipe group, S, this stage's index)."""
    group = mesh.get_group(axis_name)
    return Ring(group), group_size(group), group_rank(group)


def _split_batch(batch: torch.Tensor, m: int) -> torch.Tensor:
    b = batch.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    return batch.reshape((m, b // m) + tuple(batch.shape[1:]))


# ------------------------------------------------------------ tick tables

def _gpipe_table(n_stages: int, m: int, me: int) -> list:
    """Stage ``me``'s ticks: (live, chunk, microbatch, injected, done)."""
    return [(0 <= t - me < m, 0, t - me, me == 0, me == n_stages - 1)
            for t in range(m + n_stages - 1)]


def _circular_table(n_stages: int, m: int, v: int, me: int) -> list:
    """Stage ``me``'s ticks of the circular schedule, simulated on the host
    exactly as the JAX program's carries evolve (every stage's inbox of
    (live, chunk, microbatch), a wrapped arrival before an injection),
    trimmed after the last live tick."""
    inbox = [(False, 0, 0)] * n_stages
    next_mb, rows = 0, []
    for _ in range(v * m + n_stages):
        row, outs = [], []
        for s in range(n_stages):
            live, chunk, mb = inbox[s]
            inject = s == 0 and not live and next_mb < m
            if inject:
                live, chunk, mb = True, 0, next_mb
                next_mb += 1
            done = live and s == n_stages - 1 and chunk == v - 1
            row.append((live, chunk, mb, inject, done))
            outs.append((live and not done,
                         chunk + (s == n_stages - 1), mb))
        inbox = [outs[(s - 1) % n_stages] for s in range(n_stages)]
        rows.append(row)
    last = max(t for t, row in enumerate(rows) if any(r[0] for r in row))
    return [row[me] for row in rows[:last + 1]]


class _Run:
    """One call of a table-driven schedule (GPipe or circular) on this
    stage: ``chunk_params(leaves, c)`` selects chunk c's parameters from
    the parameter leaves."""

    def __init__(self, stage_fn, tree, chunk_params, table, ring,
                 has_aux: bool):
        self.stage_fn, self.tree, self.chunk_params = stage_fn, tree, \
            chunk_params
        self.table, self.ring, self.has_aux = table, ring, has_aux

    def _apply(self, leaves, chunk, x):
        res = self.stage_fn(self.chunk_params(
            _unflatten(self.tree, leaves), chunk), x)
        return res if self.has_aux else (res, None)

    def forward(self, micro, leaves, keep_graph: bool):
        """-> (outputs [M, ...] on every stage, aux sum, the applications'
        graphs by tick when ``keep_graph``)."""
        outputs = torch.zeros_like(micro)
        aux_acc = torch.zeros((), dtype=torch.float32, device=micro.device)
        blank = torch.zeros_like(micro[0])
        saved, inbox = {}, blank
        for t, (live, chunk, mb, inject, done) in enumerate(self.table):
            send = blank
            if live:
                x = micro[mb] if inject else inbox
                if keep_graph:
                    x = x.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y, aux = self._apply(leaves, chunk, x)
                    saved[t] = (x, y, aux)
                else:
                    y, aux = self._apply(leaves, chunk, x)
                if aux is not None:
                    aux_acc = aux_acc + aux.detach().float()
                if done:
                    outputs[mb] = y.detach()
                else:
                    send = y.detach()
            if t < len(self.table) - 1:
                (inbox,) = self.ring.shift((send,))
        all_reduce_(outputs, self.ring.group)
        all_reduce_(aux_acc.reshape(1), self.ring.group)
        return outputs, aux_acc, saved

    def backward(self, saved, d_out, d_aux, micro_like):
        """The ticks in reverse -> d(micro) on every stage (None-free);
        the parameter leaves' ``grad`` accumulate."""
        d_micro = torch.zeros_like(micro_like)
        blank = torch.zeros_like(micro_like[0])
        g_inbox = blank
        for t in reversed(range(len(self.table))):
            live, chunk, mb, inject, done = self.table[t]
            send = blank
            if live:
                x, y, aux = saved.pop(t)
                outs, grads = [y], [d_out[mb] if done else g_inbox]
                if aux is not None and aux.requires_grad:
                    outs.append(aux)
                    grads.append(d_aux.to(aux.dtype).reshape(aux.shape))
                torch.autograd.backward(outs, grads)
                dx = x.grad if x.grad is not None else torch.zeros_like(x)
                if inject:
                    d_micro[mb] += dx
                else:
                    send = dx
            if t > 0:
                (g_inbox,) = self.ring.shift((send,), backward=True)
        all_reduce_(d_micro, self.ring.group)
        return d_micro


class _Schedule(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, micro, *leaves):
        grads_of = [p.detach().requires_grad_(p.requires_grad)
                    for p in leaves]
        out, aux, saved = run.forward(micro, grads_of, keep_graph=True)
        ctx.run, ctx.saved, ctx.grads_of = run, saved, grads_of
        ctx.micro_like = torch.empty_like(micro)
        return out, aux

    @staticmethod
    def backward(ctx, d_out, d_aux):
        d_micro = ctx.run.backward(ctx.saved, d_out, d_aux, ctx.micro_like)
        d_leaves = [p.grad if p.grad is not None else
                    (torch.zeros_like(p) if p.requires_grad else None)
                    for p in ctx.grads_of]
        ctx.saved = ctx.grads_of = None
        return (None, d_micro if ctx.needs_input_grad[1] else None,
                *d_leaves)


def _run_schedule(run: _Run, micro, leaves):
    """(outputs, aux): differentiable when grad mode is on and an input
    takes a gradient; a plain forward otherwise."""
    if torch.is_grad_enabled() and (micro.requires_grad or any(
            p.requires_grad for p in leaves)):
        return _Schedule.apply(run, micro, *leaves)
    with torch.no_grad():
        out, aux, _ = run.forward(micro, leaves, keep_graph=False)
    return out, aux


def _stacked_apply(mesh, stage_fn, m, axis_name, has_aux, squeeze):
    def apply(stacked_params, batch):
        micro = _split_batch(batch, m)
        ring, n, me = _pipe(mesh, axis_name)
        tree = _tree_map(_local, stacked_params)
        leaves = _leaves(tree)

        def chunk_params(params, _chunk):
            return _tree_map(lambda p: p[0], params) if squeeze else params

        run = _Run(stage_fn, tree, chunk_params, _gpipe_table(n, m, me),
                   ring, has_aux)
        out, aux = _run_schedule(run, micro, leaves)
        out = out.reshape(batch.shape[:1] + out.shape[2:])
        return (out, aux) if has_aux else out

    return apply


def make_pipeline(mesh, stage_fn: StageFn, num_microbatches: int,
                  axis_name: str = "pipe") -> Callable:
    """Returns pipeline_apply(stacked_params, batch) -> batch.

    stacked_params: this stage's block of a tree with leading dim n_stages
    on every leaf (leading dim 1; a DTensor sharded over ``axis_name`` is
    read through its local block). batch: [B, ...], the same on every
    stage; B must divide into num_microbatches. Differentiable."""
    return _stacked_apply(mesh, stage_fn, num_microbatches, axis_name,
                          has_aux=False, squeeze=True)


def make_pipeline_stacked(mesh, stage_fn: StageFn, num_microbatches: int,
                          axis_name: str = "pipe",
                          has_aux: bool = False) -> Callable:
    """Pipeline over params whose leading dim is a LAYER stack (n_layers,
    divisible by the pipe-axis size): each stage passes its contiguous run
    of layers ([n_layers / S, ...], layers [s·n/S, (s+1)·n/S)) and
    ``stage_fn(local_stack, x)`` applies them. How the flagship
    transformer pipelines.

    With has_aux, stage_fn returns (y, aux_scalar) per application and
    apply returns (batch_out, aux_sum), the sum over every (stage,
    microbatch) application."""
    return _stacked_apply(mesh, stage_fn, num_microbatches, axis_name,
                          has_aux=has_aux, squeeze=False)


def make_pipeline_circular(mesh, stage_fn: StageFn, num_microbatches: int,
                           num_chunks: int, axis_name: str = "pipe",
                           has_aux: bool = False,
                           expect_chunked: bool = False) -> Callable:
    """Circular/interleaved pipeline: the layer stack [n_layers, ...] is
    laid out [V, S, per_chunk, ...] so stage s holds the V non-adjacent
    chunks {s, S+s, 2S+s, ...} (chunk v on stage s: layers (v·S + s)·
    per_chunk onward); ``stage_fn(chunk_stack, x)`` applies one chunk.
    Bubble wall time shrinks ~V x against GPipe at the cost of V x more
    ring hops. Differentiable.

    apply(stacked_params, batch) -> batch_out (or (batch_out, aux_sum)
    with has_aux). stacked_params: the whole [n_layers, ...] stack (n_layers
    divisible by S·V; each stage takes its chunks), or with
    ``expect_chunked`` this stage's block [V, 1, per_chunk, ...] of the
    [V, S, per_chunk, ...] layout (how a train step keeps its parameters
    in the schedule's layout)."""
    v, m = num_chunks, num_microbatches

    def apply(stacked_params, batch):
        micro = _split_batch(batch, m)
        ring, n, me = _pipe(mesh, axis_name)
        if m % n:
            raise ValueError(
                f"circular schedule needs num_microbatches ({m}) divisible "
                f"by pipeline stages ({n})")
        tree = _tree_map(_local, stacked_params)
        if expect_chunked:
            tree = _tree_map(lambda p: p[:, 0], tree)
        else:
            n_layers = _leaves(tree)[0].shape[0]
            if n_layers % (n * v):
                raise ValueError(f"n_layers {n_layers} not divisible by "
                                 f"stages*chunks {n * v}")
            per = n_layers // (n * v)
            tree = _tree_map(lambda p: p.reshape(
                (v, n, per) + tuple(p.shape[1:]))[:, me], tree)
        leaves = _leaves(tree)

        def chunk_params(params, chunk):
            return _tree_map(lambda p: p[chunk], params)

        run = _Run(stage_fn, tree, chunk_params,
                   _circular_table(n, m, v, me), ring, has_aux)
        out, aux = _run_schedule(run, micro, leaves)
        out = out.reshape(batch.shape[:1] + out.shape[2:])
        return (out, aux) if has_aux else out

    return apply


# ------------------------------------------------------------------- 1F1B

def make_pipeline_1f1b(mesh, stage_fn, head_fn, num_microbatches: int,
                       aux_weight: float = 0.0, axis_name: str = "pipe",
                       loss_denom_fn=None) -> Callable:
    """1F1B pipelined loss + gradients (forward AND backward inside one
    schedule, module docstring): an O(stages) residual ring and
    activation recomputation instead of GPipe's O(M) live set.

    stage_fn(local_stack, x) -> (y, aux_scalar)
    head_fn(head_params, y_mb, target_mb) -> per-microbatch loss
    contribution (run on the last stage only)

    loss_denom_fn(targets) -> scalar D: the head contributions are summed
    and divided by D. Default D = num_microbatches (right when head_fn
    returns per-microbatch MEANS). Pass e.g. the global valid-token count
    (with head_fn returning token SUMS) to weight every token equally
    however padding distributes across microbatches.

    apply(stacked_params, head_params, batch, targets) ->
        (loss, dstacked, dhead, dx[batch])
    with stacked_params this stage's [n_layers / S, ...] block, head_params
    and the batch the same on every stage; loss = sum_mb(head) / D +
    aux_weight * aux_sum / M, and the gradients are exactly d loss /
    d (params, inputs), scaled through the cotangents (the head's 1/D, the
    aux's aux_weight/M), not by division afterwards. dstacked is this
    stage's block; loss, dhead and dx are the same on every stage."""
    m = num_microbatches

    def apply(stacked_params, head_params, batch, targets):
        micro, micro_t = _split_batch(batch, m), _split_batch(targets, m)
        ring, n, me = _pipe(mesh, axis_name)
        dev = batch.device
        denom = (torch.tensor(float(m), device=dev) if loss_denom_fn is None
                 else loss_denom_fn(targets).float())
        head_cot = 1.0 / denom
        aux_cot = torch.tensor(aux_weight / m, dtype=torch.float32,
                               device=dev)
        s_tree = _tree_map(_local, stacked_params)
        h_tree = _tree_map(_local, head_params)
        s_leaves = [p.detach().requires_grad_(True) for p in _leaves(s_tree)]
        h_leaves = [p.detach().requires_grad_(True) for p in _leaves(h_tree)]
        params = _unflatten(s_tree, s_leaves)
        hparams = _unflatten(h_tree, h_leaves)
        slots = 2 * n - 1                   # residual ring (max in flight)
        resid: list = [None] * slots
        blank = torch.zeros_like(micro[0])
        fwd_inbox = bwd_inbox = blank
        dx_out = torch.zeros_like(micro)
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        aux_acc = torch.zeros((), dtype=torch.float32, device=dev)
        rounds = m + 2 * (n - 1)
        for r in range(rounds):
            # ---------------- forward half ----------------
            mf = r - me
            y_send, dy_own = blank, None
            if 0 <= mf < m:
                x_in = micro[mf] if me == 0 else fwd_inbox
                with torch.no_grad():
                    y, aux = stage_fn(params, x_in)
                aux_acc = aux_acc + aux.float()
                resid[mf % slots] = x_in
                y_send = y
                if me == n - 1:
                    # the head: loss and dy of this microbatch, whose
                    # backward starts this same round
                    y_leaf = y.detach().requires_grad_(True)
                    with torch.enable_grad():
                        loss_mb = head_fn(hparams, y_leaf, micro_t[mf])
                    torch.autograd.backward(
                        loss_mb, head_cot.to(loss_mb.dtype).reshape(
                            loss_mb.shape))
                    loss_acc = loss_acc + loss_mb.detach().float()
                    dy_own = y_leaf.grad
            # ---------------- backward half ----------------
            mb = r - (2 * n - 2 - me)
            dx_send = blank
            if 0 <= mb < m:
                dy_in = dy_own if me == n - 1 else bwd_inbox
                xs = resid[mb % slots].detach().requires_grad_(True)
                resid[mb % slots] = None
                with torch.enable_grad():
                    y2, aux2 = stage_fn(params, xs)
                outs, grads = [y2], [dy_in]
                if aux2.requires_grad:
                    outs.append(aux2)
                    grads.append(aux_cot.to(aux2.dtype).reshape(aux2.shape))
                torch.autograd.backward(outs, grads)
                dx = xs.grad if xs.grad is not None else torch.zeros_like(xs)
                if me == 0:
                    dx_out[mb] = dx
                dx_send = dx
            # ---------------- ring exchanges ----------------
            if r < rounds - 1:
                (fwd_inbox,) = ring.shift((y_send,))
                (bwd_inbox,) = ring.shift((dx_send,), backward=True)
        # losses and head grads live on the last stage, dx on the first:
        # summed over pipe, every stage returns them
        sums = torch.stack([loss_acc, aux_acc])
        all_reduce_(sums, ring.group)
        dhead = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in h_leaves]
        for g in dhead:
            all_reduce_(g, ring.group)
        all_reduce_(dx_out, ring.group)
        dstacked = [p.grad if p.grad is not None else torch.zeros_like(p)
                    for p in s_leaves]
        loss = sums[0] * head_cot + aux_weight * sums[1] / m
        return (loss, _unflatten(s_tree, dstacked),
                _unflatten(h_tree, dhead),
                dx_out.reshape(batch.shape))

    return apply


__all__ = ["make_pipeline", "make_pipeline_stacked", "make_pipeline_circular",
           "make_pipeline_1f1b", "stack_stage_params"]
