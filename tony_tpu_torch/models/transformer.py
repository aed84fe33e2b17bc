"""Flagship decoder-only transformer, forward pass and training loss (port
of the JAX package's models/transformer.py).

Plain functions on a parameter dict with the JAX package's layouts
(``wq [L, d, h, k]``, ``wo [L, h, k, d]``, ...) and the same einsum
contractions, so parameters convert with a dtype and device move
(models/convert.py). The JAX ``lax.scan`` over layers is a Python loop.

Attention dispatch (``cfg.attn_impl``): "auto" runs the flash kernel
(ops/attention.py, CUDA) on a CUDA tensor and the plain attention on a CPU
tensor; "flash" asks for the flash path (the kernel on CUDA, its plain
version on the CPU); "ref" is the plain attention everywhere; "ring" and
"ulysses" are sequence parallelism over the mesh's ``seq`` axis
(parallel/ring_attention.py, parallel/ulysses.py; ``cfg.sp_kernel`` picks
their per-block attention).

The loss (``token_nll``, ``loss_fn``) dispatches on ``cfg.ce_impl``:
blockwise cross-entropy (ops/cross_entropy.py) streams the vocabulary so the
[B, L, V] logits never exist; dense materialises them. "auto" is blockwise
at vocab >= 16384 unless the rules shard the vocab over the mesh (then the
vocab-parallel dense CE keeps the logits sharded).

With a ``mesh`` (and its ``rules``), ``apply_hidden``, ``token_nll`` and
``loss_fn`` are SPMD: every rank of the mesh calls them with its own blocks
of the parameters (DTensors, or their local tensors, placed by
parallel/sharding.py) and of the tokens ([B/batch ranks, L/seq ranks]),
and ``loss_fn`` returns the loss of the whole batch on every rank
(parallel/spmd.py says where the collectives go). Tensor parallelism is
Megatron's: the heads, the MLP's hidden units and the vocabulary split
over the ``tensor`` axis; K/V stay whole (training's rules keep "kv"
replicated) and each rank attends with its heads' slice. Decode's table
(``TP_DECODE_RULES``) splits the kv heads as well: each rank then
computes its own K/V heads (models/generate.py).

``n_experts > 0`` replaces every layer's SwiGLU MLP by the einsum-dispatch
Mixture-of-Experts FFN (parallel/expert.py, silu experts) and adds its
load-balancing loss times ``aux_loss_weight`` to the loss. On a mesh the
experts split over the ``expert`` axis (EP_RULES) and their hidden units
over the ``mlp`` rule's axis, and the routing and the load-balancing loss
are the global batch's, as the JAX package's GSPMD program computes them.

``remat=True`` runs each layer under ``torch.utils.checkpoint``
(non-reentrant), with the JAX package's policies (``remat_policy``):
"full" saves nothing inside a layer; "dots" saves the matrix products'
outputs (the flash forward is not one, so it runs again in the backward);
"attn" saves only the flash forward's out and lse (selective checkpointing
sees it as the ``tony_tpu_torch::flash_fwd`` operator), so the backward
never runs the kernel twice.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ..parallel.collectives import copy_to, gather_nograd, reduce_from
from ..parallel.ring_attention import make_ring_attention, reference_attention
from ..parallel.ulysses import make_ulysses_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8           # < n_heads => GQA
    d_ff: int = 2048
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    # ("llama3", factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings) or None
    rope_scaling: tuple | None = None
    dtype: torch.dtype = torch.bfloat16     # activation dtype
    param_dtype: torch.dtype = torch.float32
    # MoE: n_experts=0 => dense SwiGLU MLP everywhere
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # "auto", "flash", "ref", or "ring" / "ulysses" (sequence-parallel over
    # the mesh's `seq` axis)
    attn_impl: str = "auto"
    # the ring's per-step kernel: "auto" (flash on CUDA inside the kernels'
    # envelope, else einsum blocks), "flash" or "xla"; Ulysses' local
    # attention: "auto" (flash on CUDA, plain on the CPU), "flash", "xla"
    sp_kernel: str = "auto"
    # sliding-window attention: each position sees its last attn_window
    # positions inclusive; 0 = full causal
    attn_window: int = 0
    norm_eps: float = 1e-6
    # causal=False: bidirectional encoder (no KV-cache generation)
    causal: bool = True
    # training fields: remat = checkpoint each layer under remat_policy
    # ("full", "dots" or "attn"; see the module docstring)
    remat: bool = False
    remat_policy: str = "full"
    ce_impl: str = "auto"
    ce_block_v: int = 2048

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ------------------------------------------------------------------ building

def _dense_init(generator, shape, in_axis_size, dtype, device):
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32) * in_axis_size ** -0.5
    return x.to(device=device, dtype=dtype)


def init(cfg: TransformerConfig, generator: torch.Generator,
         device, place=None) -> dict:
    """Random parameters with the JAX package's shapes and scales (the
    draws differ: torch and jax generators give different numbers from one
    seed; parity tests convert the JAX tree instead, models/convert.py).
    Layer params are stacked [n_layers, ...]. ``place(leaf, logical_axes)``
    maps each leaf as soon as it is drawn (``sharding.block_placer``: a
    rank keeps its block, so at most one whole leaf is ever on the card,
    never the whole tree); the draws are the same with or without it."""
    pd, hd, L = cfg.param_dtype, cfg.head_dim, cfg.n_layers
    ax = param_logical_axes(cfg)
    lx = ax["layers"]
    put = place or (lambda t, axes: t)

    def dense(axes, shape, in_size):
        return put(_dense_init(generator, shape, in_size, pd, device), axes)

    def ones(axes, shape):
        return put(torch.ones(shape, dtype=pd, device=device), axes)

    layers = {
        "attn_norm": ones(lx["attn_norm"], (L, cfg.d_model)),
        "wq": dense(lx["wq"], (L, cfg.d_model, cfg.n_heads, hd), cfg.d_model),
        "wk": dense(lx["wk"], (L, cfg.d_model, cfg.n_kv_heads, hd),
                    cfg.d_model),
        "wv": dense(lx["wv"], (L, cfg.d_model, cfg.n_kv_heads, hd),
                    cfg.d_model),
        "wo": dense(lx["wo"], (L, cfg.n_heads, hd, cfg.d_model),
                    cfg.n_heads * hd),
        "mlp_norm": ones(lx["mlp_norm"], (L, cfg.d_model)),
    }
    e, f = cfg.n_experts, cfg.d_ff
    if e > 0:
        layers.update(
            router=dense(lx["router"], (L, cfg.d_model, e), cfg.d_model),
            w_in=dense(lx["w_in"], (L, e, cfg.d_model, f), cfg.d_model),
            w_out=dense(lx["w_out"], (L, e, f, cfg.d_model), f))
    else:
        layers.update(
            w_gate=dense(lx["w_gate"], (L, cfg.d_model, f), cfg.d_model),
            w_up=dense(lx["w_up"], (L, cfg.d_model, f), cfg.d_model),
            w_down=dense(lx["w_down"], (L, f, cfg.d_model), f))
    return {
        "embed": dense(ax["embed"], (cfg.vocab_size, cfg.d_model),
                       cfg.d_model),
        "layers": layers,
        "final_norm": ones(ax["final_norm"], (cfg.d_model,)),
        "unembed": dense(ax["unembed"], (cfg.d_model, cfg.vocab_size),
                         cfg.d_model),
    }


def param_logical_axes(cfg: TransformerConfig) -> dict:
    """Mirror of init()'s tree with logical-axis tuples for the rule tables
    (parallel/sharding.py)."""
    layers: dict = {
        "attn_norm": ("layers", None),
        "wq": ("layers", "embed", "heads", None),
        "wk": ("layers", "embed", "kv", None),
        "wv": ("layers", "embed", "kv", None),
        "wo": ("layers", "heads", None, "embed"),
        "mlp_norm": ("layers", None),
    }
    if cfg.n_experts > 0:
        layers.update({
            "router": ("layers", "embed", None),
            "w_in": ("layers", "expert", "embed", "mlp"),
            "w_out": ("layers", "expert", "mlp", "embed"),
        })
    else:
        layers.update({
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        })
    return {
        "embed": ("vocab", "embed"),
        "layers": layers,
        "final_norm": (None,),
        "unembed": ("embed", "vocab"),
    }


def num_params(params) -> int:
    n = 0
    for v in params.values():
        n += num_params(v) if isinstance(v, dict) else v.numel()
    return n


def _local(t):
    """A DTensor's local block; a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


# ------------------------------------------------------------------- pieces

def rms_norm(x, weight, eps=1e-6):
    """RMSNorm in float32, cast back to x's dtype BEFORE the weight
    multiply (the JAX package's rounding order)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def _rope_freqs(d, theta, scaling, device):
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=device) / half)
    if scaling is not None:
        kind, factor, low_f, high_f, orig_max = scaling
        if kind != "llama3":
            raise ValueError(f"unsupported rope scaling kind {kind!r}")
        wavelen = 2.0 * math.pi / freqs
        low_wl = orig_max / low_f          # longest unscaled wavelength
        high_wl = orig_max / high_f
        smooth = ((orig_max / wavelen - low_f) / (high_f - low_f)).clamp(0.0, 1.0)
        interp = (1.0 - smooth) * freqs / factor + smooth * freqs
        freqs = torch.where(
            wavelen < high_wl, freqs,
            torch.where(wavelen > low_wl, freqs / factor, interp))
    return freqs


def rope(x, positions, theta, scaling=None):
    """Rotary position embedding; x: [B, L, H, D], positions [B, L].
    ``scaling`` = ("llama3", factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings) applies Llama-3.x context extension."""
    d = x.shape[-1]
    half = d // 2
    freqs = _rope_freqs(d, theta, scaling, x.device)
    angles = positions[..., None].float() * freqs           # [B, L, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attention(q, k, v, cfg: TransformerConfig, plan=None):
    """[B, L, H, D] in/out; dispatch on cfg.attn_impl (module docstring)."""
    impl = cfg.attn_impl
    if cfg.attn_window < 0:
        raise ValueError(
            f"attn_window must be >= 0 (0 = full causal), got {cfg.attn_window}"
        )
    window = cfg.attn_window or None
    if window is not None and not cfg.causal:
        raise ValueError("attn_window requires causal=True")
    if window is not None and impl in ("ring", "ulysses"):
        raise ValueError(
            f"attn_window is not supported with attn_impl={impl!r} "
            "(sequence-parallel paths are full-causal)")
    if impl == "ring":
        if plan is None:
            raise ValueError("attn_impl='ring' requires a mesh")
        return make_ring_attention(
            plan.mesh, plan.seq_axis or "seq", causal=cfg.causal,
            impl=None if cfg.sp_kernel == "auto" else cfg.sp_kernel,
        )(q, k, v)
    if impl == "ulysses":
        if plan is None:
            raise ValueError("attn_impl='ulysses' requires a mesh")
        attn_fn = None
        if cfg.sp_kernel == "flash":
            from ..ops.attention import attention_blhd

            attn_fn = functools.partial(attention_blhd, causal=cfg.causal)
        elif cfg.sp_kernel == "xla":
            attn_fn = functools.partial(reference_attention,
                                        causal=cfg.causal)
        elif cfg.sp_kernel != "auto":
            raise ValueError(f"sp_kernel must be 'auto', 'flash', or 'xla', "
                             f"got {cfg.sp_kernel!r}")
        return make_ulysses_attention(plan.mesh, plan.seq_axis or "seq",
                                      causal=cfg.causal,
                                      attn_fn=attn_fn)(q, k, v)
    if impl == "auto":
        impl = "flash" if q.is_cuda else "ref"
    if impl == "flash":
        from ..ops.attention import attention_blhd

        return attention_blhd(q, k, v, causal=cfg.causal, window=window)
    if impl != "ref":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return reference_attention(q, k, v, causal=cfg.causal, window=window)


def _qkv(cfg: TransformerConfig, h, positions, lp, plan=None):
    """Projections + rope; k/v stay at n_kv_heads. With the heads
    tensor-parallel, q is this rank's heads; k/v are this rank's kv heads
    when the rules shard "kv" too (decode's table), else whole (training's:
    their gradient summed over the tensor axis, since each rank uses its
    own heads' slice of them)."""
    dt = cfg.dtype
    group = plan.tp_group("heads") if plan is not None else None
    kv_local = plan is not None and plan.tp["kv"] is not None
    hq = copy_to(h, group)
    q = torch.einsum("bld,dhk->blhk", hq, lp["wq"].to(dt))
    k = torch.einsum("bld,dhk->blhk", hq if kv_local else h, lp["wk"].to(dt))
    v = torch.einsum("bld,dhk->blhk", hq if kv_local else h, lp["wv"].to(dt))
    q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    if kv_local:
        return q, k, v
    return q, copy_to(k, group), copy_to(v, group)


def _repeat_kv(cfg: TransformerConfig, k, v):
    if cfg.n_kv_heads != cfg.n_heads:
        rep = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def _rank_kv(cfg: TransformerConfig, k, v, n_q_heads: int, plan=None):
    """K/V repeated to the query heads this rank attends with: every head
    without a plan or with the kv heads split as the query heads are; this
    rank's slice of the repeated whole when the heads are split and the kv
    heads are not."""
    k, v = _repeat_kv(cfg, k, v)
    if k.shape[2] != n_q_heads:
        lo = plan.tp_rank("heads") * n_q_heads
        k, v = k[:, :, lo:lo + n_q_heads], v[:, :, lo:lo + n_q_heads]
    return k, v


def _mlp(cfg: TransformerConfig, h, lp, plan=None):
    """Post-attention MLP (dense SwiGLU, or MoE) -> (out, aux_loss).

    MoE, as the JAX package's: the experts route on the router at cfg.dtype
    (``moe_ffn`` upcasts that to float32), while the aux loss reads the
    float32 router; at bf16 these are different numbers. With a plan, the
    rank's experts and tokens (parallel/expert.py)."""
    dt = cfg.dtype
    if cfg.n_experts > 0:
        from ..parallel.expert import load_balancing_loss, moe_ffn

        b, l, d = h.shape
        flat = h.reshape(b * l, d)
        router_logits = flat.float() @ lp["router"].float()
        out = moe_ffn(flat, lp["router"].to(dt), lp["w_in"].to(dt),
                      lp["w_out"].to(dt), k=cfg.expert_top_k,
                      capacity_factor=cfg.capacity_factor, activation=F.silu,
                      plan=plan, shape=(b, l))
        aux = load_balancing_loss(router_logits, cfg.expert_top_k, plan)
        return out.reshape(b, l, d), aux
    group = plan.tp_group("mlp") if plan is not None else None
    hm = copy_to(h, group)
    gate = F.silu(torch.einsum("bld,df->blf", hm, lp["w_gate"].to(dt)))
    up = torch.einsum("bld,df->blf", hm, lp["w_up"].to(dt))
    out = torch.einsum("blf,fd->bld", gate * up, lp["w_down"].to(dt))
    return (reduce_from(out, group),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _layer(cfg: TransformerConfig, x, positions, lp, plan=None):
    """One decoder block; lp = this layer's params (stack dim removed; on a
    mesh, as ``Plan.use`` gives them)."""
    dt = cfg.dtype
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, h, positions, lp, plan)
    k, v = _rank_kv(cfg, k, v, q.shape[2], plan)
    group = plan.tp_group("heads") if plan is not None else None
    attn = _attention(q, k, v, cfg, plan)
    x = x + reduce_from(torch.einsum("blhk,hkd->bld", attn, lp["wo"].to(dt)),
                        group)
    mlp_out, aux = _mlp(cfg, rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp,
                        plan)
    return x + mlp_out, aux


# the matrix products remat_policy="dots" saves (an einsum reaches the
# dispatcher as one of these)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _remat(layer_fn, policy: str):
    """layer_fn under torch.utils.checkpoint with the JAX package's policy
    of that name (its transformer.py:335-350)."""
    if policy == "full":
        context_fn = None
    elif policy in ("dots", "attn"):
        if policy == "dots":
            saved = _DOTS
        else:
            from ..ops import attention  # noqa: F401 (defines the operator)

            saved = (torch.ops.tony_tpu_torch.flash_fwd.default,)

        def choose(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       choose)
    else:
        raise ValueError(f"remat_policy must be 'full', 'dots', or 'attn', "
                         f"got {policy!r}")
    extra = {} if context_fn is None else {"context_fn": context_fn}

    def run(*args):
        return checkpoint(layer_fn, *args, use_reentrant=False, **extra)

    return run


def layer_params(params: dict, i: int, plan=None, cfg=None) -> dict:
    """Layer i's params (the stack dim indexed away; views, no copies). With
    a plan (and the config), each as the model computes with it."""
    if plan is None:
        return {name: w[i] for name, w in params["layers"].items()}
    axes = param_logical_axes(cfg)["layers"]
    return {name: plan.use(_local(w)[i], axes[name][1:])
            for name, w in params["layers"].items()}


def _plan(mesh, rules, cfg: TransformerConfig):
    """The SPMD plan of (mesh, rules) for this model, or None."""
    from ..parallel.spmd import plan_for

    return plan_for(mesh, rules)


def _embed(params, tokens, cfg: TransformerConfig, plan):
    """The token embeddings; vocab-parallel when the rules shard the vocab
    (each rank looks up the ids in its rows, the sum over the tensor axis
    fills the rest)."""
    dt = cfg.dtype
    if plan is None:
        return params["embed"].to(dt)[tokens]
    emb = plan.use(_local(params["embed"]), ("vocab", "embed")).to(dt)
    if not plan.tp["vocab"]:
        return emb[tokens]
    rows = emb.shape[0]
    local = tokens - plan.tp_rank("vocab") * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], emb[local.clamp(0, rows - 1)], 0)
    return reduce_from(x, plan.tp_group("vocab"))


def apply_hidden(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                 mesh=None, rules=None):
    """Forward up to and including the final norm -> (hidden [B, L, D],
    aux_loss scalar). With a mesh: this rank's blocks (module docstring)."""
    plan = _plan(mesh, rules, cfg)
    tokens = _local(tokens)
    b, l = tokens.shape
    # a sequence-parallel rank holds positions [r * l, (r + 1) * l)
    offset = plan.seq_rank * l if plan is not None else 0
    positions = (offset + torch.arange(l, device=tokens.device)).expand(b, l)
    x = _embed(params, tokens, cfg, plan)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    layer_fn = functools.partial(_layer, cfg, plan=plan)
    if cfg.remat:
        layer_fn = _remat(layer_fn, cfg.remat_policy)
    for i in range(cfg.n_layers):
        x, a = layer_fn(x, positions, layer_params(params, i, plan, cfg))
        aux = aux + a
    x = rms_norm(x, _local(params["final_norm"]), cfg.norm_eps)
    return x, aux * cfg.aux_loss_weight


def apply(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
          mesh=None, rules=None):
    """Forward pass -> (logits [B, L, V] f32, aux_loss scalar); with a mesh,
    this rank's rows and positions over the whole vocabulary."""
    plan = _plan(mesh, rules, cfg)
    x, aux = apply_hidden(params, tokens, cfg, mesh, rules)
    w = _local(params["unembed"])
    if plan is not None:
        w = plan.use(w, ("embed", "vocab"))
    logits = torch.einsum("bld,dv->blv", x, w.to(cfg.dtype)).float()
    if plan is not None:
        logits = gather_nograd(logits, 2, plan.tp_group("vocab"))
    return logits, aux


def _use_blockwise_ce(cfg: TransformerConfig, mesh=None, rules=None) -> bool:
    """ce_impl dispatch: "auto" is blockwise at large vocab, except when the
    rules shard the vocab over the mesh (the dense vocab-parallel CE keeps
    the logits sharded there); the rules' "vocab" row decides, default
    "tensor"."""
    from ..parallel.sharding import mesh_shards_rule

    if cfg.ce_impl not in ("auto", "dense", "blockwise"):
        raise ValueError(f"ce_impl must be 'auto', 'dense', or 'blockwise', "
                         f"got {cfg.ce_impl!r}")
    if cfg.ce_impl != "auto":
        return cfg.ce_impl == "blockwise"
    if mesh_shards_rule(mesh, rules, "vocab", default=("tensor",)):
        return False
    return cfg.vocab_size >= 16384


def token_nll(x, unembed, targets, cfg: TransformerConfig, mesh=None,
              rules=None, reduction: str = "mean"):
    """Masked next-token NLL from final hidden states.

    x: [B, L, D] hidden (after the final norm), unembed: [D, V], targets:
    [B, L] int with -1 = pad (masked out here). reduction "mean" -> the
    mean over valid tokens; "sum" -> the sum (the caller divides by its own
    count). Scalar float32. With a mesh: this rank's blocks in, the whole
    batch's mean or sum out (its gradient this rank's share)."""
    from ..ops.cross_entropy import (
        blockwise_cross_entropy, dense_cross_entropy,
        vocab_parallel_cross_entropy,
    )

    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction must be 'mean' or 'sum', got "
                         f"{reduction!r}")
    plan = _plan(mesh, rules, cfg)
    targets = _local(targets)
    valid = targets >= 0
    safe_targets = torch.where(valid, targets, 0).reshape(-1)
    x2 = x.reshape(-1, x.shape[-1])
    w = _local(unembed)
    if plan is not None:
        w = plan.use(w, ("embed", "vocab"))
    w = w.to(cfg.dtype)
    if plan is not None and plan.tp["vocab"]:
        nll = vocab_parallel_cross_entropy(
            x2, w, safe_targets, plan.tp_rank("vocab") * w.shape[1],
            plan.tp_group("vocab"))
    elif _use_blockwise_ce(cfg, mesh, rules):
        nll = blockwise_cross_entropy(x2, w, safe_targets, cfg.ce_block_v)
    else:
        nll = dense_cross_entropy(x2, w, safe_targets)
    total = (nll.reshape(targets.shape) * valid).sum()
    count = valid.sum()
    if plan is not None:
        total, count = plan.global_sum(total), plan.global_count(count)
    if reduction == "sum":
        return total
    return total / count.clamp_min(1)


def loss_fn(params, tokens, targets, cfg: TransformerConfig, mesh=None,
            rules=None):
    """Next-token cross-entropy (+ the MoE aux loss, 0 for a dense model);
    targets [B, L] with -1 = pad. With blockwise CE the [B, L, V] logits
    never exist, forward or backward. With a mesh: SPMD (module
    docstring)."""
    x, aux = apply_hidden(params, tokens, cfg, mesh, rules)
    return token_nll(x, params["unembed"], targets, cfg, mesh, rules) + aux


__all__ = ["TransformerConfig", "init", "apply", "apply_hidden", "rms_norm",
           "rope", "num_params", "param_logical_axes", "layer_params",
           "token_nll", "loss_fn"]
