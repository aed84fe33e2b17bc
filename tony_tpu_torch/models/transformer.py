"""Flagship decoder-only transformer, forward pass and training loss (port
of the JAX package's models/transformer.py).

Plain functions on a parameter dict with the JAX package's layouts
(``wq [L, d, h, k]``, ``wo [L, h, k, d]``, ...) and the same einsum
contractions, so parameters convert with a dtype and device move
(models/convert.py). The JAX ``lax.scan`` over layers is a Python loop.

Attention dispatch (``cfg.attn_impl``): "auto" runs the flash kernel
(ops/attention.py, CUDA) on a CUDA tensor and the plain attention on a CPU
tensor; "flash" asks for the flash path (the kernel on CUDA, its plain
version on the CPU); "ref" is the plain attention everywhere. The
sequence-parallel impls come with the mesh slice.

The loss (``token_nll``, ``loss_fn``) dispatches on ``cfg.ce_impl``:
blockwise cross-entropy (ops/cross_entropy.py) streams the vocabulary so the
[B, L, V] logits never exist; dense materialises them. There is no mesh in
this slice, so "auto" means blockwise at vocab >= 16384. ``remat`` and MoE
are not ported yet and raise; their config fields are kept so a config maps
one to one.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..parallel.ring_attention import reference_attention


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
    # MoE: n_experts=0 => dense SwiGLU MLP (MoE is not ported yet)
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # "auto", "flash", "ref"; "ring"/"ulysses" come with the mesh slice
    attn_impl: str = "auto"
    sp_kernel: str = "auto"
    # sliding-window attention: each position sees its last attn_window
    # positions inclusive; 0 = full causal
    attn_window: int = 0
    norm_eps: float = 1e-6
    # causal=False: bidirectional encoder (no KV-cache generation)
    causal: bool = True
    # training fields: remat is not ported yet (loss_fn raises)
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
         device) -> dict:
    """Random parameters with the JAX package's shapes and scales (the
    draws differ: torch and jax generators give different numbers from one
    seed; parity tests convert the JAX tree instead, models/convert.py).
    Layer params are stacked [n_layers, ...]."""
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE is not ported yet (ROADMAP queue 1, "
                                  "MoE item)")
    pd, hd, L = cfg.param_dtype, cfg.head_dim, cfg.n_layers

    def dense(shape, in_size):
        return _dense_init(generator, shape, in_size, pd, device)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    return {
        "embed": dense((cfg.vocab_size, cfg.d_model), cfg.d_model),
        "layers": {
            "attn_norm": ones((L, cfg.d_model)),
            "wq": dense((L, cfg.d_model, cfg.n_heads, hd), cfg.d_model),
            "wk": dense((L, cfg.d_model, cfg.n_kv_heads, hd), cfg.d_model),
            "wv": dense((L, cfg.d_model, cfg.n_kv_heads, hd), cfg.d_model),
            "wo": dense((L, cfg.n_heads, hd, cfg.d_model), cfg.n_heads * hd),
            "mlp_norm": ones((L, cfg.d_model)),
            "w_gate": dense((L, cfg.d_model, cfg.d_ff), cfg.d_model),
            "w_up": dense((L, cfg.d_model, cfg.d_ff), cfg.d_model),
            "w_down": dense((L, cfg.d_ff, cfg.d_model), cfg.d_ff),
        },
        "final_norm": ones((cfg.d_model,)),
        "unembed": dense((cfg.d_model, cfg.vocab_size), cfg.d_model),
    }


def num_params(params) -> int:
    n = 0
    for v in params.values():
        n += num_params(v) if isinstance(v, dict) else v.numel()
    return n


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


def _attention(q, k, v, cfg: TransformerConfig):
    """[B, L, H, D] in/out; dispatch on cfg.attn_impl (module docstring)."""
    impl = cfg.attn_impl
    if cfg.attn_window < 0:
        raise ValueError(
            f"attn_window must be >= 0 (0 = full causal), got {cfg.attn_window}"
        )
    window = cfg.attn_window or None
    if window is not None and not cfg.causal:
        raise ValueError("attn_window requires causal=True")
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={impl!r} is not ported yet: sequence parallelism "
            "comes with the mesh slice (ROADMAP queue 1, mesh/TP item)")
    if impl == "auto":
        impl = "flash" if q.is_cuda else "ref"
    if impl == "flash":
        from ..ops.attention import attention_blhd

        return attention_blhd(q, k, v, causal=cfg.causal, window=window)
    if impl != "ref":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return reference_attention(q, k, v, causal=cfg.causal, window=window)


def _qkv(cfg: TransformerConfig, h, positions, lp):
    """Projections + rope; k/v stay at n_kv_heads."""
    dt = cfg.dtype
    q = torch.einsum("bld,dhk->blhk", h, lp["wq"].to(dt))
    k = torch.einsum("bld,dhk->blhk", h, lp["wk"].to(dt))
    v = torch.einsum("bld,dhk->blhk", h, lp["wv"].to(dt))
    q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    return q, k, v


def _repeat_kv(cfg: TransformerConfig, k, v):
    if cfg.n_kv_heads != cfg.n_heads:
        rep = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def _mlp(cfg: TransformerConfig, h, lp):
    """Dense SwiGLU MLP -> (out, aux_loss 0)."""
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE is not ported yet (ROADMAP queue 1, "
                                  "MoE item)")
    dt = cfg.dtype
    gate = F.silu(torch.einsum("bld,df->blf", h, lp["w_gate"].to(dt)))
    up = torch.einsum("bld,df->blf", h, lp["w_up"].to(dt))
    out = torch.einsum("blf,fd->bld", gate * up, lp["w_down"].to(dt))
    return out, torch.zeros((), dtype=torch.float32, device=h.device)


def _layer(cfg: TransformerConfig, x, positions, lp):
    """One decoder block; lp = this layer's params (stack dim removed)."""
    dt = cfg.dtype
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, h, positions, lp)
    k, v = _repeat_kv(cfg, k, v)
    attn = _attention(q, k, v, cfg)
    x = x + torch.einsum("blhk,hkd->bld", attn, lp["wo"].to(dt))
    mlp_out, aux = _mlp(cfg, rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp)
    return x + mlp_out, aux


def layer_params(params: dict, i: int) -> dict:
    """Layer i's params (the stack dim indexed away; views, no copies)."""
    return {name: w[i] for name, w in params["layers"].items()}


def apply_hidden(params: dict, tokens: torch.Tensor, cfg: TransformerConfig):
    """Forward up to and including the final norm -> (hidden [B, L, D],
    aux_loss scalar)."""
    dt = cfg.dtype
    b, l = tokens.shape
    positions = torch.arange(l, device=tokens.device).expand(b, l)
    x = params["embed"].to(dt)[tokens]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(cfg.n_layers):
        x, a = _layer(cfg, x, positions, layer_params(params, i))
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux * cfg.aux_loss_weight


def apply(params: dict, tokens: torch.Tensor, cfg: TransformerConfig):
    """Forward pass -> (logits [B, L, V] f32, aux_loss scalar)."""
    x, aux = apply_hidden(params, tokens, cfg)
    logits = torch.einsum("bld,dv->blv", x, params["unembed"].to(cfg.dtype))
    return logits.float(), aux


def _use_blockwise_ce(cfg: TransformerConfig) -> bool:
    """ce_impl dispatch. With no mesh there is no vocab-sharded unembed to
    keep sharded, so "auto" is blockwise at large vocab."""
    if cfg.ce_impl not in ("auto", "dense", "blockwise"):
        raise ValueError(f"ce_impl must be 'auto', 'dense', or 'blockwise', "
                         f"got {cfg.ce_impl!r}")
    if cfg.ce_impl == "auto":
        return cfg.vocab_size >= 16384
    return cfg.ce_impl == "blockwise"


def token_nll(x, unembed, targets, cfg: TransformerConfig,
              reduction: str = "mean"):
    """Masked next-token NLL from final hidden states.

    x: [B, L, D] hidden (after the final norm), unembed: [D, V], targets:
    [B, L] int with -1 = pad (masked out here). reduction "mean" -> the
    mean over valid tokens; "sum" -> the sum (the caller divides by its own
    count). Scalar float32."""
    from ..ops.cross_entropy import blockwise_cross_entropy, dense_cross_entropy

    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction must be 'mean' or 'sum', got "
                         f"{reduction!r}")
    valid = targets >= 0
    safe_targets = torch.where(valid, targets, 0).reshape(-1)
    x2 = x.reshape(-1, x.shape[-1])
    w = unembed.to(cfg.dtype)
    if _use_blockwise_ce(cfg):
        nll = blockwise_cross_entropy(x2, w, safe_targets, cfg.ce_block_v)
    else:
        nll = dense_cross_entropy(x2, w, safe_targets)
    nll = nll.reshape(targets.shape) * valid
    if reduction == "sum":
        return nll.sum()
    return nll.sum() / valid.sum().clamp_min(1)


def loss_fn(params, tokens, targets, cfg: TransformerConfig):
    """Next-token cross-entropy (+ MoE aux, 0 for the dense model); targets
    [B, L] with -1 = pad. With blockwise CE the [B, L, V] logits never
    exist, forward or backward."""
    if cfg.remat:
        raise NotImplementedError(
            "remat is not ported yet (ROADMAP queue 1, remat item)")
    x, aux = apply_hidden(params, tokens, cfg)
    return token_nll(x, params["unembed"], targets, cfg) + aux


__all__ = ["TransformerConfig", "init", "apply", "apply_hidden", "rms_norm",
           "rope", "num_params", "layer_params", "token_nll", "loss_fn"]
