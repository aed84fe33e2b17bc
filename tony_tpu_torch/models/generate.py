"""Autoregressive generation with a KV cache (port of
the JAX package's models/generate.py, single device).

- **Static cache.** The cache is allocated once at ``prompt_len +
  max_new_tokens`` (or a pinned ``max_len``) in the head-major
  ``[layers, B, kvH, max_len, D]`` layout. Each forward writes its new K/V
  **in place** by slice assignment at ``cache.length`` and returns a new
  ``KVCache`` over the same buffers with the length advanced (the JAX
  package donates the buffers instead; the effect is the same: the cache
  passed in is consumed).
- **Prefill** (empty cache) runs causal attention over the prompt through
  the model's own attention dispatch: the flash forward kernel on CUDA.
- **Decode** runs ``_cached_attention``: on CUDA every lockstep
  single-token step (one scalar length, no ring offsets) goes to the
  split-KV flash-decode kernel (ops/decode_attention.py); the JAX
  package's M >= 4096 threshold was measured on another chip and is not
  applied. Other shapes (a multi-token chunk into a non-empty cache, the
  serving slot pool's per-row lengths and ring offsets, attn_impl="ref",
  the CPU) take the einsum formulation: scores against the whole buffer
  with an index mask, as the JAX package does.
- **Per-row lengths** (the serving slot pool, models/serving.py):
  ``cache.length`` may be an ``[S]`` int32 tensor. Each row's buffer is
  then a ring whose index m holds logical position ``(m - offset) mod M``,
  with the offsets chosen so every row's next write lands at one shared
  ``cursor`` index (``_forward_with_cache(ring=(cursor, offsets))``).
- **GQA-aware cache** at n_kv_heads; query heads are folded to
  ``[kvH, rep]`` against the un-repeated cache.
- ``kv_dtype="int8"`` stores per-token-per-head symmetric int8 with bf16
  scales; the scales fold out of the attention operands.
- Dense models run fused q/k/v and gate/up projections (concatenations of
  the training weights, so values match the unfused path).
- ``weight_dtype="int8"`` (w8a16) quantizes the fused qkv, gate/up, wo,
  w_down and the unembed per output channel; each product is
  ``(x @ W_int8) * s``, the scale folded out of it. The int8 matrix is
  converted to the activation dtype for ``torch.matmul`` (exact: every
  int8 value is a bf16 value), so it halves the resident bytes of those
  matrices, not the bytes a step streams.
- **MoE** (``n_experts > 0``): every forward routes drop-free
  (``moe_dropfree``: capacity >= tokens, so each token's output depends on
  it alone and the cached path equals the full forward). The decode
  pre-cast keeps the router float32, as the JAX package's does. Native
  weights fuse only qkv (the experts stay in the params); int8 quantizes
  qkv, wo, the unembed and every expert's ``w_in``/``w_out`` per expert
  and output channel, the scales applied after each expert product
  (parallel/expert.py ``moe_ffn``).

Sampling: greedy (temperature=0), temperature and top-k, scalar or one
per row, drawn from an explicit ``torch.Generator`` by the exponential
trick (``argmax(p / q)``, ``q ~ Exp(1)``: what ``torch.multinomial`` does
for one sample, without its host-side validity check, which would wait
for the card). ``stop_tokens`` gives EOS semantics with an early exit once
every row has stopped.

**Tensor-parallel decode** (``mesh=``, ``rules=``; the JAX package's
generate.py:653-744 and :994-1040): ``prepare_decode`` places every
parameter by ``transformer.param_logical_axes`` x the rule table
(``TP_DECODE_RULES`` by default: heads, kv heads, the MLP's hidden units
and the vocabulary over ``tensor``) as DTensors, skips the qkv and
gate/up fusion under a sharded tensor axis and refuses int8 weights
there. One process a card: each rank runs the loop on its blocks
(parallel/spmd.py ``Plan``). The KV cache on a rank is ``[L, B / t_batch,
kvH / t_kv, M, D]``; q and K/V are its heads, ``wo`` and ``w_down`` give
partial sums reduced over ``tensor``, the embedding is vocab-parallel and
the logits are gathered over the vocabulary before sampling. A rank's
attention tensors are ordinary local tensors, so the prefill runs K1 on
its heads and a lockstep decode step K6 on its kv heads. The prompt's
rows split over the batch axes and every rank returns the whole
``[B, T]``. A MoE model's experts split over the ``expert`` axis
(``merge_rules(TP_DECODE_RULES, EP_RULES)``); drop-free routing needs no
view of the other ranks' tokens (parallel/expert.py). Sampling is
mesh-invariant: every rank draws the global
``[B, V]`` exponentials from the same generator state and keeps its rows,
so a sampled mesh decode equals the one-device one at the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel.collectives import all_reduce_, gather_nograd, reduce_from
from ..parallel.ring_attention import NEG_INF
from ..parallel.spmd import rule_size
from . import transformer
from .transformer import TransformerConfig, _local, layer_params, rms_norm


@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor       # [n_layers, B, n_kv_heads, max_len, head_dim]
    v: torch.Tensor
    # number of valid positions: an int (lockstep), or an [S] int32 tensor
    # of per-row logical lengths (the serving slot pool)
    length: int | torch.Tensor
    # int8 mode only: [n_layers, B, n_kv_heads, max_len] bf16 dequant scales
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               kv_dtype: str = "native", device=None,
               n_kv_heads: int | None = None) -> KVCache:
    """kv_dtype "native" stores cfg.dtype (exact); "int8" stores symmetric
    int8 with per-token-per-head bf16 scales (half the bytes, within int8
    resolution). Head-major: each head's [M, D] history is contiguous.
    ``device`` None means the card (resolve_device); ``n_kv_heads`` (a
    tensor-parallel rank's share) defaults to the model's."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, n_kv_heads or cfg.n_kv_heads, max_len,
             cfg.head_dim)
    if kv_dtype == "int8":
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            length=0,
            k_scale=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
        )
    if kv_dtype != "native":
        raise ValueError(f"kv_dtype must be 'native' or 'int8', got {kv_dtype!r}")
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   length=0)


@dataclasses.dataclass(frozen=True)
class PrefixPool:
    """The serving prefix cache's shared KV block pool (models/serving.py):
    ``n_blocks`` chunk-sized blocks, each holding ``chunk`` consecutive
    positions of some cached prompt prefix. The slot cache's layout with
    the block axis where the slot axis sits, so a block copies to or from
    a slot's ring by indexing alone; its dtype is the slot cache's, so an
    int8 pool holds the quantized values and their scales and a cache hit
    reads the bytes the cold prefill wrote."""
    k: torch.Tensor       # [n_layers, n_blocks, n_kv_heads, chunk, head_dim]
    v: torch.Tensor
    # int8 mode only: [n_layers, n_blocks, n_kv_heads, chunk] bf16 scales
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def init_prefix_pool(cfg: TransformerConfig, n_blocks: int, chunk: int,
                     kv_dtype: str = "native", device=None,
                     n_kv_heads: int | None = None) -> PrefixPool:
    """The prefix pool (device memory: n_blocks x the KV bytes of ``chunk``
    positions over every layer); the same dtype rules as init_cache."""
    cache = init_cache(cfg, n_blocks, chunk, kv_dtype, device, n_kv_heads)
    return PrefixPool(k=cache.k, v=cache.v, k_scale=cache.k_scale,
                      v_scale=cache.v_scale)


def _symmetric_int8(x, axis: int):
    """Symmetric int8 quantization over ``axis`` -> (int8 values, f32
    scales with ``axis`` kept as size 1)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_kv(x):
    """[B, kvH, L, D] -> (int8 values, [B, kvH, L] bf16 scales)."""
    q, scale = _symmetric_int8(x, axis=-1)
    return q, scale[..., 0].to(torch.bfloat16)


def _takes_decode_kernel(cfg, l_new: int, on_cuda: bool, cache_len,
                         ring_offsets, allow_kernel: bool = True) -> bool:
    """The decode kernel's gate: a lockstep single-token step on the card.
    The kernel takes one scalar length and absolute positions, so per-row
    lengths and ring offsets (the serving slot pool) keep the einsum path,
    as the JAX package's gate does (its generate.py:202-205)."""
    return (allow_kernel and l_new == 1 and on_cuda
            and not torch.is_tensor(cache_len) and ring_offsets is None
            and cfg.attn_impl != "ref")


def _layer_cache_heads(ck, cv, k_scale, v_scale, layer_idx, kv_sel):
    """Layer ``layer_idx``'s cache at the kv heads ``kv_sel`` (one per
    query head of this rank: the heads split over the tensor axis while
    the cache keeps every kv head), as contiguous copies."""
    ck, cv = ck[layer_idx].index_select(1, kv_sel), \
        cv[layer_idx].index_select(1, kv_sel)
    if k_scale is not None:
        k_scale = k_scale[layer_idx].index_select(1, kv_sel)
        v_scale = v_scale[layer_idx].index_select(1, kv_sel)
    return ck, cv, k_scale, v_scale


def _cached_attention(cfg, q, ck, cv, cache_len, l_new: int,
                      k_scale=None, v_scale=None, ring_offsets=None,
                      allow_kernel=True, layer_idx=None):
    """q: [B, L, H, D] for the L new positions (absolute offsets
    cache_len..cache_len+L-1); ck/cv: the cache buffers (the full
    [Ly, B, kvH, M, D] stack with ``layer_idx``), already holding the new
    keys. ``cache_len`` is one int for every row (lockstep) or a [B]
    tensor (each row at its own offset: the serving slot pool).

    ``ring_offsets`` [B]: each row's buffer is a ring whose index m holds
    logical position (m - offset_b) mod M; the mask maps indices to
    logical positions per row (the JAX package's generate.py:237-258)."""
    b, l, h, d = q.shape
    kvh = ck.shape[1 if layer_idx is None else 2]
    rep = h // kvh          # a rank's heads: its kv heads times the model's
    if _takes_decode_kernel(cfg, l, q.is_cuda, cache_len, ring_offsets,
                            allow_kernel):
        from ..ops.decode_attention import flash_decode

        out = flash_decode(q.reshape(b, kvh, rep, d), ck, cv, cache_len,
                           k_scale, v_scale, window=cfg.attn_window or 0,
                           layer=layer_idx)
        return out.reshape(b, 1, h, d)
    if layer_idx is not None:           # views, not copies
        ck, cv = ck[layer_idx], cv[layer_idx]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer_idx], v_scale[layer_idx]
    dt = cfg.dtype
    m = ck.shape[2]
    q5 = q.reshape(b, l, kvh, rep, d)
    # f32 scores from the storage-dtype operands (exact products, f32 sum)
    s = torch.einsum("blgrd,bgmd->bgrlm", q5.float(),
                     ck.to(dt).float()) * cfg.head_dim ** -0.5
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, None, :]
    key_log = torch.arange(m, device=q.device)[None, :]          # [1, M]
    if ring_offsets is not None:
        key_log = (key_log - ring_offsets[:, None]) % m         # [B, M]
    steps = torch.arange(l_new, device=q.device)
    if torch.is_tensor(cache_len):
        q_pos = cache_len[:, None] + steps                      # [B, L]
    else:
        q_pos = cache_len + steps                               # [L]
    mask = key_log[:, None, :] <= q_pos[..., :, None]   # causal + validity
    if cfg.attn_window:
        mask &= key_log[:, None, :] > q_pos[..., :, None] - cfg.attn_window
    # mask is [1 or B, L, M]: broadcast over kv heads and their query heads
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, None, :]
    out = torch.einsum("bgrlm,bgmd->blgrd", p.to(dt), cv.to(dt))
    return out.reshape(b, l, h, d)


def _prefill_cfg(cfg: TransformerConfig) -> TransformerConfig:
    """The prefill's attention config: sequence-parallel impls need a mesh
    decode does not have, so they take the single-device auto dispatch."""
    if cfg.attn_impl in ("ring", "ulysses"):
        return dataclasses.replace(cfg, attn_impl="auto")
    return cfg


def moe_dropfree(cfg: TransformerConfig) -> TransformerConfig:
    """Decode routes B*1 tokens at a time, where the training capacity
    (cf * tokens * k / E) would drop a token that shares an expert with
    another; a capacity factor of at least E/k keeps every token, in decode
    and prefill alike (the JAX package's generate.py:282). generate,
    speculative_generate and the SlotServer all apply it: their exactness
    against one another rests on it."""
    if cfg.n_experts <= 0:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=max(cfg.capacity_factor,
                                 cfg.n_experts / cfg.expert_top_k))


def _cast_leaf(w, dtype):
    """A float32 leaf at ``dtype``; a DTensor casts its local block and
    keeps its placement."""
    if w.dtype != torch.float32:
        return w
    if not hasattr(w, "to_local"):
        return w.to(dtype)
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(w.to_local().to(dtype), w.device_mesh,
                              w.placements, run_check=False, shape=w.shape,
                              stride=w.stride())


def _cast_params(params, dtype):
    return {name: (_cast_params(w, dtype) if isinstance(w, dict)
                   else _cast_leaf(w, dtype))
            for name, w in params.items()}


def _cast_decode_params(params, cfg: TransformerConfig):
    """Pre-cast f32 master weights to the activation dtype once per call:
    the same rounding as the forward's per-use casts, without re-reading
    the f32 copy every step. The MoE router keeps its dtype: ``_mlp``
    reads it at float32 for the aux loss (the JAX package's
    generate.py:300-318)."""
    if cfg.dtype == torch.float32:
        return params
    out = _cast_params(params, cfg.dtype)
    if cfg.n_experts > 0:
        out["layers"]["router"] = params["layers"]["router"]
    return out


def _quantize_weight(w):
    """[..., d_in, d_out] -> (int8, float32 scales [..., 1, d_out]):
    symmetric per-output-channel quantization over the contraction axis, so
    the scale folds out of the product: y = (x @ W_int8) * s."""
    return _symmetric_int8(w, axis=-2)


def _fuse_decode_weights(params, cfg: TransformerConfig,
                         weight_dtype: str = "native"):
    """Concatenate per-layer q/k/v and gate/up weights into one matrix each
    ([L, d, h*hd + 2*kvh*hd] and [L, d, 2*f]): two skinny GEMMs per layer
    instead of five on the weight-streaming decode step.

    ``weight_dtype="int8"`` also quantizes every large decode matrix (the
    fused qkv and gate/up, wo as [L, h*hd, d], w_down and the unembed), each
    beside its ``<name>_s`` scales in cfg.dtype (the JAX package's
    generate.py:331-383). These live beside the cast params, which the
    serving prefill reads.

    MoE has no gate/up to fuse: native weights give ``{"wqkv"}`` only, and
    int8 quantizes qkv, wo, the unembed and every expert's ``w_in`` [L, E,
    d, f] and ``w_out`` [L, E, f, d], per expert and output channel."""
    if weight_dtype not in ("native", "int8"):
        raise ValueError(
            f"weight_dtype must be 'native' or 'int8', got {weight_dtype!r}")
    L, d = cfg.n_layers, cfg.d_model
    lp = params["layers"]
    moe = cfg.n_experts > 0
    wqkv = torch.cat([lp["wq"].reshape(L, d, -1), lp["wk"].reshape(L, d, -1),
                      lp["wv"].reshape(L, d, -1)], dim=-1)
    if not moe:
        w_gu = torch.cat([lp["w_gate"], lp["w_up"]], dim=-1)
    if weight_dtype != "int8":
        return {"wqkv": wqkv} if moe else {"wqkv": wqkv, "w_gu": w_gu}
    big = [("wqkv", wqkv),
           ("wo", lp["wo"].reshape(L, cfg.n_heads * cfg.head_dim, d)),
           ("unembed", params["unembed"])]
    big += ([("w_in", lp["w_in"]), ("w_out", lp["w_out"])] if moe
            else [("w_gu", w_gu), ("w_down", lp["w_down"])])
    out = {}
    for name, w in big:
        out[name], scale = _quantize_weight(w)
        out[name + "_s"] = scale.to(cfg.dtype)
    return out


def _attn_out(attn, wo, cfg: TransformerConfig, plan):
    """The attention's output projection; a rank's heads give a partial
    sum, reduced over the tensor axis."""
    out = torch.einsum("blhk,hkd->bld", attn, wo.to(cfg.dtype))
    return out if plan is None else reduce_from(out, plan.tp_group("heads"))


def _unembed(x, params, cfg: TransformerConfig, plan, eq: str):
    """float32 logits over the whole vocabulary: a rank's vocabulary
    columns, gathered over the tensor axis."""
    w = _local(params["unembed"])
    if plan is not None:
        w = plan.use(w, ("embed", "vocab"))
    logits = torch.einsum(eq, x, w.to(cfg.dtype)).float()
    if plan is None:
        return logits
    return gather_nograd(logits, logits.dim() - 1, plan.tp_group("vocab"))


def _replicated_kv_heads(cfg: TransformerConfig, plan, n_q_heads: int,
                         device):
    """The cache's kv head each of this rank's query heads reads, when the
    heads split over the tensor axis and the kv heads do not (the rules'
    "kv" replicated); else None."""
    if plan is None or plan.tp["heads"] is None or plan.tp["kv"] is not None:
        return None
    rep = cfg.n_heads // cfg.n_kv_heads
    first = plan.tp_rank("heads") * n_q_heads
    return torch.arange(first, first + n_q_heads, device=device) // rep


def _forward_with_cache(params, cfg: TransformerConfig, tokens, cache: KVCache,
                        fused: dict | None = None, prefill: bool = False,
                        all_logits: bool = False, ring: tuple | None = None,
                        plan=None):
    """Run L new tokens (absolute positions cache.length..+L-1) through the
    stack, writing their K/V into the cache IN PLACE -> (last-position
    logits [B, V] f32, or [B, L, V] with ``all_logits``; the cache with its
    length advanced, over the same buffers).

    ``cache.length`` may be a [B] tensor: every row then decodes at its own
    logical position (per-row rope positions and masks), the decode step of
    the serving slot pool. That requires ``ring=(cursor, offsets)``: row
    b's logical position p lives at index (p + offsets[b]) mod M, and every
    row's K/V is written at the one shared host-int ``cursor`` index.
    Single-token steps only (serving prefill has its own program).

    ``prefill=True`` requires an empty cache: attention over the block then
    is causal attention within the block and runs through the model's own
    dispatch (the flash kernel on CUDA), instead of scoring against the
    whole max_len buffer. A multi-token chunk into a non-empty cache
    passes prefill=False and takes the general cached-attention path.

    ``plan`` (a mesh's, parallel/spmd.py): this rank's blocks, as the
    module docstring says."""
    dt = cfg.dtype
    b, l = tokens.shape
    start = cache.length
    m_cap = cache.k.shape[3]
    if torch.is_tensor(start):
        if ring is None or l != 1:
            raise ValueError(
                "per-row cache lengths require ring=(cursor, offsets) and "
                "single-token steps (the serving decode contract)")
        cursor, ring_offsets = ring
        positions = start[:, None].long() + torch.arange(
            l, device=start.device)
        span = slice(cursor, cursor + l)
    else:
        if start + l > m_cap:
            raise ValueError(f"cache capacity {m_cap} cannot hold {start} "
                             f"cached + {l} new positions")
        if prefill and start != 0:
            raise ValueError("prefill=True requires an empty cache")
        ring_offsets = None
        positions = (start + torch.arange(
            l, device=tokens.device)).expand(b, l)
        span = slice(start, start + l)
    x = transformer._embed(params, tokens, cfg, plan)

    hd = cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p_cfg = _prefill_cfg(cfg) if prefill else None
    w8 = fused is not None and "wqkv_s" in fused    # int8 decode weights
    ck, cv = cache.k, cache.v
    int8_cache = ck.dtype == torch.int8
    kv_sel = None
    for i in range(cfg.n_layers):
        lp = layer_params(params, i, plan, cfg)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        if fused is not None:
            qkv = torch.einsum("bld,de->ble", h, fused["wqkv"][i].to(dt))
            if w8:
                qkv = qkv * fused["wqkv_s"][i]
            q = qkv[..., :nq].reshape(b, l, cfg.n_heads, hd)
            k = qkv[..., nq:nq + nkv].reshape(b, l, cfg.n_kv_heads, hd)
            v = qkv[..., nq + nkv:].reshape(b, l, cfg.n_kv_heads, hd)
            q = transformer.rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
            k = transformer.rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        else:
            q, k, v = transformer._qkv(cfg, h, positions, lp, plan)
            if i == 0:
                kv_sel = _replicated_kv_heads(cfg, plan, q.shape[2], q.device)
        k_hm = k.transpose(1, 2)    # [B, kvH, L, D] head-major
        v_hm = v.transpose(1, 2)
        if int8_cache:
            k_w, ks = _quantize_kv(k_hm)
            v_w, vs = _quantize_kv(v_hm)
            cache.k_scale[i, :, :, span] = ks
            cache.v_scale[i, :, :, span] = vs
        else:
            k_w, v_w = k_hm, v_hm
        ck[i, :, :, span] = k_w     # in place (slice assignment casts)
        cv[i, :, :, span] = v_w
        if prefill:
            kr, vr = transformer._rank_kv(cfg, k, v, q.shape[2], plan)
            attn = transformer._attention(q, kr, vr, p_cfg)
        elif kv_sel is not None:
            sk, sv, sks, svs = _layer_cache_heads(
                ck, cv, cache.k_scale, cache.v_scale, i, kv_sel)
            attn = _cached_attention(cfg, q, sk, sv, start, l, sks, svs,
                                     ring_offsets=ring_offsets)
        else:
            attn = _cached_attention(cfg, q, ck, cv, start, l,
                                     cache.k_scale, cache.v_scale,
                                     ring_offsets=ring_offsets, layer_idx=i)
        if w8:
            proj = torch.einsum("ble,ed->bld", attn.reshape(b, l, nq),
                                fused["wo"][i].to(dt)) * fused["wo_s"][i]
        else:
            proj = _attn_out(attn, lp["wo"], cfg, plan)
        x = x + proj
        hh = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        if fused is not None and "w_gu" in fused:
            gu = torch.einsum("bld,de->ble", hh, fused["w_gu"][i].to(dt))
            if w8:
                gu = gu * fused["w_gu_s"][i]
            gate, up = gu[..., :cfg.d_ff], gu[..., cfg.d_ff:]
            down = (fused["w_down"][i] if w8 else lp["w_down"]).to(dt)
            mlp_out = torch.einsum("blf,fd->bld", F.silu(gate) * up, down)
            if w8:
                mlp_out = mlp_out * fused["w_down_s"][i]
        elif fused is not None and "w_in" in fused:
            # int8 experts: the router, capacity and activation of
            # transformer._mlp, so routing matches the native path exactly
            from ..parallel.expert import moe_ffn

            mlp_out = moe_ffn(
                hh.reshape(b * l, cfg.d_model), lp["router"].to(dt),
                fused["w_in"][i], fused["w_out"][i], k=cfg.expert_top_k,
                capacity_factor=cfg.capacity_factor, activation=F.silu,
                w_in_scale=fused["w_in_s"][i],
                w_out_scale=fused["w_out_s"][i]).reshape(b, l, cfg.d_model)
        else:
            mlp_out, _ = transformer._mlp(cfg, hh, lp, plan)
        x = x + mlp_out

    x_out = rms_norm(x if all_logits else x[:, -1],
                     _local(params["final_norm"]), cfg.norm_eps)
    eq = "bld,dv->blv" if all_logits else "bd,dv->bv"
    if w8:
        logits = (torch.einsum(eq, x_out, fused["unembed"].to(dt))
                  * fused["unembed_s"][0]).float()
    else:
        logits = _unembed(x_out, params, cfg, plan, eq)
    return logits, dataclasses.replace(cache, length=start + l)


def _draw(probs, generator, rows=None):
    """One draw per row of ``probs`` [B, V]: argmax(p / q) with q ~ Exp(1),
    the exponential trick torch.multinomial runs for one sample, without
    its host-side check of the probabilities (a wait for the card).
    ``rows=(first, total)``: ``probs`` are rows first.. of a [total, V]
    batch split over ranks; the draw makes the whole batch's q and keeps
    these rows, so every split draws what one device would."""
    if rows is None:
        q = torch.empty_like(probs).exponential_(1, generator=generator)
    else:
        first, total = rows
        q = torch.empty((total,) + tuple(probs.shape[1:]), dtype=probs.dtype,
                        device=probs.device).exponential_(
            1, generator=generator)[first:first + probs.shape[0]]
    return (probs / q).argmax(dim=-1).to(torch.int32)


def sample_token(logits, generator=None, temperature=0.0, top_k=0,
                 rows=None):
    """logits [B, V] -> token ids [B] int32. temperature=0 => greedy;
    otherwise a draw from ``generator`` (on logits' device) over the
    temperature-scaled, optionally top-k-filtered distribution.

    ``temperature`` may be a [B] tensor (the serving slot pool: each row
    at its own request's temperature): rows at 0 take the greedy argmax,
    the others sample. ``top_k`` likewise: an int applies one threshold to
    every row; a [B] int tensor gives each row its own k (k <= 0 keeps
    every value) by a per-row k-th-value threshold from one full sort (the
    JAX package's generate.py:585-622). ``rows`` places a batch shard in
    the whole batch (``_draw``)."""
    per_row = torch.is_tensor(temperature)
    if per_row:
        scaled = logits / temperature.clamp_min(1e-6)[:, None]
    elif temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    else:
        scaled = logits / temperature
    if torch.is_tensor(top_k):
        v = scaled.shape[-1]
        srt = torch.sort(scaled, dim=-1).values          # ascending
        # row r keeps values >= its top_k[r]-th largest, srt[r, V - k]
        idx = (v - top_k.long()).clamp(0, v - 1)
        kth = srt.gather(-1, idx[:, None])
        keep = (top_k[:, None] <= 0) | (scaled >= kth)
        scaled = torch.where(keep, scaled, NEG_INF)
    elif top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled, NEG_INF)
    sampled = _draw(torch.softmax(scaled, dim=-1), generator, rows)
    if not per_row:
        return sampled
    return torch.where(temperature > 0, sampled,
                       logits.argmax(dim=-1).to(torch.int32))


class DecodeWeights(NamedTuple):
    """Decode-ready weights built once by ``prepare_decode``: pre-cast and
    pre-fused, so repeated generate calls make no per-call weight copies.
    Pass in place of raw params. ``mesh`` and ``rules`` are what the
    weights were placed by (None without a mesh); generate and the
    SlotServer take the rules from here and refuse another mesh."""
    params: dict
    fused: dict | None
    weight_dtype: str = "native"
    mesh: Any = None
    rules: Any = None


def _validate_decode_mesh(cfg: TransformerConfig, mesh, rules) -> None:
    """Head counts must divide their sharding axes: a split head has no
    layout (the [M, D] cache block and the per-head softmax are atomic)
    (the JAX package's generate.py:671-690)."""
    t_kv = rule_size(mesh, rules, "kv")
    if cfg.n_kv_heads % t_kv:
        raise ValueError(
            f"mesh-sharded decode: n_kv_heads={cfg.n_kv_heads} is not "
            f"divisible by the 'kv' mesh axes (size {t_kv}) — a GQA model "
            "with fewer kv heads than the tensor axis cannot shard its KV "
            "cache. Shrink the tensor axis, or set rules['kv'] = None to "
            "replicate the cache.")
    t_h = rule_size(mesh, rules, "heads")
    if cfg.n_heads % t_h:
        raise ValueError(
            f"mesh-sharded decode: n_heads={cfg.n_heads} is not divisible "
            f"by the 'heads' mesh axes (size {t_h})")


def _full(w):
    """A DTensor's whole value (a collective); a plain tensor as it is."""
    return w.full_tensor() if hasattr(w, "full_tensor") else w


def _place(mesh, params, cfg: TransformerConfig, rules):
    """Every parameter as a DTensor placed by the rule table. A DTensor
    already placed so (a checkpoint restored into such templates) is kept;
    any other leaf is made whole first and sliced (parallel/sharding.py
    ``shard_params``)."""
    from ..parallel.sharding import (
        logical_to_spec, shard_params, spec_to_placements,
    )

    logical = transformer.param_logical_axes(cfg)

    def walk(tree, axes):
        if isinstance(tree, dict):
            return {k: walk(tree[k], axes[k]) for k in tree}
        want = spec_to_placements(logical_to_spec(axes, rules),
                                  mesh.mesh_dim_names)
        if (hasattr(tree, "placements") and tree.device_mesh == mesh
                and tuple(tree.placements) == want):
            return tree
        return shard_params(mesh, _full(tree), axes, rules)

    return walk(params, logical)


def prepare_decode(params, cfg: TransformerConfig, *,
                   weight_dtype: str = "native", mesh=None,
                   rules=None) -> DecodeWeights:
    """Cast f32 masters to cfg.dtype and fuse qkv / gate-up ONCE, outside
    generate (``weight_dtype="int8"``: also quantize the decode matrices).
    A caller that then drops its f32 masters holds the cast params and the
    fused (or quantized) matrices.

    With a ``mesh``, every parameter is placed by the rule table
    (``TP_DECODE_RULES`` by default) as a DTensor holding this rank's
    block. Under a sharded tensor axis (heads, kv or mlp split) the fusion
    is skipped and int8 weights are refused: the w8a16 path streams the
    fused layout (the JAX package's generate.py:694-744)."""
    if weight_dtype not in ("native", "int8"):
        raise ValueError(
            f"weight_dtype must be 'native' or 'int8', got {weight_dtype!r}")
    if mesh is None:
        params = _cast_decode_params(params, cfg)
        fused = _fuse_decode_weights(params, cfg, weight_dtype)
        return DecodeWeights(params=params, fused=fused,
                             weight_dtype=weight_dtype)
    if rules is None:
        from ..parallel.sharding import TP_DECODE_RULES

        rules = TP_DECODE_RULES
    rules = dict(rules)
    _validate_decode_mesh(cfg, mesh, rules)
    sharded_tp = any(rule_size(mesh, rules, r) > 1
                     for r in ("heads", "kv", "mlp"))
    if sharded_tp and weight_dtype == "int8":
        raise ValueError(
            "weight_dtype='int8' decode is single-device: the w8a16 path "
            "streams the fused qkv/gate-up layout, which conflicts with "
            "head/mlp-sharded weights")
    transformer._plan(mesh, rules, cfg)      # checks the rule table
    params = _cast_decode_params(_place(mesh, params, cfg, rules), cfg)
    fused = None
    if not sharded_tp:
        whole = _map_tree(params, _full)
        fused = _fuse_decode_weights(whole, cfg, weight_dtype)
    return DecodeWeights(params=params, fused=fused,
                         weight_dtype=weight_dtype, mesh=mesh, rules=rules)


def _map_tree(params, fn):
    return {k: (_map_tree(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in params.items()}


def _check_continuation(cache: KVCache, b, lp_len, max_new_tokens, max_len,
                        kv_dtype, return_cache):
    if not return_cache:
        raise ValueError(
            "cache= requires return_cache=True: the passed cache is updated "
            "in place, so without returning it the conversation state would "
            "be consumed. On a final turn, pass return_cache=True and drop "
            "the result.")
    cap = cache.k.shape[3]
    if cache.k.shape[1] != b:
        raise ValueError(f"continuation batch {b} != cache batch "
                         f"{cache.k.shape[1]}")
    if cache.length + lp_len + max_new_tokens > cap:
        raise ValueError(
            f"cache capacity {cap} cannot hold {cache.length} cached + "
            f"{lp_len} new prompt + {max_new_tokens} generated tokens — size "
            "the first call's max_len for the whole conversation")
    if max_len is not None and max_len != cap:
        raise ValueError(f"max_len={max_len} conflicts with the passed "
                         f"cache's capacity {cap} (omit max_len when "
                         "continuing)")
    cache_kv = "int8" if cache.k.dtype == torch.int8 else "native"
    if kv_dtype != "native" and kv_dtype != cache_kv:
        raise ValueError(f"kv_dtype={kv_dtype!r} conflicts with the passed "
                         f"cache ({cache_kv})")
    return cap, cache_kv


@torch.no_grad()
def generate(params, cfg: TransformerConfig, prompt: torch.Tensor,
             max_new_tokens: int, *, temperature: float = 0.0, top_k: int = 0,
             generator: torch.Generator | None = None,
             kv_dtype: str = "native", max_len: int | None = None,
             weight_dtype: str = "native", stop_tokens: tuple = (),
             pad_id: int = 0, return_steps: bool = False,
             cache: KVCache | None = None, return_cache: bool = False,
             mesh=None, rules=None):
    """Generate max_new_tokens continuations -> [B, max_new_tokens] int32,
    on the device of ``prompt`` (the params must be there too).

    Prefill once, then single-token decode steps against the in-place
    cache; with ``stop_tokens`` rows that emit a listed token stop, their
    remaining positions are ``pad_id``, and the loop exits once every row
    has stopped. ``return_steps=True`` also returns the number of decode
    forwards run.

    ``params`` may be a raw parameter dict or a ``DecodeWeights`` from
    ``prepare_decode``. ``generator`` draws the samples (default: a
    generator on the prompt's device seeded with 0).

    ``return_cache=True`` also returns the KV cache holding prompt + ALL
    emitted tokens; pass it back as ``cache=`` with only the NEW tokens as
    the prompt. The passed cache is updated IN PLACE (clone its tensors
    first to fan several continuations out of one prefix), so ``cache=``
    requires ``return_cache=True``.

    ``mesh`` (and ``rules``, default the prepared weights' or
    ``TP_DECODE_RULES``): every rank of the mesh calls generate with the
    whole prompt; it decodes its rows (the batch must divide the batch
    axes) on its heads and returns the whole ``[B, T]`` (module
    docstring). Prepared weights must have been placed on the same mesh
    ("mesh mismatch" otherwise). A returned cache, and ``cache=``, is the
    rank's shard."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if not cfg.causal:
        raise ValueError("generate requires causal=True (a bidirectional "
                         "encoder has no autoregressive decode)")
    cfg = moe_dropfree(cfg)
    if weight_dtype not in ("native", "int8"):
        raise ValueError(
            f"weight_dtype must be 'native' or 'int8', got {weight_dtype!r}")
    device = prompt.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    b, lp_len = prompt.shape
    if mesh is not None:
        if rules is None and isinstance(params, DecodeWeights):
            rules = params.rules
        if rules is None:
            from ..parallel.sharding import TP_DECODE_RULES

            rules = TP_DECODE_RULES
        _validate_decode_mesh(cfg, mesh, rules)
        t_b = rule_size(mesh, rules, "batch")
        if b % t_b:
            raise ValueError(
                f"mesh-sharded decode: batch {b} is not divisible by the "
                f"'batch' mesh axes (size {t_b})")
    if isinstance(params, DecodeWeights):
        if weight_dtype != "native" and weight_dtype != params.weight_dtype:
            raise ValueError(
                f"weight_dtype={weight_dtype!r} requested but the prepared "
                f"weights were built with {params.weight_dtype!r} — pass "
                "weight_dtype to prepare_decode instead")
        prep_mesh = params.mesh
        if (mesh is None) != (prep_mesh is None) or (
                mesh is not None and mesh != prep_mesh):
            raise ValueError(
                "mesh mismatch: prepared weights were built "
                + ("without a mesh" if prep_mesh is None
                   else "for a different mesh")
                + (" but generate was called with one" if prep_mesh is None
                   else f" ({prep_mesh} != {mesh})")
                + " — rebuild with prepare_decode(..., mesh=...) matching "
                "the generate call")
        prepared = params
    else:
        prepared = prepare_decode(params, cfg, weight_dtype=weight_dtype,
                                  mesh=mesh, rules=rules)
    w, fused = prepared.params, prepared.fused
    plan = transformer._plan(mesh, prepared.rules, cfg)
    rows = None             # (first row, B) of this rank's batch shard
    n_kv = None
    if plan is not None:
        b_loc = b // plan.batch_size
        first = plan.batch_rank * b_loc
        if plan.batch_size > 1:
            rows = (first, b)
            prompt = prompt[first:first + b_loc]
        n_kv = cfg.n_kv_heads // rule_size(mesh, prepared.rules, "kv")
        b = b_loc
    if cache is not None:
        max_len, kv_dtype = _check_continuation(
            cache, b, lp_len, max_new_tokens, max_len, kv_dtype, return_cache)
    elif max_len is None:
        max_len = lp_len + max_new_tokens
    elif max_len < lp_len + max_new_tokens:
        raise ValueError(f"max_len={max_len} < prompt ({lp_len}) + "
                         f"max_new_tokens ({max_new_tokens})")

    if cache is None:
        cache = init_cache(cfg, b, max_len, kv_dtype, device, n_kv)
        logits, cache = _forward_with_cache(w, cfg, prompt, cache, fused,
                                            prefill=True, plan=plan)
    else:
        logits, cache = _forward_with_cache(w, cfg, prompt, cache, fused,
                                            plan=plan)
    tok = sample_token(logits, generator, temperature, top_k, rows)
    out = torch.full((b, max_new_tokens), pad_id, dtype=torch.int32,
                     device=device)
    out[:, 0] = tok
    stops = torch.tensor([int(t) for t in stop_tokens], dtype=torch.int32,
                         device=device)
    finished = torch.isin(tok, stops)
    steps = 0
    while steps < max_new_tokens - 1:
        if stop_tokens and _all_finished(finished, plan):
            break
        logits, cache = _forward_with_cache(w, cfg, tok[:, None], cache, fused,
                                            plan=plan)
        nxt = sample_token(logits, generator, temperature, top_k, rows)
        if stop_tokens:
            # finished rows emit pad and stay finished
            nxt = torch.where(finished, torch.full_like(nxt, pad_id), nxt)
            finished = finished | torch.isin(nxt, stops)
        steps += 1
        out[:, steps] = nxt
        tok = nxt

    if return_cache:
        # ingest the final emitted token so the cache holds the whole
        # conversation so far
        _, cache = _forward_with_cache(w, cfg, tok[:, None], cache, fused,
                                       plan=plan)
    if rows is not None:
        out = plan.gather_batch(out).reshape(-1, max_new_tokens)
    result = (out,)
    if return_steps:
        result += (steps,)
    if return_cache:
        result += (cache,)
    return result if len(result) > 1 else out


def _all_finished(finished, plan) -> bool:
    """Every row stopped, on every batch shard (a host read)."""
    done = finished.all().to(torch.int32).reshape(1)
    if plan is not None:
        for a in plan.batch_axes:
            all_reduce_(done, plan.group(a), torch.distributed.ReduceOp.MIN)
    return bool(done[0])


__all__ = ["KVCache", "init_cache", "PrefixPool", "init_prefix_pool",
           "generate", "sample_token", "prepare_decode", "DecodeWeights",
           "moe_dropfree"]
