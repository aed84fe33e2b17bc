"""Flash decode: cached attention of one new token per sequence (port of
the JAX package's ops/decode_attention.py).

On a CUDA tensor the work runs in ``csrc/flash_decode.cu``: a split-KV pass
that reads only the valid cache positions in chunks spread over the SMs,
then a pass that combines the chunks' partial softmax states. On a CPU
tensor it runs in ``_flash_decode_reference``, the plain PyTorch version.
A CUDA input the kernel does not take raises. Each pass also has its own
plain version (``_decode_partial_reference``, ``_decode_combine_reference``)
that the kernels are held against on the card.

The current token's K/V must already be in the cache (write, then attend);
masking is by absolute position, key_pos <= length, with the optional
sliding-window band key_pos > length - window.
"""

from __future__ import annotations

import functools

import torch

from ..parallel.ring_attention import NEG_INF
from . import _build

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
KERNEL_HEAD_DIMS = (64, 128)
MAX_REP = 8        # query heads per kv head the kernel holds in registers
MAX_CHUNK = 1024   # cache positions per CTA (scores of a chunk sit in smem)

# kernel launches since the last reset (see reset_launches), per pass
partial_launches = 0
combine_launches = 0


def reset_launches() -> None:
    global partial_launches, combine_launches
    partial_launches = combine_launches = 0


def _valid_range(length: int, window: int) -> tuple[int, int]:
    """First and last cache position the token attends to."""
    lo = max(0, length - window + 1) if window else 0
    return lo, length


def _layer_view(t, layer):
    return t if layer is None or t is None else t[layer]


def _flash_decode_reference(q, ck, cv, length, k_scale=None, v_scale=None, *,
                            window=0, layer=None):
    """Plain version of the kernel, same arguments as ``flash_decode``.
    Scores, softmax and the PV sum in float32 over the whole buffer, with
    the position mask; int8 scales fold in as the kernel folds them (K's on
    the score columns, V's on p for the value sum only)."""
    ck, cv = _layer_view(ck, layer), _layer_view(cv, layer)
    k_scale, v_scale = _layer_view(k_scale, layer), _layer_view(v_scale, layer)
    d = q.shape[-1]
    s = torch.einsum("bhrd,bhmd->bhrm", q.float(), ck.float()) * d ** -0.5
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    pos = torch.arange(ck.shape[2], device=q.device)
    mask = pos <= length
    if window:
        mask &= pos > length - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, :]
    return torch.einsum("bhrm,bhmd->bhrd", p, cv.float()).to(q.dtype)


def _chunking(n_valid: int, heads: int, rep: int, sms: int) -> tuple[int, int]:
    """(chunk, n_chunks): split the valid range so pass 1 has about two
    CTAs per SM, with chunks of 32..MAX_CHUNK positions."""
    splits = max(1, -(-2 * sms // heads))
    cap = min(MAX_CHUNK, (8192 // rep) // 32 * 32)
    chunk = -(-n_valid // splits)
    chunk = min(cap, max(32, -(-chunk // 32) * 32))
    return chunk, -(-n_valid // chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _decode_partial_reference(q, ck, cv, k_scale, v_scale, lo, length,
                              chunk, n_chunks, layer=None):
    """Plain version of pass 1: the unnormalised softmax state of each
    ``chunk``-position piece of [lo, length] -> (part_o [B*kvH, n_chunks,
    rep, D], part_m and part_l [B*kvH, n_chunks, rep]), float32. A chunk's
    m is its largest score, l the sum of exp(s - m), o the sum of
    exp(s - m) * v_scale * v."""
    ck, cv = _layer_view(ck, layer), _layer_view(cv, layer)
    k_scale, v_scale = _layer_view(k_scale, layer), _layer_view(v_scale, layer)
    b, kvh, rep, d = q.shape
    span = n_chunks * chunk
    pos = lo + torch.arange(span, device=q.device)
    valid = pos <= length
    idx = pos.clamp(max=length)
    k = ck[:, :, idx].float()                         # [B, kvH, span, D]
    v = cv[:, :, idx].float()
    s = torch.einsum("bhrd,bhmd->bhrm", q.float(), k) * d ** -0.5
    if k_scale is not None:
        s = s * k_scale[:, :, idx].float()[:, :, None, :]
    s = torch.where(valid, s, NEG_INF).reshape(b, kvh, rep, n_chunks, chunk)
    m = s.amax(dim=-1)
    p = torch.where(valid.reshape(n_chunks, chunk),
                    torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, idx].float().reshape(b, kvh, 1, n_chunks, chunk)
    o = torch.einsum("bhrcm,bhcmd->bhcrd", p,
                     v.reshape(b, kvh, n_chunks, chunk, d))
    flat = (b * kvh, n_chunks, rep)
    return (o.reshape(*flat, d), m.transpose(2, 3).reshape(flat),
            l.transpose(2, 3).reshape(flat))


def _decode_combine_reference(part_o, part_m, part_l, dtype):
    """Plain version of pass 2: partials -> out [B*kvH, rep, D] in
    ``dtype``. Each chunk weighs exp(m_c - max m); an empty chunk (l = 0)
    adds nothing."""
    mx = part_m.amax(dim=1, keepdim=True)
    w = torch.exp(part_m - mx)                        # [BH, C, rep]
    l = (w * part_l).sum(dim=1)
    o = (w[..., None] * part_o).sum(dim=1)
    return (o / torch.where(l > 0, l, 1.0)[..., None]).to(dtype)


def _check_kernel_inputs(q, ck, cv, k_scale, v_scale, layer):
    want = 5 if layer is not None else 4
    if ck.dim() != want or cv.shape != ck.shape:
        raise ValueError(f"cache must be {want}-d (layer={layer}), got "
                         f"{tuple(ck.shape)} and {tuple(cv.shape)}")
    if not (ck.is_cuda and cv.is_cuda):
        raise ValueError("flash_decode: q and the cache must be on one device")
    b, kvh, rep, d = q.shape
    if ck.shape[-4:-2] != (b, kvh) or ck.shape[-1] != d:
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(ck.shape)}")
    if layer is not None and not 0 <= layer < ck.shape[0]:
        raise ValueError(f"layer {layer} outside the {ck.shape[0]}-layer "
                         "stack")
    if q.dtype not in _Q_DTYPES or d not in KERNEL_HEAD_DIMS or rep > MAX_REP:
        raise ValueError(
            f"flash_decode kernel takes q in float32/bfloat16, head_dim in "
            f"{KERNEL_HEAD_DIMS} and at most {MAX_REP} query heads per kv "
            f"head; got {q.dtype}, head_dim={d}, rep={rep}")
    int8 = ck.dtype == torch.int8
    if ck.dtype not in _CACHE_DTYPES or cv.dtype != ck.dtype or (
            not int8 and ck.dtype != q.dtype):
        raise ValueError(f"cache dtype {ck.dtype}/{cv.dtype} does not go "
                         f"with q dtype {q.dtype}")
    if int8 != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 cache needs k_scale and v_scale, and only "
                         "an int8 cache takes them")
    if int8 and (not (k_scale.is_cuda and v_scale.is_cuda)
                 or k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16
                 or k_scale.shape != ck.shape[:-1]
                 or v_scale.shape != ck.shape[:-1]
                 or not (k_scale.is_contiguous() and v_scale.is_contiguous())):
        raise ValueError("scales must be contiguous bf16 on the card, of "
                         "the cache's shape without head_dim")
    if not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError("flash_decode kernel needs a contiguous cache")


def _layer_base(t, layer):
    """The layer's base pointer in a stacked buffer: an offset, never a
    copy."""
    if t is None:
        return None
    off = 0 if layer is None else layer * t.stride(0) * t.element_size()
    return t.data_ptr() + off


def _decode_partial_cuda(q, ck, cv, k_scale, v_scale, lo, length, chunk,
                         n_chunks, layer):
    """Launch pass 1 of csrc/flash_decode.cu -> (part_o, part_m, part_l)."""
    global partial_launches
    b, kvh, rep, d = q.shape
    part_o = torch.empty((b * kvh, n_chunks, rep, d), dtype=torch.float32,
                         device=q.device)
    part_m = torch.empty((b * kvh, n_chunks, rep), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    cs = ck.stride()[-4:-1]
    ss = k_scale.stride()[-3:-1] if k_scale is not None else (0, 0)
    err = _build.kernel("tony_flash_decode_partial")(
        q.data_ptr(), _layer_base(ck, layer), _layer_base(cv, layer),
        _layer_base(k_scale, layer), _layer_base(v_scale, layer),
        part_o.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        b, kvh, rep, d, _Q_DTYPES[q.dtype], _CACHE_DTYPES[ck.dtype], lo,
        length, chunk, n_chunks, *cs, *ss, d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_decode_partial", err)
    partial_launches += 1
    return part_o, part_m, part_l


def _decode_combine_cuda(part_o, part_m, part_l, dtype):
    """Launch pass 2 of csrc/flash_decode.cu -> out [B*kvH, rep, D]."""
    global combine_launches
    bh, n_chunks, rep, d = part_o.shape
    for t in (part_o, part_m, part_l):
        if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
            raise ValueError("partials must be contiguous float32 on the card")
    if part_m.shape != (bh, n_chunks, rep) or part_l.shape != part_m.shape:
        raise ValueError("partial shapes disagree")
    out = torch.empty((bh, rep, d), dtype=dtype, device=part_o.device)
    err = _build.kernel("tony_flash_decode_combine")(
        part_o.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        out.data_ptr(), bh, rep, d, _Q_DTYPES[dtype], n_chunks,
        torch.cuda.current_stream(part_o.device).cuda_stream)
    _build.check("flash_decode_combine", err)
    combine_launches += 1
    return out


def _flash_decode_cuda(q, ck, cv, length, k_scale, v_scale, window, layer):
    _check_kernel_inputs(q, ck, cv, k_scale, v_scale, layer)
    q = q.contiguous()
    b, kvh, rep, d = q.shape
    m_cap = ck.shape[-2]
    if not 0 <= length < m_cap:
        raise ValueError(f"length {length} outside the cache's {m_cap} "
                         "positions")
    lo, hi = _valid_range(length, window)
    chunk, n_chunks = _chunking(hi - lo + 1, b * kvh, rep,
                                _sm_count(q.device.index or 0))
    parts = _decode_partial_cuda(q, ck, cv, k_scale, v_scale, lo, length,
                                 chunk, n_chunks, layer)
    return _decode_combine_cuda(*parts, q.dtype).reshape(b, kvh, rep, d)


def flash_decode(q, ck, cv, length, k_scale=None, v_scale=None, *,
                 window: int = 0, layer: int | None = None):
    """Cached decode attention for ONE new token per sequence.

    q: [B, kvH, rep, D] current-position queries, grouped by kv head
    ck/cv: [B, kvH, M, D] cache buffers (bf16/f32, or int8 with scales), or
        the full [Ly, B, kvH, M, D] stack with ``layer`` set (read in
        place, never sliced into a copy)
    length: int — the new token's absolute position (its K/V already
        written there); every row at the same offset
    k_scale/v_scale: [B, kvH, M] bf16 ([Ly, B, kvH, M] with ``layer``)
    -> [B, kvH, rep, D] in q's dtype."""
    length = int(length)
    if q.is_cuda:
        return _flash_decode_cuda(q, ck, cv, length, k_scale, v_scale,
                                  window, layer)
    return _flash_decode_reference(q, ck, cv, length, k_scale, v_scale,
                                   window=window, layer=layer)


__all__ = ["flash_decode", "reset_launches"]
