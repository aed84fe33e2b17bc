"""Flash decode: cached attention of one new token per sequence (port of
the JAX package's ops/decode_attention.py).

On a CUDA tensor the work runs in ``csrc/flash_decode.cu``, one launch: the
valid cache positions of each (batch, kv head) are cut into chunks spread
evenly over the SMs, each chunk streams its tiles of K and V through a
two-stage ring of 16-byte cp.async copies with an online softmax and
writes its partial softmax state to a float32 scratch, and the last chunk
of each head to finish combines the partials. On a CPU tensor it runs in ``_flash_decode_reference``, the
plain PyTorch version. A CUDA input the kernel does not take raises. The
kernel's two stages each have their own plain version
(``_decode_partial_reference`` for the chunks' partials,
``_decode_combine_reference`` for their combine) that the kernel's scratch
and output are held against on the card.

The current token's K/V must already be in the cache (write, then attend);
masking is by absolute position, key_pos <= length, with the optional
sliding-window band key_pos > length - window.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..parallel.ring_attention import NEG_INF
from . import _build

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
KERNEL_HEAD_DIMS = (32, 64, 128)
MAX_REP = 8        # query heads per kv head the kernel holds in registers

# kernel launches since the last reset (see reset_launches)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


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


@functools.lru_cache(maxsize=4096)
def _split(n_valid: int, heads: int, tile: int, sms: int,
           per_sm: int = 1) -> tuple[int, int]:
    """(chunk, n_chunks): cut each head's ``n_valid`` positions into
    n_chunks chunks of ``chunk`` (the last may be shorter), one CTA each,
    up to ``per_sm`` CTAs at once on each of ``sms`` SMs. CTAs on one SM
    share its bandwidth, so an SM's time goes as the positions of all its
    CTAs, ceil(CTAs / sms) * chunk, plus about a tile of ramp (a ring
    filling, a partial's merge) per wave of CTAs. Among the splits within
    1% of the least such time this takes the one with the most CTAs that
    still run in one wave: co-resident CTAs hide each other's latency,
    which the int8 cache's conversions need. The positions per SM then
    differ by a few percent at most."""
    cands = []
    for splits in range(1, min(-(-n_valid // tile),
                               -(-4 * sms * per_sm // heads)) + 1):
        chunk = -(-n_valid // splits)
        n_chunks = -(-n_valid // chunk)
        ctas = heads * n_chunks
        cost = (-(-ctas // sms) * chunk
                + -(-ctas // (sms * per_sm)) * tile)
        cands.append((cost, ctas, chunk, n_chunks))
    least = min(cands)[0]
    near = [c for c in cands
            if c[0] <= 1.01 * least and c[1] <= sms * per_sm] or [min(cands)]
    _, _, chunk, n_chunks = max(near, key=lambda c: c[1])
    return chunk, n_chunks


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _geometry_of(fn, d: int, cache_dtype, rep: int) -> tuple[int, int]:
    """(cache positions in one K or V tile of the kernel's ring, CTAs of the
    kernel an SM holds at once), as a build's ``tony_flash_decode_geometry``
    ``fn`` reports them for the kernel these inputs launch."""
    out = (ctypes.c_int * 2)()
    _build.check("flash_decode geometry",
                 fn(d, _CACHE_DTYPES[cache_dtype], rep, out))
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def _geometry(d: int, cache_dtype, rep: int) -> tuple[int, int]:
    """``_geometry_of`` the package's own build."""
    return _geometry_of(_build.kernel("tony_flash_decode_geometry"), d,
                        cache_dtype, rep)


def _kernel_split(n_valid, heads, rep, d, cache_dtype, device_index=0,
                  geometry=None):
    """The split the wrapper launches the kernel with on a device;
    ``geometry``: (tile, CTAs an SM) of another build (a variant of
    tools/kernel_variants.py), by default the package's own."""
    tile, per_sm = geometry or _geometry(d, cache_dtype, rep)
    return _split(n_valid, heads, tile, _sm_count(device_index), per_sm)


def _decode_partial_reference(q, ck, cv, k_scale, v_scale, lo, length,
                              chunk, n_chunks, layer=None):
    """Plain version of the kernel's partials: the unnormalised softmax
    state of each ``chunk``-position piece of [lo, length] -> (part_o
    [B*kvH, n_chunks, rep, D], part_m and part_l [B*kvH, n_chunks, rep]),
    float32. A chunk's m is its largest score, l the sum of exp(s - m), o
    the sum of exp(s - m) * v_scale * v; a chunk past ``length`` is empty
    (m = NEG_INF, l = 0, o = 0)."""
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
    """Plain version of the kernel's combine: partials -> out [B*kvH, rep,
    D] in ``dtype``. Each chunk weighs exp(m_c - max m); an empty chunk
    (l = 0) adds nothing."""
    mx = part_m.amax(dim=1, keepdim=True)
    w = torch.exp(part_m - mx)                        # [BH, C, rep]
    l = (w * part_l).sum(dim=1)
    o = (w[..., None] * part_o).sum(dim=1)
    return (o / torch.where(l > 0, l, 1.0)[..., None]).to(dtype)


def _check_kernel_inputs(q, ck, cv, k_scale, v_scale, layer):
    """Raise on what the kernel does not take, the envelope first (so the
    check reads the same with or without a card)."""
    b, kvh, rep, d = q.shape
    if q.dtype not in _Q_DTYPES or d not in KERNEL_HEAD_DIMS or rep > MAX_REP:
        raise ValueError(
            f"flash_decode kernel takes q in float32/bfloat16, head_dim in "
            f"{KERNEL_HEAD_DIMS} and at most {MAX_REP} query heads per kv "
            f"head; got {q.dtype}, head_dim={d}, rep={rep}")
    want = 5 if layer is not None else 4
    if ck.dim() != want or cv.shape != ck.shape:
        raise ValueError(f"cache must be {want}-d (layer={layer}), got "
                         f"{tuple(ck.shape)} and {tuple(cv.shape)}")
    if not (ck.is_cuda and cv.is_cuda):
        raise ValueError("flash_decode: q and the cache must be on one device")
    if ck.shape[-4:-2] != (b, kvh) or ck.shape[-1] != d:
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"{tuple(ck.shape)}")
    if layer is not None and not 0 <= layer < ck.shape[0]:
        raise ValueError(f"layer {layer} outside the {ck.shape[0]}-layer "
                         "stack")
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
    if ck.data_ptr() % 16 or cv.data_ptr() % 16:
        raise ValueError("flash_decode kernel needs 16-byte-aligned cache "
                         "buffers (its 16-byte copies do)")


def _layer_base(t, layer):
    """The layer's base pointer in a stacked buffer: an offset, never a
    copy."""
    if t is None:
        return None
    off = 0 if layer is None else layer * t.stride(0) * t.element_size()
    return t.data_ptr() + off


_counters: dict = {}


def _arrival_counters(device, n: int):
    """The kernel's per-(b, kv head) arrival counters on ``device``'s current
    stream: zeros, which every launch leaves at zero (its last CTA of a head
    resets them); one buffer per stream, so launches on two streams never
    share a counter."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = _counters[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                           device=device)
    return buf


def _decode_cuda(q, ck, cv, k_scale, v_scale, lo, length, chunk, n_chunks,
                 layer, entry=None):
    """Launch csrc/flash_decode.cu over positions [lo, length] in
    ``n_chunks`` chunks of ``chunk`` -> (out [B*kvH, rep, D] in q's dtype,
    and the chunks' float32 partials part_o [B*kvH, n_chunks, rep, D],
    part_m and part_l [B*kvH, n_chunks, rep], which the launch combined
    into out). ``entry``: another build of the C entry point (a variant
    of tools/kernel_variants.py); by default the package's own."""
    global launches
    b, kvh, rep, d = q.shape
    bh = b * kvh
    # one scratch allocation for the three partials
    part = torch.empty(bh * n_chunks * rep * (d + 2), dtype=torch.float32,
                       device=q.device)
    n_o = bh * n_chunks * rep * d
    part_o = part[:n_o].view(bh, n_chunks, rep, d)
    part_m = part[n_o:n_o + bh * n_chunks * rep].view(bh, n_chunks, rep)
    part_l = part[n_o + bh * n_chunks * rep:].view(bh, n_chunks, rep)
    out = torch.empty((bh, rep, d), dtype=q.dtype, device=q.device)
    cs = ck.stride()[-4:-1]
    ss = k_scale.stride()[-3:-1] if k_scale is not None else (0, 0)
    err = (entry or _build.kernel("tony_flash_decode"))(
        q.data_ptr(), _layer_base(ck, layer), _layer_base(cv, layer),
        _layer_base(k_scale, layer), _layer_base(v_scale, layer),
        out.data_ptr(), part_o.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), _arrival_counters(q.device, bh).data_ptr(),
        b, kvh, rep, d, _Q_DTYPES[q.dtype], _CACHE_DTYPES[ck.dtype], lo,
        length, chunk, n_chunks, *cs, *ss, d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_decode", err)
    launches += 1
    return out, part_o, part_m, part_l


def _flash_decode_cuda(q, ck, cv, length, k_scale, v_scale, window, layer):
    _check_kernel_inputs(q, ck, cv, k_scale, v_scale, layer)
    q = q.contiguous()
    b, kvh, rep, d = q.shape
    m_cap = ck.shape[-2]
    if not 0 <= length < m_cap:
        raise ValueError(f"length {length} outside the cache's {m_cap} "
                         "positions")
    lo, hi = _valid_range(length, window)
    chunk, n_chunks = _kernel_split(hi - lo + 1, b * kvh, rep, d, ck.dtype,
                                    q.device.index or 0)
    out = _decode_cuda(q, ck, cv, k_scale, v_scale, lo, length, chunk,
                       n_chunks, layer)[0]
    return out.reshape(b, kvh, rep, d)


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
