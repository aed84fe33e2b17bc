"""Speculative decoding: a small draft model proposes, the target verifies
(port of the JAX package's models/speculative.py, greedy and batch 1).

A decode step streams the whole weight set to produce one token.
Speculative decoding turns target decode steps into one wider verify
forward: the draft proposes ``gamma`` tokens (gamma cheap steps), the
target runs ONE forward over all gamma+1 positions, and the longest prefix
of draft tokens that matches the target's own greedy choices is accepted,
plus one correction (or bonus) token from the target itself.

**Exactness**: every emitted token is the target's greedy argmax given its
prefix, so the output equals greedy ``generate`` for any draft model; a
poor draft costs speed, never correctness.

- **Rollback is a length.** Cache entries beyond ``cache.length`` are
  invisible (attention masks by position), so rejecting a draft suffix
  resets the length; the next round overwrites the stale entries before
  any query can read them.
- **The kernels.** Both prefills run the model's own attention dispatch
  (the flash forward kernel on CUDA); every draft step is a lockstep
  single-token decode, which the decode gate sends to the flash-decode
  kernel; the verify forward (gamma+1 new positions into a non-empty
  cache) takes the einsum path, as in the JAX package.
- **One host read a round.** The JAX package keeps the round loop on the
  device (``lax.while_loop``). Here the decode kernel takes the cache
  length as a host int, so each round reads its accepted count (and,
  with ``stop_tokens``, whether an accepted emission stopped) in one
  transfer, which sets the next round's lengths. With ``stop_tokens``
  the first token is read once too, as the JAX loop's entry test reads
  it. That is the only wait for the card on this batch-1 latency path.

Scope: greedy (temperature 0), batch 1. Throughput serving at larger
batch uses ``generate`` or the ``SlotServer`` (whose speculative rounds
run every slot at once, models/serving.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .generate import (
    DecodeWeights,
    _forward_with_cache,
    init_cache,
    moe_dropfree,
    prepare_decode,
)
from .transformer import TransformerConfig


def _validate(cfg, draft_cfg, batch: int, gamma: int, max_new_tokens: int):
    if batch != 1:
        raise ValueError(
            "speculative_generate is batch-1 (a latency optimization; "
            f"got batch {batch}). Use generate() for batched throughput "
            "serving.")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(
            f"draft and target must share a vocabulary "
            f"({draft_cfg.vocab_size} != {cfg.vocab_size})")
    if not cfg.causal or not draft_cfg.causal:
        raise ValueError("speculative decode requires causal models")


@torch.no_grad()
def speculative_generate(params, cfg: TransformerConfig, draft_params,
                         draft_cfg: TransformerConfig, prompt: torch.Tensor,
                         max_new_tokens: int, *, gamma: int = 4,
                         kv_dtype: str = "native", stop_tokens: tuple = (),
                         pad_id: int = 0, return_stats: bool = False):
    """Greedy speculative decode -> [1, max_new_tokens] int32 on the
    prompt's device, identical to ``generate(params, cfg, prompt,
    max_new_tokens)`` for any draft model.

    ``stop_tokens``/``pad_id`` give ``generate``'s EOS semantics: the first
    emitted stop token is kept, everything after it is ``pad_id``, and the
    round loop exits as soon as an accepted emission stops.

    ``params``/``draft_params`` may be raw parameter dicts or
    ``DecodeWeights`` from ``prepare_decode``. ``gamma`` drafts a round.

    ``return_stats=True`` also returns {"rounds", "drafted", "accepted",
    "acceptance_rate", "delivered"}: rounds is the number of target verify
    forwards (target forwards = rounds + 1 with the prefill);
    accepted/acceptance_rate count emissions before truncation (the draft's
    true agreement; the last round can accept past max_new_tokens or a
    stop); ``delivered`` is the tokens in the output, through the stop
    token when ``stop_tokens`` is set, else min(produced,
    max_new_tokens)."""
    _validate(cfg, draft_cfg, prompt.shape[0], gamma, max_new_tokens)
    cfg, draft_cfg = moe_dropfree(cfg), moe_dropfree(draft_cfg)
    t = (params if isinstance(params, DecodeWeights)
         else prepare_decode(params, cfg))
    d = (draft_params if isinstance(draft_params, DecodeWeights)
         else prepare_decode(draft_params, draft_cfg))
    device = prompt.device
    lp = prompt.shape[1]
    cap = lp + max_new_tokens + gamma + 1      # the worst-case overshoot
    tc = init_cache(cfg, 1, cap, kv_dtype, device)
    dc = init_cache(draft_cfg, 1, cap, kv_dtype, device)

    # prefill both; the target's last-position logits give the first token
    logits, tc = _forward_with_cache(t.params, cfg, prompt, tc, t.fused,
                                     prefill=True)
    _, dc = _forward_with_cache(d.params, draft_cfg, prompt, dc, d.fused,
                                prefill=True)
    tok = logits.argmax(dim=-1).to(torch.int32)                 # [1]
    out = torch.zeros((1, max_new_tokens + gamma + 1), dtype=torch.int32,
                      device=device)
    out[:, 0] = tok
    stops = torch.tensor([int(s) for s in stop_tokens], dtype=torch.int32,
                         device=device)
    idx = torch.arange(gamma + 1, device=device)[None, :]
    zero = torch.zeros((1, 1), dtype=torch.int32, device=device)
    produced, rounds = 1, 0
    stop_seen = bool(stop_tokens) and bool(torch.isin(tok, stops).any())
    while produced < max_new_tokens and not stop_seen:
        # the draft proposes gamma tokens in gamma+1 steps: the extra step
        # ingests the last proposal, so the draft cache stays one ahead
        # for the all-accept case (its output is discarded)
        fed = [tok]
        for _ in range(gamma + 1):
            lg, dc = _forward_with_cache(d.params, draft_cfg, fed[-1][:, None],
                                         dc, d.fused)
            fed.append(lg.argmax(dim=-1).to(torch.int32))
        drafted = torch.stack(fed[1:gamma + 1], dim=1)          # [1, gamma]

        # the target verifies all gamma+1 positions in one forward
        t_old = tc.length
        lg_all, tc = _forward_with_cache(
            t.params, cfg, torch.cat([tok[:, None], drafted], dim=1), tc,
            t.fused, all_logits=True)
        pred = lg_all.argmax(dim=-1).to(torch.int32)            # [1, g+1]
        # the longest matching prefix: n_acc in [0, gamma]
        n_acc = torch.cumprod((drafted == pred[:, :gamma]).to(torch.int32),
                              dim=1).sum(dim=1)
        correction = pred.gather(1, n_acc[:, None].long())      # [1, 1]
        cand = torch.where(idx == n_acc[:, None], correction,
                           torch.cat([drafted, zero], dim=1))
        out[:, produced:produced + gamma + 1] = cand
        if stop_tokens:
            # did an accepted emission (cand positions 0..n_acc) stop?
            hit = (torch.isin(cand, stops) & (idx <= n_acc[:, None])).any()
            n, stopped = torch.stack([n_acc[0], hit.to(n_acc.dtype)]).tolist()
            stop_seen = bool(stopped)
        else:
            n = int(n_acc[0])
        # roll both caches back to prompt + emitted[:-1]: a length write
        tc = dataclasses.replace(tc, length=t_old + n + 1)
        dc = dataclasses.replace(dc, length=t_old + n + 1)
        tok = correction[:, 0]
        produced += n + 1
        rounds += 1
    out = out[:, :max_new_tokens]
    if stop_tokens:
        # pad strictly after the first stop (the stop token itself stays)
        hit = torch.isin(out, stops).to(torch.int32)
        after = torch.cumsum(hit, dim=1) - hit
        out = torch.where(after > 0, torch.full_like(out, int(pad_id)), out)
    if not return_stats:
        return out
    accepted = produced - 1 - rounds        # t0 + per-round (n_acc + 1)
    drafted_n = rounds * gamma
    if stop_tokens:
        row = out[0].cpu().numpy()
        hits = np.nonzero(np.isin(row, list(stop_tokens)))[0]
        delivered = int(hits[0]) + 1 if hits.size else row.shape[0]
    else:
        delivered = min(produced, max_new_tokens)
    return out, {
        "rounds": rounds,
        "drafted": drafted_n,
        "accepted": accepted,
        "acceptance_rate": accepted / drafted_n if drafted_n else 0.0,
        "delivered": delivered,
    }


__all__ = ["speculative_generate"]
