"""Port parity: remat (tony_tpu_torch.models.transformer ``remat`` and
``remat_policy``), ``chunked_reference_attention`` and lm_train's
``--remat`` against the JAX package on the CPU.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``;
tokens from numpy; float32 on both sides. Loss within atol 2e-5 and
gradients within 1e-4 of JAX's (test_ops.py's tolerances). Within the
port, remat changes what the backward keeps, not what it computes, so every
policy's loss and gradients equal remat off exactly. The flash operator's
launches are counted through its plain version, which the CPU runs in the
kernel's place: under "full" and "dots" the backward runs the forward
again, under "attn" it keeps the forward's out and lse."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu.ops.attention import (
    chunked_reference_attention as j_chunked,
)
from tony_tpu_torch.examples import lm_train
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.ops import attention as A
from tony_tpu_torch.ops import chunked_reference_attention
from tony_tpu_torch.parallel.ring_attention import reference_attention
from tony_tpu_torch.train.step import _leaves

LOSS_ATOL, GRAD_ATOL = 2e-5, 1e-4
# test_models.py:128 (GQA, attn_impl "ref") and :140 (flash, MHA)
TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=64, dtype=jnp.float32, remat=True)
POLICIES = ("full", "dots", "attn")


def _flat_jax(tree, prefix=""):
    out = {}
    for name in sorted(tree):
        node = tree[name]
        if isinstance(node, dict):
            out.update(_flat_jax(node, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = np.asarray(node)
    return out


def _batch(seed, b, l, vocab):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, l), dtype=np.int32),
            rng.integers(0, vocab, (b, l), dtype=np.int32))


def _port_loss_and_grads(tree, cfg, tokens, targets):
    params = from_jax_params(tree, cfg, "cpu")
    leaves = [p.requires_grad_() for _, p in _leaves(params)]
    loss = T.loss_fn(params, torch.from_numpy(tokens).long(),
                     torch.from_numpy(targets).long(), cfg)
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()),
            {name: g.numpy() for (name, _), g in zip(_leaves(params), grads)})


@pytest.fixture(scope="module")
def flash_model():
    """test_models.py:140's model (flash, MHA) and the JAX package's loss
    and gradients under remat "full" (its "attn" equals it there)."""
    jcfg = jT.TransformerConfig(**TINY, attn_impl="flash")
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    tokens, targets = _batch(0, 2, 16, 64)
    want = {}
    for policy in ("full", "attn"):
        loss, grads = jax.value_and_grad(jT.loss_fn)(
            tree, jnp.asarray(tokens), jnp.asarray(targets),
            dataclasses.replace(jcfg, remat_policy=policy))
        want[policy] = (float(loss), _flat_jax(jax.device_get(grads)))
    return jcfg, tree, tokens, targets, want


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_loss_and_gradients_match_jax(flash_model, policy):
    """Each policy's loss and gradients against the JAX loss_fn's."""
    jcfg, tree, tokens, targets, want = flash_model
    cfg = config_from_fields(dataclasses.asdict(
        dataclasses.replace(jcfg, remat_policy=policy)))
    loss, grads = _port_loss_and_grads(tree, cfg, tokens, targets)
    want_loss, want_grads = want["attn" if policy == "attn" else "full"]
    np.testing.assert_allclose(loss, want_loss, atol=LOSS_ATOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g, want_grads[name], atol=GRAD_ATOL,
                                   err_msg=name)


def test_remat_policy_attn_matches_full(flash_model):
    """test_models.py:140's counterpart: "attn" changes what is kept, not
    what is computed. Within the port every policy equals remat off
    exactly, and the JAX package's "attn" and "full" agree as its own test
    holds them."""
    jcfg, tree, tokens, targets, want = flash_model
    np.testing.assert_allclose(want["full"][0], want["attn"][0], rtol=1e-6)
    for name, g in want["full"][1].items():
        np.testing.assert_allclose(g, want["attn"][1][name], rtol=1e-5,
                                   atol=1e-6)
    base = config_from_fields(dataclasses.asdict(jcfg))
    off = _port_loss_and_grads(tree, dataclasses.replace(base, remat=False),
                               tokens, targets)
    for policy in POLICIES:
        got = _port_loss_and_grads(
            tree, dataclasses.replace(base, remat_policy=policy), tokens,
            targets)
        assert got[0] == off[0], policy
        for name, g in got[1].items():
            np.testing.assert_array_equal(g, off[1][name], err_msg=policy)


def test_gqa_and_remat_variants():
    """test_models.py:128's counterpart (GQA with one kv head, the plain
    attention, remat "full"): finite loss and gradients, and equal to the
    JAX package's."""
    jcfg = jT.TransformerConfig(**{**TINY, "n_kv_heads": 1},
                                attn_impl="ref")
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    tokens, targets = _batch(0, 2, 16, 64)
    want_loss, want_grads = jax.value_and_grad(jT.loss_fn)(
        tree, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    loss, grads = _port_loss_and_grads(tree, cfg, tokens, targets)
    assert np.isfinite(loss)
    assert all(np.isfinite(g).all() for g in grads.values())
    np.testing.assert_allclose(loss, float(want_loss), atol=LOSS_ATOL)
    want = _flat_jax(jax.device_get(want_grads))
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name], atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("policy,forwards", [
    (None, 1), ("full", 2), ("dots", 2), ("attn", 1)])
def test_flash_forwards_a_layer_a_step(monkeypatch, flash_model, policy,
                                       forwards):
    """Flash forwards a layer in one forward and backward: "attn" keeps
    the forward's out and lse, so its backward never runs it again."""
    jcfg, tree, tokens, targets, _ = flash_model
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    cfg = dataclasses.replace(cfg, remat=policy is not None,
                              remat_policy=policy or "full")
    calls = []
    plain = A._flash_fwd_reference
    monkeypatch.setattr(A, "_flash_fwd_reference",
                        lambda *a: calls.append(1) or plain(*a))
    _port_loss_and_grads(tree, cfg, tokens, targets)
    assert len(calls) == forwards * cfg.n_layers


def test_remat_policy_rejected():
    cfg = config_from_fields(dataclasses.asdict(
        jT.TransformerConfig(**TINY, remat_policy="everything")))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    params = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="remat_policy must be"):
        T.loss_fn(params, tokens, tokens, cfg)


def test_chunked_reference_attention_matches_reference():
    """test_ops.py:274's counterpart: the blocked, checkpointed attention
    against the materialising reference (forward and gradients), and
    against the JAX package's chunked attention on the same inputs."""
    B, H, L, D = 2, 4, 512, 64
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, H, L, D), dtype=np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o1 = chunked_reference_attention(tq, tk, tv, causal=True, q_block=128)
    o2 = reference_attention(*(t.transpose(1, 2) for t in (tq, tk, tv)),
                             causal=True).transpose(1, 2)
    np.testing.assert_allclose(o1.detach().numpy(), o2.detach().numpy(),
                               rtol=2e-3, atol=2e-3)
    g1 = torch.autograd.grad(o1.sum(), (tq, tk, tv))
    g2 = torch.autograd.grad(o2.sum(), (tq, tk, tv))
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-3)
    want = j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, q_block=128)
    np.testing.assert_allclose(o1.detach().numpy(), np.asarray(want),
                               atol=LOSS_ATOL)
    with pytest.raises(ValueError, match="not divisible"):
        chunked_reference_attention(tq, tk, tv, q_block=100)


def test_lm_train_remat_policies(tmp_path):
    """lm_train --remat --remat-policy: every policy's losses equal remat
    off's, step for step (the same data, the same arithmetic)."""
    flags = ["--device", "cpu", "--steps", "3", "--batch-size", "2",
             "--seq-len", "16", "--d-model", "32", "--n-layers", "2",
             "--n-heads", "4", "--d-ff", "64", "--vocab", "64", "--dtype",
             "float32"]
    losses = {}
    for policy in (None,) + POLICIES:
        out = tmp_path / f"{policy}.json"
        extra = [] if policy is None else ["--remat", "--remat-policy",
                                           policy]
        assert lm_train.main(flags + extra + ["--metrics-out",
                                              str(out)]) == 0
        losses[policy] = json.loads(out.read_text())["losses"]
    assert len(losses[None]) == 3
    for policy in POLICIES:
        assert losses[policy] == losses[None], policy
