"""Port parity: the training slice (tony_tpu_torch.models.transformer
``loss_fn``/``token_nll``, ``train``, ``data`` and ``examples.lm_train``)
against the JAX package on the CPU.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``;
tokens come from numpy. Both sides run in float32. Loss and gradients are
held at atol 1e-4 (test_ops.py's gradient tolerance: every gradient is a
sum over all layers' float32 rounding, taken in another order in each
framework)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu_torch import train as ptrain
from tony_tpu_torch.examples import lm_train
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.train.step import _leaves

ATOL = 1e-4
TINY = dict(vocab_size=50, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=64, max_seq_len=64, dtype=jnp.float32, ce_block_v=16)


def _configs(**over):
    jcfg = jT.TransformerConfig(**{**TINY, **over})
    return jcfg, config_from_fields(dataclasses.asdict(jcfg))


def _batch(seed, b, l, vocab, pad=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, l), dtype=np.int32)
    targets = rng.integers(0, vocab, (b, l), dtype=np.int32)
    if pad:
        targets[0, -5:] = -1           # padding is masked out of the mean
    return tokens, targets


def _flat_jax(tree, prefix=""):
    """{path: numpy} of a JAX param tree, paths as in _leaves."""
    out = {}
    for name in sorted(tree):
        node = tree[name]
        if isinstance(node, dict):
            out.update(_flat_jax(node, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = np.asarray(node)
    return out


@pytest.mark.parametrize("ce_impl", ["dense", "blockwise"])
@pytest.mark.parametrize("attn_impl,over", [
    ("ref", {}),
    ("flash", {}),
    ("flash", {"n_kv_heads": 2}),                  # GQA: dk/dv sum over repeats
    ("flash", {"n_kv_heads": 1, "attn_window": 5}),
], ids=["ref", "flash", "flash_gqa", "flash_mqa_window"])
def test_loss_and_gradients_match_jax(ce_impl, attn_impl, over):
    jcfg, cfg = _configs(ce_impl=ce_impl, **over)
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    tokens, targets = _batch(1, 2, 24, jcfg.vocab_size)
    want_loss, want_grads = jax.value_and_grad(jT.loss_fn)(
        tree, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    params = from_jax_params(tree, cfg, "cpu")
    leaves = [p.requires_grad_() for _, p in _leaves(params)]
    loss = T.loss_fn(params, torch.from_numpy(tokens).long(),
                     torch.from_numpy(targets).long(), cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=ATOL)
    want = _flat_jax(want_grads)
    for (name, _), g in zip(_leaves(params), grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=ATOL,
                                   err_msg=name)


def test_token_nll_reductions_and_dispatch():
    jcfg, cfg = _configs(ce_impl="blockwise")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 32), dtype=np.float32)
    w = rng.standard_normal((32, 50), dtype=np.float32)
    _, targets = _batch(4, 2, 10, 50)
    for reduction in ("mean", "sum"):
        got = T.token_nll(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(targets).long(), cfg,
                          reduction=reduction)
        want = jT.token_nll(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(targets), jcfg, reduction=reduction)
        np.testing.assert_allclose(float(got), float(want), atol=ATOL)
    big = dataclasses.replace(cfg, ce_impl="auto", vocab_size=16384)
    assert T._use_blockwise_ce(big)
    assert not T._use_blockwise_ce(dataclasses.replace(big, vocab_size=16383))
    assert not T._use_blockwise_ce(dataclasses.replace(big, ce_impl="dense"))
    with pytest.raises(ValueError, match="ce_impl"):
        T._use_blockwise_ce(dataclasses.replace(big, ce_impl="fused"))


def _adam_state(opt_state):
    """The ScaleByAdamState inside the JAX optax chain's state."""
    for node in jax.tree.leaves(opt_state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(node, "mu"):
            return node
    raise AssertionError("no adam state")


def test_one_train_step_matches_jax():
    """One create_train_step update against the JAX bundle's, from the same
    parameters and batch: loss, grad_norm and both Adam moments everywhere.
    Parameters are compared only where |g| > 1e-4: the first Adam step is
    about lr * sign(g), so an element whose gradient is near 0 can flip sign
    with the summation order."""
    from tony_tpu.parallel.mesh import single_device_mesh
    from tony_tpu.train import create_train_step as jax_create

    jcfg, cfg = _configs(ce_impl="blockwise", n_kv_heads=2)
    jb = jax_create(jcfg, single_device_mesh())
    tree = jax.device_get(jb.params)
    tokens, targets = _batch(5, 2, 24, jcfg.vocab_size)
    _, jgrads = jax.value_and_grad(jT.loss_fn)(
        tree, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    jparams, jopt, jm = jb.step_fn(jb.params, jb.opt_state,
                                   jnp.asarray(tokens), jnp.asarray(targets))

    bundle = ptrain.create_train_step(
        cfg, device="cpu", params=from_jax_params(tree, cfg, "cpu"))
    params, opt, m = bundle.step_fn(bundle.params, bundle.opt_state,
                                    torch.from_numpy(tokens).long(),
                                    torch.from_numpy(targets).long())
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=ATOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    adam = _adam_state(jopt)
    assert opt["count"] == int(adam.count) == 1
    want_mu, want_nu = _flat_jax(adam.mu), _flat_jax(adam.nu)
    want_p, g = _flat_jax(jax.device_get(jparams)), _flat_jax(jgrads)
    for name, mu in _leaves(opt["mu"]):
        np.testing.assert_allclose(mu.numpy(), want_mu[name], atol=1e-6,
                                   err_msg=name)
    for name, nu in _leaves(opt["nu"]):
        np.testing.assert_allclose(nu.numpy(), want_nu[name], atol=1e-8,
                                   err_msg=name)
    for name, p in _leaves(params):
        big = np.abs(g[name]) > 1e-4
        assert big.mean() > 0.5, name
        np.testing.assert_allclose(p.detach().numpy()[big],
                                   want_p[name][big], atol=1e-6,
                                   err_msg=name)
    loss = bundle.eval_fn(params, torch.from_numpy(tokens).long(),
                          torch.from_numpy(targets).long())
    assert not loss.requires_grad and float(loss) < float(m["loss"])


def test_optimizer_clips_like_optax():
    """Global norm above the clip: g / norm * clip; below: g unchanged.
    grad_norm is the unclipped norm either way."""
    import optax

    for scale in (0.01, 100.0):
        p = {"a": torch.ones(3), "b": {"c": torch.full((2, 2), 2.0)}}
        g = [torch.tensor([1.0, -2.0, 3.0]) * scale,
             torch.tensor([[0.5, 0.0], [-1.0, 4.0]]) * scale]
        opt = ptrain.make_optimizer(lr=0.1)
        state = opt.init(p)
        gnorm = opt.step(p, g, state)
        jp = {"a": jnp.ones(3), "b": {"c": jnp.full((2, 2), 2.0)}}
        jg = {"a": jnp.asarray(g[0].numpy()), "b": {"c": jnp.asarray(g[1].numpy())}}
        jopt = optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(0.1, b1=0.9, b2=0.95,
                                       weight_decay=0.01))
        upd, _ = jopt.update(jg, jopt.init(jp), jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(float(gnorm), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        np.testing.assert_allclose(p["a"].numpy(), np.asarray(jp["a"]),
                                   atol=1e-6)
        np.testing.assert_allclose(p["b"]["c"].numpy(),
                                   np.asarray(jp["b"]["c"]), atol=1e-6)


def test_make_forward_and_synthetic_batches():
    _, cfg = _configs()
    params = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens, _ = _batch(6, 2, 12, cfg.vocab_size)
    tokens = torch.from_numpy(tokens).long()
    fwd = ptrain.make_forward(cfg)
    assert torch.equal(fwd(params, tokens), T.apply(params, tokens, cfg)[0])
    gen = torch.Generator().manual_seed(3)
    x, y = ptrain.synthetic_lm_batch(gen, 4, 16, 50)
    assert x.shape == y.shape == (4, 16) and x.dtype == torch.int64
    # affine mod vocab: each row steps by a constant in [1, 7)
    step = (x[:, 1:2] - x[:, :1]) % 50
    assert ((step >= 1) & (step < 7)).all()
    assert torch.equal(y, (x + step) % 50)
    x2, _ = ptrain.synthetic_lm_batch(torch.Generator().manual_seed(3), 4, 16,
                                      50)
    assert torch.equal(x, x2)


def test_loader_batches_are_byte_identical_to_jax(tmp_path):
    from tony_tpu.data import PrefetchLoader as JPrefetch
    from tony_tpu.data import ShardedBatchLoader as JLoader
    from tony_tpu.data import TokenDataset as JDataset
    from tony_tpu.data import write_tokens as jwrite
    from tony_tpu_torch.data import (
        PrefetchLoader, ShardedBatchLoader, TokenDataset, has_ttpu_magic,
        write_tokens,
    )

    toks = np.random.default_rng(8).integers(0, 1000, 5000)
    pa, pb = tmp_path / "port.bin", tmp_path / "jax.bin"
    write_tokens(pa, toks[:3000])
    write_tokens(pa, toks[3000:])               # append keeps the header
    jwrite(pb, toks[:3000])
    jwrite(pb, toks[3000:])
    assert pa.read_bytes() == pb.read_bytes() and has_ttpu_magic(pa)
    ds, jds = TokenDataset.from_bin(pa), JDataset.from_bin(pb)
    assert ds.max_token() == jds.max_token() == int(toks.max())
    for seed, start in ((0, 0), (7, 3)):
        mine = ShardedBatchLoader(ds, 4, 32, seed=seed, start_step=start)
        ref = JLoader(jds, 4, 32, seed=seed, start_step=start)
        for _ in range(2 * mine.steps_per_epoch + 1):    # across epochs
            (x, y), (jx, jy) = next(mine), next(ref)
            assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()
    train_ds, val_ds = ds.split(0.1)
    jtrain, jval = jds.split(0.1)
    a = PrefetchLoader(ShardedBatchLoader(train_ds, 2, 16, seed=1))
    b = JPrefetch(JLoader(jtrain, 2, 16, seed=1))
    for _ in range(5):
        (x, _), (jx, _) = next(a), next(b)
        assert x.tobytes() == jx.tobytes()
    assert a.state() == b.state()
    a.close()
    b.close()
    assert (ShardedBatchLoader(val_ds, 2, 16).batch_at(0)[0].tobytes()
            == JLoader(jval, 2, 16).batch_at(0)[0].tobytes())


TRAIN_FLAGS = ["--device", "cpu", "--batch-size", "2", "--seq-len", "16",
               "--d-model", "32", "--n-layers", "2", "--n-heads", "4",
               "--d-ff", "64", "--vocab", "64", "--dtype", "float32"]


def test_lm_train_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "m.json"
    rc = lm_train.main(TRAIN_FLAGS + ["--steps", "4", "--metrics-out",
                                      str(out), "--profile-dir",
                                      str(tmp_path / "prof")])
    assert rc == 0
    m = json.loads(out.read_text())
    assert {"final_loss", "steps_per_sec", "tokens_per_sec", "n_params",
            "mesh", "losses"} <= set(m)
    assert len(m["losses"]) == 4 and np.isfinite(m["losses"]).all()
    assert m["final_loss"] == m["losses"][-1]
    assert m["mesh"] == dict.fromkeys(
        ("pipe", "data", "fsdp", "seq", "expert", "tensor"), 1)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == m
    assert list((tmp_path / "prof").glob("trace.*.json"))
    # --data with a held-out eval split
    from tony_tpu_torch.data import write_tokens

    data = tmp_path / "toks.bin"
    write_tokens(data, np.random.default_rng(2).integers(0, 64, 4000))
    rc = lm_train.main(TRAIN_FLAGS + ["--steps", "3", "--data", str(data),
                                      "--eval-every", "2", "--eval-batches",
                                      "2", "--eval-frac", "0.2",
                                      "--metrics-out", str(out)])
    m = json.loads(out.read_text())
    assert rc == 0 and np.isfinite(m["eval_loss"]) and m["eval_ppl"] > 1


def test_lm_train_drains_on_preemption(tmp_path, monkeypatch):
    """The executor's preemption flag ends the run at the next step
    boundary with EXIT_PREEMPTED; the step log gets the JSONL records."""
    from tony_tpu_torch.constants import EXIT_PREEMPTED

    log = tmp_path / "steps.jsonl"
    monkeypatch.setenv("TONY_STEP_LOG", str(log))
    (tmp_path / "steps.jsonl.preempt").write_text("{}")
    assert lm_train.main(TRAIN_FLAGS + ["--steps", "5"]) == EXIT_PREEMPTED
    assert not (tmp_path / "steps.jsonl.preempt").exists()


def test_step_timer_records(tmp_path):
    from tony_tpu_torch.train.profiling import StepTimer

    log = tmp_path / "steps.jsonl"
    timer = StepTimer(log, window=2)
    for i in range(6):
        timer.tick(train_step=i)
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [2, 4, 6]
    assert set(recs[0]) == {"step", "mean_step_s", "steps_per_sec", "p50_s",
                            "p99_s", "ts", "train_step", "kernel_builds",
                            "kernel_build_time_s", "kernel_builds_post_warm"}
    assert recs[-1]["train_step"] == 5 and timer.steps_per_sec > 0


@pytest.mark.parametrize("flags,what", [
    (["--mesh", "expert=1,pipe=2,data=1"], "axis product 2 != device count 1"),
    (["--mesh", "expert=2,data=1"], "axis product 2 != device count 1"),
])
def test_lm_train_flags_not_yet_ported(flags, what):
    """A pipe or expert axis is ported now: lm_train takes the mesh and
    refuses it only for its size (two ranks in one process); it runs on a
    job's ranks (tests/test_torch_expert_mesh.py)."""
    with pytest.raises(SystemExit, match=what):
        lm_train.main(TRAIN_FLAGS + flags)


def test_bootstrap_single_process_only(monkeypatch):
    monkeypatch.setenv("TONY_NUM_PROCESSES", "1")
    monkeypatch.setenv("TONY_PROCESS_ID", "0")
    info = ptrain.init()
    assert info["num_processes"] == 1 and info["num_devices"] >= 1
    monkeypatch.setenv("TONY_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="no rendezvous"):
        ptrain.init()
    monkeypatch.setenv("TONY_JOB_NAME", "worker")
    monkeypatch.setenv("TONY_TASK_INDEX", "3")
    monkeypatch.setenv("TONY_IS_CHIEF", "true")
    t = ptrain.task_info()
    assert (t["job_name"], t["task_index"], t["is_chief"]) == ("worker", 3,
                                                               True)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ptrain.create_train_step(T.TransformerConfig(), {"data": 2},
                                 device="cpu")
    from tony_tpu_torch.parallel import mesh_from_string, parse_mesh

    assert parse_mesh("fsdp=-1,tensor=1").resolve(1)["fsdp"] == 1
    with pytest.raises(ValueError, match="unknown mesh axis"):
        parse_mesh("model=2")
    with pytest.raises(RuntimeError, match="process group"):
        mesh_from_string("data=2")


def test_training_entry_points_need_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_train.main(TRAIN_FLAGS[2:] + ["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.create_train_step(T.TransformerConfig(d_model=16, n_heads=2,
                                                     n_layers=1, vocab_size=32))
