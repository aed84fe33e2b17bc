"""Pipeline schedules of the port (parallel/pipeline.py,
train/pipeline_step.py) on gloo processes, one launch of four ranks,
held against the JAX package's on forced host devices from the same
parameters (converted with from_jax_params), at float32: the counterparts
of tests/test_parallel.py:336 (make_pipeline against the sequential
stack), :363 (one stage), :373 (circular at M = 4 and 8), :421 (1F1B's
loss and gradients) and tests/test_models.py:211 (the pipelined
transformer), :238 (1F1B equals GPipe with uneven pads), :282 (circular),
:309 (1F1B at bf16) and :329 (MoE's aux loss in every schedule). Then
port-only: the schedules' errors, and the replayed ranks' groups."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu.parallel import MeshSpec, build_mesh
from tony_tpu.parallel.pipeline import (
    make_pipeline as jax_make_pipeline,
    make_pipeline_1f1b as jax_make_1f1b,
    make_pipeline_circular as jax_make_circular,
    stack_stage_params as jax_stack,
)
from tony_tpu.train import synthetic_lm_batch
from tony_tpu.train.pipeline_step import (
    create_pipeline_train_step as jax_pipeline_step,
)
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from torch_dist_worker import in_background, run_ranks

D, WORLD = 16, 4
CFG = jT.TransformerConfig(vocab_size=128, d_model=64, n_layers=4, n_heads=4,
                           n_kv_heads=4, d_ff=128, dtype=jnp.float32,
                           attn_impl="ref")
MOE = dataclasses.replace(CFG, d_ff=64, n_experts=4, expert_top_k=2,
                          capacity_factor=2.0, aux_loss_weight=0.05)
BF16 = dataclasses.replace(CFG, dtype=jnp.bfloat16)
# the JAX bundles' steps held against the port's (the port trains 8)
JAX_STEPS = 3


def _fields(cfg):
    name = "bfloat16" if cfg.dtype == jnp.bfloat16 else "float32"
    return {**dataclasses.asdict(cfg), "dtype": name,
            "param_dtype": "float32"}


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _tanh(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_stack_fn(stack, x):
    def body(c, lp):
        y = jnp.tanh(c @ lp["w"] + lp["b"])
        return y, jnp.sum(y * y)

    y, auxes = jax.lax.scan(body, x, stack)
    return y, jnp.sum(auxes).astype(jnp.float32)


def _jax_schedule_params():
    """The JAX tests' parameters and batches (test_parallel.py:336-480)."""
    key = jax.random.PRNGKey(0)
    per_stage = []
    for _ in range(4):
        k1, k2, key = jax.random.split(key, 3)
        per_stage.append({"w": jax.random.normal(k1, (D, D)) * 0.3,
                          "b": jax.random.normal(k2, (D,)) * 0.1})
    out = {"per_stage": per_stage, "stacked": jax_stack(per_stage),
           "batch": jax.random.normal(key, (8, D))}
    ks = jax.random.split(jax.random.PRNGKey(3), 17)
    out["circ"] = {"w": jnp.stack([jax.random.normal(ks[i], (D, D)) * 0.3
                                   for i in range(8)]),
                   "b": jnp.stack([jax.random.normal(ks[8 + i], (D,)) * 0.1
                                   for i in range(8)])}
    out["circ_batch"] = {m: jax.random.normal(ks[-1], (3 * m, D))
                         for m in (4, 8)}
    ks = jax.random.split(jax.random.PRNGKey(1), 11)
    out["f_stack"] = {"w": jnp.stack([jax.random.normal(ks[i], (D, D)) * 0.3
                                      for i in range(4)]),
                      "b": jnp.stack([jax.random.normal(ks[4 + i], (D,)) * 0.1
                                      for i in range(4)])}
    out["hp"] = {"wo": jax.random.normal(ks[-3], (D, D)) * 0.2}
    out["fb"] = jax.random.normal(ks[-2], (16, D))
    out["ft"] = jax.random.normal(ks[-1], (16, D))
    return out


def _schedule_inputs():
    """The port's copies of ``_jax_schedule_params``."""
    j = _jax_schedule_params()
    return {"jax": j,
            "gpipe": {"stacked": {k: _t(v) for k, v in j["stacked"].items()},
                      "batch": _t(j["batch"])},
            "circular": {m: {"stacked": {k: _t(v) for k, v in
                                         j["circ"].items()},
                             "batch": _t(b)}
                         for m, b in j["circ_batch"].items()},
            "1f1b": {"stacked": {k: _t(v) for k, v in j["f_stack"].items()},
                     "hp": {"wo": _t(j["hp"]["wo"])}, "batch": _t(j["fb"]),
                     "targets": _t(j["ft"]), "aux_w": 0.01}}


def _schedule_refs(mesh, j):
    """The JAX schedules' results on ``_jax_schedule_params``'s ``j``."""
    want = {"gpipe": np.asarray(jax.jit(jax_make_pipeline(
        mesh, _tanh, num_microbatches=4))(j["stacked"], j["batch"]))}
    seq = j["batch"]
    for p in j["per_stage"]:
        seq = _tanh(p, seq)
    want["sequential"] = np.asarray(seq)
    for m, cb in j["circ_batch"].items():
        fn = jax.jit(jax_make_circular(mesh, lambda s, x: _jax_stack_fn(
            s, x)[0], num_microbatches=m, num_chunks=2))
        grads = jax.grad(lambda p: jnp.sum(fn(p, cb) ** 2))(j["circ"])
        want[f"circular{m}"] = {"out": np.asarray(fn(j["circ"], cb)),
                                "grads": jax.device_get(grads)}
    fn = jax.jit(jax_make_1f1b(
        mesh, _jax_stack_fn, lambda hp, y, t: jnp.mean((y @ hp["wo"] - t) ** 2),
        num_microbatches=8, aux_weight=0.01))
    loss, ds, dh, dx = fn(j["f_stack"], j["hp"], j["fb"], j["ft"])
    want["1f1b"] = {"loss": float(loss), "ds": jax.device_get(ds),
                    "dh": jax.device_get(dh), "dx": np.asarray(dx)}
    return want


def _jax_steps(cfg, mesh, schedule, tokens, targets, steps, chunks=2, m=4):
    """A JAX pipelined bundle: its loss and each step's loss. (Parameters
    after a step are held between the port's own schedules: AdamW's first
    update lr·g/(|g|+eps) turns float32 noise in a near-zero gradient into
    up to lr apart, so across the packages the step's losses carry the
    check.)"""
    b = jax_pipeline_step(cfg, mesh, m, schedule=schedule, num_chunks=chunks)
    out = {"loss": float(b.loss_fn(b.params, tokens, targets)), "losses": []}
    params, opt = b.params, b.opt_state
    for _ in range(steps):
        params, opt, met = b.step_fn(params, opt, tokens, targets)
        out["losses"].append(float(met["loss"]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of four gloo ranks running the port's side of every test,
    while this process computes the JAX references."""
    mesh = build_mesh(MeshSpec(pipe=4, fsdp=2))
    mesh2 = build_mesh(MeshSpec(pipe=2, fsdp=4))
    fn_inp = _schedule_inputs()
    jax_in = fn_inp.pop("jax")

    tokens, targets = synthetic_lm_batch(jax.random.PRNGKey(0), 8, 16, 128)
    uneven = targets.at[0, :10].set(-1).at[1, :4].set(-1)
    params = jT.init(jax.random.PRNGKey(0), CFG)
    moe_tok, moe_tgt = synthetic_lm_batch(jax.random.PRNGKey(2), 8, 16, 128)
    moe_params = jT.init(jax.random.PRNGKey(0), MOE)

    def case(cfg, p, desc, schedule, tok, tgt, steps, chunks=2):
        port_cfg = config_from_fields(_fields(cfg))
        return {"cfg": _fields(cfg), "mesh": desc, "schedule": schedule,
                "chunks": chunks, "m": 4, "steps": steps,
                "params": from_jax_params(jax.device_get(p), port_cfg,
                                          "cpu"),
                "tokens": _t(tok, torch.long), "targets": _t(tgt, torch.long)}

    cases = {
        "gpipe_tf": case(CFG, params, "pipe=4", "gpipe", tokens, targets, 8),
        "gpipe_uneven": case(CFG, params, "pipe=4", "gpipe", tokens, uneven,
                             1),
        "1f1b_tf": case(CFG, params, "pipe=4", "1f1b", tokens, uneven, 6),
        "circular_tf": case(CFG, params, "pipe=2,data=2", "circular",
                            tokens, targets, 8),
        "bf16": case(BF16, jT.init(jax.random.PRNGKey(0), BF16), "pipe=4",
                     "1f1b", *synthetic_lm_batch(jax.random.PRNGKey(1), 8,
                                                 16, 128), 1),
    }
    for sched, desc in (("gpipe", "pipe=4"), ("1f1b", "pipe=4"),
                        ("circular", "pipe=2,data=2")):
        cases[f"moe_{sched}"] = case(MOE, moe_params, desc, sched, moe_tok,
                                     moe_tgt, 1)
    ranks = in_background(lambda: run_ranks("multi", WORLD, {"tasks": {
        "fns": ("pipeline_fns", fn_inp),
        "steps": ("pipeline_step", {"cases": cases})}},
        tmp_path_factory.mktemp("pipeline"), timeout=240))

    want = _schedule_refs(mesh, jax_in)
    want["unpipelined"] = float(jT.loss_fn(params, tokens, targets, CFG))
    want["gpipe_tf"] = _jax_steps(CFG, mesh, "gpipe", tokens, targets,
                                  JAX_STEPS)
    want["1f1b_tf"] = _jax_steps(CFG, mesh, "1f1b", tokens, uneven,
                                 JAX_STEPS)
    want["circular_tf"] = _jax_steps(CFG, mesh2, "circular", tokens,
                                     targets, JAX_STEPS)
    mt, my = moe_tok.reshape(4, -1, 16), moe_tgt.reshape(4, -1, 16)
    full = jax.jit(lambda p, t, y: jT.loss_fn(p, t, y, MOE))
    ce = jax.jit(lambda p, t, y: jT.token_nll(
        jT.apply_hidden(p, t, MOE)[0], p["unembed"], y, MOE))
    want["moe_ref"] = float(np.mean([float(full(moe_params, mt[i], my[i]))
                                     for i in range(4)]))
    want["moe_ce"] = float(np.mean([float(ce(moe_params, mt[i], my[i]))
                                    for i in range(4)]))
    return want, ranks()


def test_pipeline_matches_sequential(runs):
    want, ranks = runs
    for r in ranks:
        got = r["fns"]["gpipe"].numpy()
        np.testing.assert_allclose(got, want["sequential"], atol=1e-5)
        np.testing.assert_allclose(got, want["gpipe"], atol=1e-5)


def test_pipeline_single_stage_degenerates(runs):
    _, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["fns"]["single"].numpy(),
                                   3.0 * np.ones((4, 2)))


@pytest.mark.parametrize("m", [4, 8])
def test_pipeline_circular_matches_sequential(runs, m):
    """Forward equals the JAX schedule (and so the sequential stack), and
    the gradients, summed over the stages that each hold their chunks,
    equal the JAX gradients and reach every layer."""
    want, ranks = runs
    w = want[f"circular{m}"]
    for r in ranks:
        np.testing.assert_allclose(r["fns"][f"circular{m}"]["out"].numpy(),
                                   w["out"], atol=1e-5)
    for name in ("w", "b"):
        total = sum(r["fns"][f"circular{m}"]["grads"][name] for r in ranks)
        np.testing.assert_allclose(total.numpy(), w["grads"][name],
                                   atol=1e-4)
        per_layer = np.abs(total.numpy()).reshape(8, -1).max(axis=1)
        assert (per_layer > 0).all(), per_layer


def test_pipeline_1f1b_loss_and_grads_match_autodiff(runs):
    want, ranks = runs
    w = want["1f1b"]
    for rank, r in enumerate(ranks):
        got = r["fns"]["1f1b"]
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-5)
        for name in ("w", "b"):
            np.testing.assert_allclose(got["ds"][name].numpy(),
                                       w["ds"][name][rank:rank + 1],
                                       atol=2e-5)
        np.testing.assert_allclose(got["dh"]["wo"].numpy(), w["dh"]["wo"],
                                   atol=2e-5)
        np.testing.assert_allclose(got["dx"].numpy(), w["dx"], atol=2e-5)


def test_pipeline_transformer_matches_and_trains(runs):
    """GPipe on pipe=4: the loss is the unpipelined model's and the JAX
    pipeline's; eight steps' losses are the JAX pipeline's and fall."""
    want, ranks = runs
    for r in ranks:
        got = r["steps"]["gpipe_tf"]
        np.testing.assert_allclose(got["loss"], want["unpipelined"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["loss"], want["gpipe_tf"]["loss"],
                                   rtol=1e-5)
        losses = [m[0] for m in got["metrics"]]
        np.testing.assert_allclose(losses[:JAX_STEPS],
                                   want["gpipe_tf"]["losses"], atol=2e-5)
        assert losses[-1] < losses[0] - 0.05, losses


def test_pipeline_1f1b_transformer_matches_gpipe(runs):
    """1F1B against GPipe with pads spread unevenly over the microbatches:
    the same loss (rtol 1e-5) and, after one step from the same
    parameters, the same parameters (atol 3e-5); and 1F1B trains, its
    losses the JAX schedule's."""
    want, ranks = runs
    for r in ranks:
        f, g = r["steps"]["1f1b_tf"], r["steps"]["gpipe_uneven"]
        np.testing.assert_allclose(f["loss"], g["loss"], rtol=1e-5)
        np.testing.assert_allclose(f["metrics"][0][0], g["metrics"][0][0],
                                   rtol=1e-5)
        for name in ("embed", "final_norm", "unembed"):
            np.testing.assert_allclose(f["params"][name].numpy(),
                                       g["params"][name].numpy(), atol=3e-5)
        for name in f["params"]["layers"]:
            np.testing.assert_allclose(f["params"]["layers"][name].numpy(),
                                       g["params"]["layers"][name].numpy(),
                                       atol=3e-5)
        losses = [m[0] for m in f["metrics"]]
        np.testing.assert_allclose(losses[:JAX_STEPS],
                                   want["1f1b_tf"]["losses"], atol=2e-5)
        assert losses[-1] < losses[0] - 0.05, losses


def test_pipeline_circular_transformer_matches_gpipe(runs):
    """Circular at S = 2, V = 2 (a pipe=2 mesh whose other axis
    replicates): GPipe's loss, the JAX schedule's step losses, and it
    trains."""
    want, ranks = runs
    for r in ranks:
        got = r["steps"]["circular_tf"]
        np.testing.assert_allclose(got["loss"], want["unpipelined"],
                                   rtol=1e-5)
        losses = [m[0] for m in got["metrics"]]
        np.testing.assert_allclose(losses[:JAX_STEPS],
                                   want["circular_tf"]["losses"], atol=2e-5)
        assert losses[-1] < losses[0] - 0.05, losses


def test_pipeline_1f1b_bfloat16_activations(runs):
    _, ranks = runs
    for r in ranks:
        loss, gnorm = r["steps"]["bf16"]["metrics"][0]
        assert np.isfinite(loss) and np.isfinite(gnorm)


def test_pipeline_moe_aux_survives_all_schedules(runs):
    """PP x MoE: the load-balancing aux loss is accumulated in every
    schedule (loss > plain CE), equal to the per-microbatch forward of the
    same parameters in the JAX package (routing is per microbatch under
    pipelining), and a step stays finite."""
    want, ranks = runs
    assert want["moe_ref"] > want["moe_ce"]
    for r in ranks:
        for sched in ("gpipe", "1f1b", "circular"):
            got = r["steps"][f"moe_{sched}"]
            np.testing.assert_allclose(got["loss"], want["moe_ref"],
                                       rtol=1e-5, err_msg=sched)
            assert np.isfinite(got["metrics"][0][0]), sched


# ------------------------------------------------------------- port-only

def _replayed(n, fn, shape=None):
    from tony_tpu_torch.parallel.collectives import ReplayWorld
    from tony_tpu_torch.parallel.tp_replay import ReplayMesh

    world = ReplayWorld(n)
    return world.run(lambda r: fn(ReplayMesh(world, r,
                                             shape or {"pipe": n})))


def test_pipeline_errors_match_the_jax_package():
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.parallel import (
        make_pipeline_1f1b, make_pipeline_circular, make_pipeline_stacked,
    )
    from tony_tpu_torch.train.pipeline_step import create_pipeline_train_step

    def fn(p, x):
        return x

    def rank(mesh):
        errors = []
        for call in (
                lambda: make_pipeline_stacked(mesh, fn, 3)({}, torch.ones(4)),
                lambda: make_pipeline_circular(mesh, fn, 3, 2)(
                    {"w": torch.ones(4)}, torch.ones(3, 1)),
                lambda: make_pipeline_circular(mesh, fn, 2, 3)(
                    {"w": torch.ones(4)}, torch.ones(2, 1)),
                lambda: make_pipeline_1f1b(mesh, fn, fn, 3)(
                    {}, {}, torch.ones(4), torch.ones(4)),
                lambda: create_pipeline_train_step(
                    T.TransformerConfig(n_layers=3), mesh, 2, device="cpu"),
                lambda: create_pipeline_train_step(
                    T.TransformerConfig(n_layers=4), mesh, 2,
                    schedule="zigzag", device="cpu")):
            try:
                call()
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        return errors

    for errors in _replayed(2, rank):
        assert "not divisible by 3 microbatches" in errors[0]
        assert "divisible by pipeline stages (2)" in errors[1]
        assert "not divisible by stages*chunks 6" in errors[2]
        assert "not divisible by 3 microbatches" in errors[3]
        assert "not divisible by pipe=2" in errors[4]
        assert "unknown pipeline schedule 'zigzag'" in errors[5]


def test_replayed_pipeline_step_equals_one_device():
    """The three schedules with their stages replayed in one process
    (collectives.ReplayWorld, as the card replays them): loss, grad norm
    and parameters after one step are the one-device step's."""
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.train import step as ST
    from tony_tpu_torch.train.pipeline_step import (
        create_pipeline_train_step, stage_layers,
    )

    cfg = T.TransformerConfig(vocab_size=64, d_model=32, n_layers=4,
                              n_heads=4, n_kv_heads=4, d_ff=64,
                              dtype=torch.float32)
    params = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tok, tgt = (x.clone() for x in ST.synthetic_lm_batch(
        torch.Generator().manual_seed(1), 8, 16, 64))
    tgt[0, :9] = -1

    def copy(t):
        return {k: copy(v) if isinstance(v, dict) else v.clone()
                for k, v in t.items()}

    one = ST.create_train_step(cfg, device="cpu", params=copy(params))
    p1, _, m1 = one.step_fn(one.params, one.opt_state, tok, tgt)
    for schedule, s in (("gpipe", 2), ("1f1b", 4), ("circular", 2)):
        def rank(mesh):
            b = create_pipeline_train_step(cfg, mesh, 4, schedule=schedule,
                                           device="cpu", params=copy(params))
            p, _, m = b.step_fn(b.params, b.opt_state, tok, tgt)
            return m, p

        for stage, (m, p) in enumerate(_replayed(s, rank)):
            np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                                       rtol=1e-6)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(m1["grad_norm"]), rtol=1e-5)
            want = stage_layers(p1["layers"], s, stage, schedule)
            for name, w in want.items():
                torch.testing.assert_close(p["layers"][name], w, atol=1e-6,
                                           rtol=0)
            torch.testing.assert_close(p["embed"], p1["embed"].detach(),
                                       atol=1e-6, rtol=0)


def test_replay_world_groups_and_deadlock():
    """ReplayWorld's subgroups: on a 2 x 2 replayed mesh each axis's
    groups sum their own ranks, ring shifts go to the next rank of the
    group, and a collective no peer joins raises instead of hanging."""
    from tony_tpu_torch.parallel.collectives import (
        ReplayWorld, Ring, all_reduce_,
    )

    def rank(mesh):
        r = mesh.rank
        out = {}
        for axis in ("data", "tensor"):
            x = torch.tensor([float(r)])
            out[axis] = float(all_reduce_(x, mesh.get_group(axis))[0])
        (got,) = Ring(mesh.get_group("tensor")).shift(
            (torch.tensor([r]),))
        out["shift"] = int(got[0])
        return out

    res = _replayed(4, rank, {"data": 2, "tensor": 2})
    assert [o["tensor"] for o in res] == [1, 1, 5, 5]
    assert [o["data"] for o in res] == [2, 4, 2, 4]
    assert [o["shift"] for o in res] == [1, 0, 3, 2]

    world = ReplayWorld(2)
    group = world.group((0, 1))

    def lonely(r):
        if r == 0:
            all_reduce_(torch.ones(1), group)
        return r

    with pytest.raises(RuntimeError, match="deadlock"):
        world.run(lonely)


def test_kernel_strides_ignore_size_one_dimensions():
    """A microbatch of one row's gradient can carry a batch stride of 1
    (a size-1 dimension's stride is arbitrary): the flash kernels are
    passed 0 there, so the tensor meets their 16-byte stride rule without
    a copy (the card's replay of circular S = 4, M = 8 met such a dO)."""
    from tony_tpu_torch.ops.attention import _aligned16, _kstrides

    base = torch.zeros(8 * 2048 * 128 + 8, dtype=torch.bfloat16)
    g = base.as_strided((1, 8, 2048, 128), (1, 128, 1024, 1))
    assert _kstrides(g) == [0, 128, 1024]
    assert _aligned16(g)
    odd = base.as_strided((2, 8, 2048, 128), (1, 128, 1024, 1))
    assert not _aligned16(odd)
