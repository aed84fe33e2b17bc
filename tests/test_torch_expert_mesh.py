"""Mixture-of-Experts on a mesh in the port (parallel/expert.py with a
``Plan``: the experts over the ``expert`` axis, the routing and the
load-balancing loss the global batch's) on gloo processes, held against
the JAX package on forced host devices from the same parameters
(converted with from_jax_params), at float32: the counterparts of
tests/test_parallel.py:536 (the expert-sharded ``moe_ffn``) and
tests/test_models.py:107 (the MoE step on ``data=2,expert=2``: three
steps' losses and gradient norms), plus ``data=2`` alone at capacity
factor 1.25 (tokens dropped, so the global routing shows) and MoE under
``seq=2``; :804 (MoE ``generate`` on ``data=2,tensor=2`` and
``expert=2,tensor=2``). Port-only: the MoE ``SlotServer(mesh=)`` on the
ring and paged engines against the meshless engine, and ``lm_train
--mesh expert=2 --n-experts 4`` as a two-process job against one
process."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu.models.generate import generate as jax_generate
from tony_tpu.parallel import (
    DP_RULES, EP_RULES, FSDP_TP_RULES, TP_DECODE_RULES, MeshSpec, build_mesh,
    merge_rules, mesh_from_string,
)
from tony_tpu.parallel.expert import moe_ffn as jax_moe_ffn
from tony_tpu.train import create_train_step as jax_create
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from torch_dist_worker import in_background, run_ranks

LOSS_ATOL, NORM_ATOL = 2e-5, 1e-4
MOE = jT.TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                           n_kv_heads=4, d_ff=64, max_seq_len=16,
                           n_experts=4, expert_top_k=2, capacity_factor=2.0,
                           dtype=jnp.float32)
DROPS = dataclasses.replace(MOE, capacity_factor=1.25)
DEC = jT.TransformerConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, d_ff=128, max_seq_len=64,
                           n_experts=4, expert_top_k=2, capacity_factor=2.0,
                           dtype=jnp.float32)
BATCH, SEQ, STEPS = 4, 16, 3
RING = dict(slots=4, max_len=64, block_size=4, prefill_chunk=8)
# (name, cfg, mesh, world, rules, sp_impl)
STEP_MESHES = [
    ("data2_expert2", MOE, "data=2,expert=2", 4,
     merge_rules(DP_RULES, EP_RULES), None),
    ("data2_drops", DROPS, "data=2", 2,
     merge_rules(FSDP_TP_RULES, EP_RULES), None),
    ("seq2", DROPS, "seq=2", 2, merge_rules(DP_RULES, EP_RULES), "ring"),
]


def _fields(cfg):
    return {**dataclasses.asdict(cfg), "dtype": "float32",
            "param_dtype": "float32"}


def _port(cfg, tree):
    return from_jax_params(jax.device_get(tree),
                           config_from_fields(_fields(cfg)), "cpu")


def _batches():
    rng = np.random.default_rng(21)
    return [(rng.integers(0, MOE.vocab_size, (BATCH, SEQ), dtype=np.int32),
             rng.integers(0, MOE.vocab_size, (BATCH, SEQ), dtype=np.int32))
            for _ in range(STEPS)]


def _rank_order(x, pc):
    """The global batch as the ranks hold it: rank i takes rows i::pc
    (data/loader.py), and the global order is the ranks' blocks in rank
    order (the JAX package's multi-process arrays)."""
    return np.concatenate([x[i::pc] for i in range(pc)])


def _jax_steps(cfg, desc, world, rules, sp):
    mesh = mesh_from_string(desc, devices=jax.devices()[:world])
    jb = jax_create(cfg, mesh, rules=rules, sp_impl=sp)
    tree = jax.device_get(jb.params)
    pc = mesh.shape["data"] * mesh.shape["fsdp"]
    tokens, targets = _batches()[0]
    evals = [float(jb.eval_fn(jb.params, jnp.asarray(t), jnp.asarray(y)))
             for t, y in ((_rank_order(tokens, pc),
                           _rank_order(targets, pc)), (tokens, targets))]
    params, opt, out = jb.params, jb.opt_state, []
    for tokens, targets in _batches():
        tok = jax.device_put(jnp.asarray(_rank_order(tokens, pc)),
                             jb.tok_sharding)
        tgt = jax.device_put(jnp.asarray(_rank_order(targets, pc)),
                             jb.tok_sharding)
        params, opt, m = jb.step_fn(params, opt, tok, tgt)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": out, "tree": tree, "evals": evals}


def _train_input(cfg, tree, desc, rules, sp):
    return {"cfg": _fields(cfg), "mesh": desc, "rules": rules,
            "sp_impl": sp, "params": _port(cfg, tree),
            "batches": [(torch.from_numpy(a).long(),
                         torch.from_numpy(b).long()) for a, b in _batches()]}


def _ffn_inputs():
    t, d, f, e = 32, 8, 16, 4
    return {"x": jax.random.normal(jax.random.PRNGKey(0), (t, d)),
            "router": jax.random.normal(jax.random.PRNGKey(1), (d, e)) * 0.1,
            "w_in": jax.random.normal(jax.random.PRNGKey(2), (e, d, f)) * 0.1,
            "w_out": jax.random.normal(jax.random.PRNGKey(3), (e, f, d))
            * 0.1}


def _prompts(n, key):
    k = jax.random.PRNGKey(key)
    out = []
    for _ in range(n):
        k, a, b = jax.random.split(k, 3)
        lp = int(jax.random.randint(a, (), 2, 14))
        out.append(np.asarray(jax.random.randint(b, (lp,), 0,
                                                 DEC.vocab_size), np.int32))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, and two launches (four ranks, two ranks) of
    the port's side of every test but lm_train's; the JAX steps' initial
    parameters are the port's."""
    # the JAX initial parameters first: the launches need them
    trees = {name: jax.device_get(jT.init(jax.random.PRNGKey(0), cfg))
             for name, cfg, *_ in STEP_MESHES}
    ffn = _ffn_inputs()
    dec_params = jT.init(jax.random.PRNGKey(0), DEC)
    prompt = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                DEC.vocab_size)
    dec_port = _port(DEC, dec_params)
    serve_prompts = _prompts(6, key=71)
    budgets = [5 + (i % 4) for i in range(6)]
    ep_decode = merge_rules(TP_DECODE_RULES, EP_RULES)
    gen = {"cfg": _fields(DEC), "params": dec_port,
           "prompt": torch.from_numpy(np.array(prompt)).long(),
           "cases": {"raw": {"n": 6}, "prepared": {"n": 6,
                                                   "prepared": True}}}
    gen_et = dict(gen, mesh="expert=2,tensor=2", rules=ep_decode, cases={
        "raw": {"n": 6, "rules": ep_decode},
        "prepared": {"n": 6, "prepared": True}})
    serve_runs = {"ring": {"kw": RING, "raw": True,
                           "prompts": serve_prompts, "budgets": budgets},
                  "paged": {"kw": dict(RING, paged=True),
                            "prompts": serve_prompts, "budgets": budgets}}
    four = {"tasks": {
        "ffn": ("moe_ffn", {"mesh": "expert=4", **{
            k: torch.from_numpy(np.array(v)) for k, v in ffn.items()}}),
        "data2_expert2": ("train", _train_input(
            MOE, trees["data2_expert2"], "data=2,expert=2",
            STEP_MESHES[0][4], None)),
        "gen_dt": ("tp_generate", dict(gen, mesh="data=2,tensor=2")),
        "gen_et": ("tp_generate", gen_et),
        "serve_et": ("tp_serve", {"cfg": _fields(DEC), "params": dec_port,
                                  "mesh": "expert=2,tensor=2",
                                  "rules": ep_decode, "runs": serve_runs})}}
    two = {"tasks": {name: ("train", _train_input(cfg, trees[name], desc,
                                                  rules, sp))
                     for name, cfg, desc, world, rules, sp in STEP_MESHES
                     if world == 2}}
    tmp = tmp_path_factory.mktemp("expert")
    ranks4 = in_background(lambda: run_ranks("multi", 4, four, tmp / "4",
                                              timeout=240))
    ranks2 = in_background(lambda: run_ranks("multi", 2, two, tmp / "2",
                                              timeout=240))

    want = {"ffn": np.asarray(jax_moe_ffn(ffn["x"], ffn["router"],
                                          ffn["w_in"], ffn["w_out"], k=2,
                                          capacity_factor=4.0))}
    jmesh = build_mesh(MeshSpec(fsdp=2, expert=4))
    shard = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(
        "expert"))
    want["ffn_sharded"] = np.asarray(jax.jit(
        lambda *a: jax_moe_ffn(*a, k=2, capacity_factor=4.0))(
        ffn["x"], ffn["router"], jax.device_put(ffn["w_in"], shard),
        jax.device_put(ffn["w_out"], shard)))
    for name, cfg, desc, world, rules, sp in STEP_MESHES:
        want[name] = _jax_steps(cfg, desc, world, rules, sp)
        # the JAX step starts from the parameters the port was given
        for leaf, init in zip(jax.tree.leaves(want[name].pop("tree")),
                              jax.tree.leaves(trees[name])):
            np.testing.assert_allclose(leaf, init, rtol=0, atol=1e-7)
    want["generate"] = np.asarray(jax_generate(dec_params, DEC, prompt, 6))
    return want, ranks4(), ranks2(), {"port": dec_port,
                                      "prompts": serve_prompts,
                                      "budgets": budgets}


def test_moe_expert_sharded_matches_unsharded(runs):
    """moe_ffn with its experts over expert=4 (each rank its expert, the
    outputs summed over the axis) equals the JAX package's, sharded and
    not."""
    want, ranks4, _, _ = runs
    np.testing.assert_allclose(want["ffn_sharded"], want["ffn"], atol=1e-5)
    for r in ranks4:
        assert r["ffn"]["experts"] == 1
        np.testing.assert_allclose(r["ffn"]["out"].numpy(), want["ffn"],
                                   atol=1e-5)


@pytest.mark.parametrize("name", [m[0] for m in STEP_MESHES])
def test_moe_step_matches_jax(runs, name):
    """Three steps' losses and gradient norms of the MoE step on the mesh
    against the JAX package's step on the same mesh shape, each rank on
    its block of the tokens (the JAX step on the ranks' blocks in rank
    order)."""
    want, ranks4, ranks2, _ = runs
    ranks = ranks4 if name == "data2_expert2" else ranks2
    w = np.asarray(want[name]["metrics"])
    for r in ranks:
        got = np.asarray(r[name]["metrics"])
        np.testing.assert_allclose(got[:, 0], w[:, 0], atol=LOSS_ATOL)
        np.testing.assert_allclose(got[:, 1], w[:, 1], atol=NORM_ATOL)


def test_global_routing_shows_at_capacity_factor_1_25(runs):
    """At capacity factor 1.25 tokens are dropped, so the routing order
    matters: the JAX loss of the batch in the ranks' order differs from
    the same rows in their first order, and the port's data=2 step (each
    rank two of the rows) is the former: its routing is the global
    batch's, not each rank's own."""
    want, _, ranks2, _ = runs
    ranked, first = want["data2_drops"]["evals"]
    assert abs(ranked - first) > 1e-4, (ranked, first)
    for r in ranks2:
        np.testing.assert_allclose(r["data2_drops"]["metrics"][0][0],
                                   want["data2_drops"]["metrics"][0][0],
                                   atol=LOSS_ATOL)
        assert r["data2_drops"]["pc"] == 2


def test_generate_moe_mesh_parity(runs):
    """MoE decode composes with the mesh: TP with the experts replicated
    (data=2,tensor=2) and TP x EP with them split (expert=2,tensor=2),
    raw and prepared weights, reproduce the JAX one-device greedy
    tokens."""
    want, ranks4, _, _ = runs
    for r in ranks4:
        for mesh in ("gen_dt", "gen_et"):
            for case in ("raw", "prepared"):
                np.testing.assert_array_equal(r[mesh][case].numpy(),
                                              want["generate"],
                                              err_msg=f"{mesh} {case}")
        assert "Shard(dim=1)" in r["gen_et"]["w_in"], r["gen_et"]["w_in"]
        assert r["gen_et"]["w_in_local"][1] == 2


def test_slot_server_moe_mesh_matches_meshless(runs):
    """The MoE SlotServer on expert=2,tensor=2, ring and paged, serves the
    meshless engine's tokens on every rank."""
    from tony_tpu_torch.models.serving import Request, SlotServer

    _, ranks4, _, srv = runs
    cfg = config_from_fields(_fields(DEC))
    for name, kw in (("ring", RING), ("paged", dict(RING, paged=True))):
        one = SlotServer(srv["port"], cfg, device="cpu", **kw)
        reqs = [Request(prompt=p, max_new_tokens=b)
                for p, b in zip(srv["prompts"], srv["budgets"])]
        for q in reqs:
            one.submit(q)
        done = one.run_until_drained()
        want = [done[q.id].tokens for q in reqs]
        for r in ranks4:
            assert r["serve_et"][name]["tokens"] == want, name


TRAIN = ["--device", "cpu", "--batch-size", "4", "--seq-len", "32",
         "--d-model", "64", "--n-layers", "2", "--n-heads", "4", "--d-ff",
         "128", "--vocab", "256", "--dtype", "float32", "--n-experts", "4",
         "--steps", "3"]


def test_lm_train_expert_two_process_matches_one_process(tmp_path,
                                                         monkeypatch):
    from tony_tpu_torch.examples import lm_train

    for var in ("TONY_COORDINATOR_ADDRESS", "TONY_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    two_out = tmp_path / "two.json"
    two = in_background(lambda: run_ranks("lm_train", 2, {"argv": TRAIN + [
        "--mesh", "expert=2", "--metrics-out", str(two_out)]},
        tmp_path / "w", timeout=120))
    one_out = tmp_path / "one.json"
    assert lm_train.main(TRAIN + ["--metrics-out", str(one_out)]) == 0
    assert [r["rc"] for r in two()] == [0, 0]
    one, got = (json.loads(p.read_text()) for p in (one_out, two_out))
    assert got["mesh"]["expert"] == 2 and len(got["losses"]) == 3
    np.testing.assert_allclose(got["losses"], one["losses"], atol=LOSS_ATOL)


def test_plan_keeps_the_rank_experts_and_refuses_a_batch_expert_axis():
    """Port-only: on a replayed expert=2 mesh Plan.use leaves w_in as the
    rank's experts (no gather), and an expert axis that also splits the
    batch is refused."""
    from tony_tpu_torch.parallel import EP_RULES as P_EP, DP_RULES as P_DP
    from tony_tpu_torch.parallel.collectives import ReplayWorld
    from tony_tpu_torch.parallel.spmd import Plan
    from tony_tpu_torch.parallel.tp_replay import ReplayMesh

    world = ReplayWorld(2)

    def rank(r):
        mesh = ReplayMesh(world, r, {"expert": 2})
        plan = Plan(mesh, {**P_DP, **P_EP})
        w = torch.zeros(2, 8, 16)
        got = plan.use(w, ("expert", "embed", "mlp"))
        try:
            Plan(mesh, {**P_DP, **P_EP, "batch": ("data", "expert")})
            refused = None
        except NotImplementedError as e:
            refused = str(e)
        return got.shape, plan.ep_rank, refused

    for r, (shape, ep_rank, refused) in enumerate(world.run(rank)):
        assert tuple(shape) == (2, 8, 16) and ep_rank == r
        assert "expert dimension takes one mesh axis" in refused
