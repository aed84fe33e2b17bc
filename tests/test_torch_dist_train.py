"""The sharded training step of the port (train/step.py on a mesh) on 2 and
4 gloo processes, held against the JAX package's create_train_step on the
same mesh shape (forced host devices, tests/conftest.py) from the same
parameters (converted with from_jax_params): data, FSDP and tensor
parallelism, FSDP x TP, and ring and Ulysses sequence parallelism, three
steps' losses and gradient norms at float32. Then lm_train as a two-process
job under the TONY_* contract against one process, and checkpoints moved
between a mesh and one process."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu.parallel import MeshSpec, build_mesh, mesh_from_string
from tony_tpu.train import create_train_step as jax_create
from tony_tpu_torch.models.convert import from_jax_params
from torch_dist_worker import run_ranks

LOSS_ATOL, NORM_ATOL = 2e-5, 1e-4
CFG = jT.TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                           n_kv_heads=4, d_ff=64, max_seq_len=16,
                           dtype=jnp.float32)
BATCH, SEQ, STEPS = 4, 16, 3

# (mesh, world, sp_impl)
MESHES = [("data=2", 2, None), ("fsdp=2", 2, None), ("tensor=2", 2, None),
          ("fsdp=2,tensor=2", 4, None), ("seq=2", 2, None),
          ("seq=2", 2, "ulysses")]


def _batches():
    rng = np.random.default_rng(21)
    return [(rng.integers(0, CFG.vocab_size, (BATCH, SEQ), dtype=np.int32),
             rng.integers(0, CFG.vocab_size, (BATCH, SEQ), dtype=np.int32))
            for _ in range(STEPS)]


def _fields():
    return {**dataclasses.asdict(CFG), "dtype": "float32",
            "param_dtype": "float32"}


@pytest.fixture(scope="module", params=MESHES,
                ids=[f"{m}-{sp or 'default'}" for m, _, sp in MESHES])
def parity(request, tmp_path_factory):
    """The JAX step's and the port's (loss, grad_norm) for three steps."""
    desc, world, sp = request.param
    mesh = mesh_from_string(desc, devices=jax.devices()[:world])
    jb = jax_create(CFG, mesh, sp_impl=sp)
    tree = jax.device_get(jb.params)
    params, opt, want = jb.params, jb.opt_state, []
    for tokens, targets in _batches():
        tok = jax.device_put(jnp.asarray(tokens), jb.tok_sharding)
        tgt = jax.device_put(jnp.asarray(targets), jb.tok_sharding)
        params, opt, m = jb.step_fn(params, opt, tok, tgt)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    cfg_t = {"cfg": _fields(), "mesh": desc, "sp_impl": sp,
             "params": from_jax_params(tree, _port_cfg(), "cpu"),
             "batches": [(torch.from_numpy(a).long(),
                          torch.from_numpy(b).long())
                         for a, b in _batches()]}
    ranks = run_ranks("train", world, cfg_t,
                      tmp_path_factory.mktemp("train"))
    return want, ranks, dict(mesh.shape)


def _port_cfg():
    from tony_tpu_torch.models.convert import config_from_fields

    return config_from_fields(_fields())


def test_sharded_train_step_matches_jax(parity):
    want, ranks, shape = parity
    for r in ranks:
        got = np.asarray(r["metrics"])
        np.testing.assert_allclose(got[:, 0], [w[0] for w in want],
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(got[:, 1], [w[1] for w in want],
                                   atol=NORM_ATOL)
    # the batch was split over exactly the axes the rules shard it on
    batch = shape["data"] * shape["fsdp"]
    assert {r["pc"] for r in ranks} == {batch}
    seq = shape["seq"] if ranks[0]["rules"].get("act_seq") else 1
    assert {r["sc"] for r in ranks} == {seq}


TRAIN = ["--device", "cpu", "--batch-size", "4", "--seq-len", "32",
         "--d-model", "64", "--n-layers", "2", "--n-heads", "4", "--d-ff",
         "128", "--vocab", "256", "--dtype", "float32"]


def _one_process(argv, tmp_path, name):
    """lm_train in this process, no TONY_* contract -> its losses."""
    from tony_tpu_torch.examples import lm_train

    out = tmp_path / f"{name}.json"
    assert lm_train.main(argv + ["--metrics-out", str(out)]) == 0
    return json.loads(out.read_text())


def _two_process(argv, mesh, tmp_path, name):
    out = tmp_path / f"{name}.json"
    ranks = run_ranks("lm_train", 2, {"argv": argv + [
        "--mesh", mesh, "--metrics-out", str(out)]}, tmp_path / name)
    assert [r["rc"] for r in ranks] == [0, 0]
    return json.loads(out.read_text())


def test_lm_train_two_process_job_matches_one_process(tmp_path,
                                                      monkeypatch):
    for var in ("TONY_COORDINATOR_ADDRESS", "TONY_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    one = _one_process(TRAIN + ["--steps", "4"], tmp_path, "one")
    two = _two_process(TRAIN + ["--steps", "4"], "data=2", tmp_path, "two")
    assert two["mesh"]["data"] == 2 and len(two["losses"]) == 4
    np.testing.assert_allclose(two["losses"], one["losses"], atol=LOSS_ATOL)


def test_checkpoint_moves_between_a_mesh_and_one_process(tmp_path,
                                                         monkeypatch):
    """Written at fsdp=2 (rank 0 writes the gathered state), resumed on one
    process; written on one process, resumed at fsdp=2: the parameters and
    the resumed losses are the straight one-process run's."""
    for var in ("TONY_COORDINATOR_ADDRESS", "TONY_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    ck = ["--checkpoint-every", "1"]
    straight = _one_process(TRAIN + ["--steps", "5", "--checkpoint-dir",
                                     str(tmp_path / "s")] + ck, tmp_path,
                            "straight")
    mesh_dir, one_dir = str(tmp_path / "m"), str(tmp_path / "o")
    _two_process(TRAIN + ["--steps", "3", "--checkpoint-dir", mesh_dir] + ck,
                 "fsdp=2", tmp_path, "mesh_first")
    s_state = torch.load(tmp_path / "s" / "2" / "state.pt")
    m_state = torch.load(tmp_path / "m" / "2" / "state.pt")
    for name, t in s_state["params"]["layers"].items():
        np.testing.assert_allclose(m_state["params"]["layers"][name].numpy(),
                                   t.numpy(), atol=1e-5, err_msg=name)
    assert m_state["opt_state"]["count"] == 3
    resumed = _one_process(TRAIN + ["--steps", "2", "--checkpoint-dir",
                                    mesh_dir] + ck, tmp_path, "resumed")
    np.testing.assert_allclose(resumed["losses"], straight["losses"][3:],
                               atol=LOSS_ATOL)
    _one_process(TRAIN + ["--steps", "3", "--checkpoint-dir", one_dir] + ck,
                 tmp_path, "one_first")
    on_mesh = _two_process(TRAIN + ["--steps", "2", "--checkpoint-dir",
                                    one_dir] + ck, "fsdp=2", tmp_path,
                           "mesh_resumed")
    np.testing.assert_allclose(on_mesh["losses"], straight["losses"][3:],
                               atol=LOSS_ATOL)


def test_sharded_step_takes_the_trees_it_is_given(tmp_path):
    """On fsdp=2 the step and eval compute with the parameters they are
    passed: a fresh bundle given the tree restored from another bundle's
    checkpoint evaluates and steps as that bundle does, and the update
    lands in the restored tree. The one-device bundle the same."""
    rng = np.random.default_rng(3)
    batches = [(torch.from_numpy(rng.integers(0, 64, (BATCH, SEQ))),
                torch.from_numpy(rng.integers(0, 64, (BATCH, SEQ))))
               for _ in range(2)]
    ranks = run_ranks("restore_step", 2, {
        "cfg": _fields(), "mesh": "fsdp=2", "batches": batches,
        "dir": str(tmp_path / "ck")}, tmp_path / "w")
    for r in ranks:
        np.testing.assert_allclose(r["evals"][1], r["evals"][0],
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(r["metrics"][1], r["metrics"][0],
                                   atol=LOSS_ATOL)
        assert r["params_diff"] <= 1e-6

    from tony_tpu_torch import train
    from tony_tpu_torch.train.checkpoint import CheckpointManager
    from tony_tpu_torch.train.step import _leaves

    cfg = _port_cfg()
    a = train.create_train_step(cfg, device="cpu")
    pa, oa, _ = a.step_fn(a.params, a.opt_state, *batches[0])
    mgr = CheckpointManager(str(tmp_path / "one"))
    mgr.save(0, {"params": pa, "opt_state": oa})
    b = train.create_train_step(
        cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    got = mgr.restore(template={"params": b.params, "opt_state": b.opt_state})
    mgr.close()
    np.testing.assert_allclose(float(b.eval_fn(got["params"], *batches[1])),
                               float(a.eval_fn(pa, *batches[1])),
                               atol=LOSS_ATOL)
    _, _, ma = a.step_fn(pa, oa, *batches[1])
    _, _, mb = b.step_fn(got["params"], got["opt_state"], *batches[1])
    np.testing.assert_allclose([float(mb["loss"]), float(mb["grad_norm"])],
                               [float(ma["loss"]), float(ma["grad_norm"])],
                               atol=LOSS_ATOL)
    for (name, x), (_, y) in zip(_leaves(pa), _leaves(got["params"])):
        torch.testing.assert_close(y, x, atol=1e-6, rtol=0, msg=name)


def test_lm_train_drain_on_one_rank_drains_both(tmp_path, monkeypatch):
    """A drain notice that only rank 1 sees (its own step log's .preempt
    file) ends both ranks at the same step: each exits EXIT_PREEMPTED and
    rank 0 writes that step's checkpoint."""
    from tony_tpu_torch.constants import EXIT_PREEMPTED

    for var in ("TONY_COORDINATOR_ADDRESS", "TONY_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    (tmp_path / "r1.jsonl.preempt").write_text("{}")
    ck = tmp_path / "ck"
    ranks = run_ranks("lm_train", 2, {
        "argv": TRAIN + ["--steps", "5", "--mesh", "data=2",
                         "--checkpoint-dir", str(ck),
                         "--checkpoint-every", "100"],
        "step_log": str(tmp_path / "r{rank}.jsonl")}, tmp_path / "w")
    assert [r["rc"] for r in ranks] == [EXIT_PREEMPTED] * 2
    assert (ck / "0" / "state.pt").exists()
