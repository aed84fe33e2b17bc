"""Tensor-parallel decode in the port (models/generate.py on a mesh) on 2 and
4 gloo processes, held against the JAX package's generate on as many forced
host devices (tests/conftest.py), from the same parameters (converted with
from_jax_params): the counterparts of tests/test_models.py:768 (raw and
prepared weights, the int8 KV cache, stop tokens with the step count),
:837 (the rejections) and :929 (lm_generate --tensor-parallel from a
sharded checkpoint). Float32, greedy, token-identical. Port-only: sampled
decoding on a mesh equals the one-device port at the same seed, and a
returned cache continues on its rank's shard."""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu.models.generate import generate as jax_generate
from tony_tpu.models.generate import prepare_decode as jax_prepare
from tony_tpu.parallel import MeshSpec, build_mesh
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.models.generate import generate, prepare_decode
from tony_tpu_torch.parallel.mesh import AXIS_ORDER
from torch_dist_worker import run_ranks

TINY = jT.TransformerConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=128, max_seq_len=64,
                            dtype=jnp.float32)
FIELDS = {**dataclasses.asdict(TINY), "dtype": "float32",
          "param_dtype": "float32"}
N_NEW = 6
# (mesh, processes): data x tensor as the JAX package's test, and tensor
MESHES = [("data=2,tensor=2", 4), ("tensor=2", 2)]


def _port_cfg():
    return config_from_fields(FIELDS)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's parameters, prompt and one-device decode, and the
    converted parameters."""
    params = jT.init(jax.random.PRNGKey(0), TINY)
    prompt = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                TINY.vocab_size)
    single = np.asarray(jax_generate(params, TINY, prompt, N_NEW))
    return {"jax_params": params, "jax_prompt": prompt, "single": single,
            "stops": (int(single[0, 2]), int(single[1, 4])),
            "params": from_jax_params(jax.device_get(params), _port_cfg(),
                                      "cpu"),
            "prompt": torch.from_numpy(np.array(prompt)).long()}


def _jax_mesh_decodes(ref, desc, world):
    """The JAX package's decodes on the mesh ``desc`` of as many forced
    host devices."""
    params, prompt = ref["jax_params"], ref["jax_prompt"]
    sizes = {k: int(v) for k, v in (p.split("=") for p in desc.split(","))}
    mesh = build_mesh(MeshSpec(**{"fsdp": 1, **sizes}),
                      devices=jax.devices()[:world])
    stop_out, steps = jax_generate(params, TINY, prompt, N_NEW, mesh=mesh,
                                   stop_tokens=ref["stops"], pad_id=0,
                                   return_steps=True)
    return {"raw": np.asarray(jax_generate(params, TINY, prompt, N_NEW,
                                           mesh=mesh)),
            "prepared": np.asarray(jax_generate(
                jax_prepare(params, TINY, mesh=mesh), TINY, prompt, N_NEW,
                mesh=mesh)),
            "int8": np.asarray(jax_generate(params, TINY, prompt, N_NEW,
                                            kv_dtype="int8", mesh=mesh)),
            "stop": (np.asarray(stop_out), int(steps))}


@pytest.fixture(scope="module", params=MESHES, ids=[m for m, _ in MESHES])
def ranks(request, ref, tmp_path_factory):
    """Every case on each rank of the port's mesh, and the JAX package's
    decodes on the same mesh shape."""
    desc, world = request.param
    turn2 = ref["prompt"][:, :3]
    cases = {
        "raw": {"n": N_NEW},
        "prepared": {"n": N_NEW, "prepared": True},
        "int8": {"n": N_NEW, "kv_dtype": "int8"},
        "stop": {"n": N_NEW, "stop_tokens": ref["stops"], "pad_id": 0,
                 "return_steps": True},
        "sampled": {"n": N_NEW, "temperature": 0.8, "top_k": 20, "seed": 3},
        "cont": {"n": 4, "return_cache": True, "max_len": 24,
                 "continue": turn2},
    }
    got = run_ranks("tp_generate", world, {
        "cfg": FIELDS, "mesh": desc, "params": ref["params"],
        "prompt": ref["prompt"], "cases": cases},
        tmp_path_factory.mktemp("tp_generate"))
    return desc, world, got, _jax_mesh_decodes(ref, desc, world)


def test_generate_tp_mesh_parity(ref, ranks):
    """The counterpart of test_models.py:768: every rank returns the whole
    batch, token-identical to the JAX package's mesh decode and its
    one-device decode; prepared weights skip the fusion and hold the kv
    heads sharded over ``tensor``; the int8 cache's scales shard alongside;
    stop tokens give the JAX package's tokens and step count."""
    desc, world, got, want = ranks
    np.testing.assert_array_equal(want["raw"], ref["single"])
    for r in got:
        np.testing.assert_array_equal(r["raw"].numpy(), want["raw"])
        np.testing.assert_array_equal(r["prepared"].numpy(),
                                      want["prepared"])
        assert r["unfused"]                 # no fusion under sharded TP
        # [L, d, kvH/t, hd]: the kv heads split over the tensor axis
        assert r["wk"].endswith("Shard(dim=2))")
        assert r["wk_local"][2] == TINY.n_kv_heads // 2
        out = r["int8"].numpy()
        assert ((out >= 0) & (out < TINY.vocab_size)).all()
        np.testing.assert_array_equal(out, want["int8"])
        toks, steps = r["stop"]
        np.testing.assert_array_equal(toks.numpy(), want["stop"][0])
        assert steps == want["stop"][1] and steps <= 4


def test_sampled_mesh_decode_equals_one_device(ref, ranks):
    """Port-only: every rank draws the whole batch's exponentials from the
    same generator state and keeps its rows, so a sampled mesh decode is
    the one-device port's at the same seed."""
    got = ranks[2]
    one = generate(ref["params"], _port_cfg(), ref["prompt"], N_NEW,
                   temperature=0.8, top_k=20,
                   generator=torch.Generator().manual_seed(3))
    for r in got:
        assert torch.equal(r["sampled"], one)


def test_cache_continuation_on_the_rank_shard(ref, ranks):
    """Port-only: ``return_cache`` gives the rank's shard ([L, B / t_batch,
    kvH / t_kv, M, D]) and ``cache=`` continues on it, as one device
    continues its whole cache."""
    desc, _, got, _ = ranks
    cfg = _port_cfg()
    toks, cache = generate(ref["params"], cfg, ref["prompt"], 4,
                           return_cache=True, max_len=24)
    toks2, _ = generate(ref["params"], cfg, ref["prompt"][:, :3], 4,
                        cache=cache, return_cache=True)
    t_b = 2 if desc.startswith("data=2") else 1
    for r in got:
        assert r["cont_cache"] == (cfg.n_layers, 2 // t_b,
                                   cfg.n_kv_heads // 2, 24, cfg.head_dim)
        assert torch.equal(r["cont"][0], toks)
        assert torch.equal(r["cont"][1], toks2)


def _stub_mesh(**sizes):
    """A mesh's shape alone, for the checks made before any placement
    (the shapes that would need more processes than a test starts)."""
    shape = [sizes.get(a, 1) for a in AXIS_ORDER]
    return types.SimpleNamespace(mesh_dim_names=AXIS_ORDER,
                                 mesh=torch.empty(shape))


def test_generate_tp_mesh_rejections(ref):
    """The counterpart of test_models.py:837, against a mesh's shape: GQA
    with fewer kv heads than the tensor axis, an indivisible batch, w8a16
    under TP, and prepared weights that disagree with the call raise the
    JAX package's errors (checked on the JAX side too)."""
    cfg, params = _port_cfg(), ref["params"]
    prompt = torch.zeros((2, 4), dtype=torch.long)
    jparams = ref["jax_params"]
    jmesh8 = build_mesh(MeshSpec(fsdp=1, tensor=8))
    jmesh = build_mesh(MeshSpec(data=2, fsdp=1, tensor=2),
                       devices=jax.devices()[:4])
    mesh8, mesh = _stub_mesh(tensor=8), _stub_mesh(data=2, tensor=2)
    for gen, p, m8, m, z in (
            (jax_generate, jparams, jmesh8, jmesh, jnp.zeros),
            (generate, params, mesh8, mesh, None)):
        zeros = ((lambda s: z(s, jnp.int32)) if z is not None
                 else (lambda s: torch.zeros(s, dtype=torch.long)))
        with pytest.raises(ValueError, match="n_kv_heads=2.*kv"):
            gen(p, TINY if z is not None else cfg, zeros((2, 4)), 2,
                mesh=m8)
        with pytest.raises(ValueError, match="batch 3"):
            gen(p, TINY if z is not None else cfg, zeros((3, 4)), 2, mesh=m)
    with pytest.raises(ValueError, match="int8"):
        jax_prepare(jparams, TINY, weight_dtype="int8", mesh=jmesh)
    with pytest.raises(ValueError, match="int8"):
        prepare_decode(params, cfg, weight_dtype="int8", mesh=mesh)
    prep = prepare_decode(params, cfg)
    with pytest.raises(ValueError, match="mesh mismatch"):
        generate(prep, cfg, prompt, 2, mesh=mesh)
    with pytest.raises(ValueError, match="prepared weights were built"):
        generate(prep, cfg, prompt, 2, weight_dtype="int8")


def test_replicated_kv_cache_on_a_tensor_axis(tmp_path):
    """Port-only: the remedy the GQA rejection names, ``rules["kv"] =
    None``: a model with one kv head on ``tensor=2`` keeps every kv head
    on each rank (each rank's query heads read theirs) and decodes the
    one-device tokens, greedy and with the int8 cache."""
    from tony_tpu_torch.models import transformer
    from tony_tpu_torch.parallel import TP_DECODE_RULES

    fields = dict(FIELDS, n_kv_heads=1)
    cfg = config_from_fields(fields)
    params = transformer.init(cfg, torch.Generator().manual_seed(4), "cpu")
    prompt = torch.randint(0, 256, (2, 8),
                           generator=torch.Generator().manual_seed(5))
    got = run_ranks("tp_generate", 2, {
        "cfg": fields, "mesh": "tensor=2", "params": params,
        "prompt": prompt, "rules": dict(TP_DECODE_RULES, kv=None),
        "cases": {"raw": {"n": N_NEW, "prepared": True},
                  "int8": {"n": N_NEW, "kv_dtype": "int8",
                           "prepared": True}}}, tmp_path)
    for r in got:
        assert torch.equal(r["raw"], generate(params, cfg, prompt, N_NEW))
        assert torch.equal(r["int8"], generate(params, cfg, prompt, N_NEW,
                                                kv_dtype="int8"))
        assert r["wk_local"][2] == 1        # the whole kv head on each


@pytest.mark.parametrize("t", [2, 4])
def test_replayed_tensor_axis_matches_the_whole_model(ref, t):
    """parallel/tp_replay.py, the smoke's replay of a tensor axis on one
    card: every rank's forward with the collectives in memory gives the
    whole model's logits at each step (within the parity tolerance, 2e-5)
    and every rank the same."""
    from tony_tpu_torch.models import transformer
    from tony_tpu_torch.parallel.tp_replay import (
        decode_logits, replay_tp_decode,
    )

    cfg = dataclasses.replace(_port_cfg(), n_kv_heads=4)
    params = transformer.init(cfg, torch.Generator().manual_seed(8), "cpu")
    prompt = ref["prompt"]
    fed = torch.randint(0, 256, (2, 5),
                        generator=torch.Generator().manual_seed(9))
    whole = decode_logits(params, cfg, prompt, fed, 16)
    got = replay_tp_decode(params, cfg, prompt, fed, t, 16)
    assert len(got) == t and len(got[0]) == fed.shape[1] + 1
    for rank in got:
        for a, b in zip(rank, got[0]):
            assert torch.equal(a, b)
    for a, w in zip(got[0], whole):
        torch.testing.assert_close(a, w, atol=2e-5, rtol=0)


def test_replay_group_runs_one_rank_at_a_time():
    """collectives.ReplayGroup under stress: more ranks than cores, a
    short switch interval, and a read-modify-write of shared state
    between collectives that a second running rank would break; every
    all-reduce and all-gather gives the whole group's result."""
    import sys
    import time

    from tony_tpu_torch.parallel.collectives import (
        ReplayGroup, all_reduce_, gather_nograd,
    )

    t, rounds = 12, 60
    shared = {"n": 0}
    group = ReplayGroup(t)

    def rank(r):
        sums = []
        for i in range(rounds):
            n = shared["n"]
            time.sleep(0)                   # invite another thread in
            shared["n"] = n + 1
            x = torch.full((3,), float(r + i))
            sums.append(float(all_reduce_(x, group)[0]))
            got = gather_nograd(torch.tensor([[r]]), 1, group)
            assert got.tolist() == [list(range(t))]
        return sums

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        out = group.run(rank)
    finally:
        sys.setswitchinterval(old)
    assert time.monotonic() - t0 < 60
    assert shared["n"] == t * rounds
    want = [float(sum(range(t)) + t * i) for i in range(rounds)]
    assert all(sums == want for sums in out)


MODEL = ["--device", "cpu", "--vocab", "128", "--d-model", "32",
         "--n-layers", "1", "--n-heads", "2", "--d-ff", "64", "--dtype",
         "float32"]


def test_lm_generate_tensor_parallel_restores_sharded_checkpoint(
        tmp_path, monkeypatch):
    """The counterpart of test_models.py:929: a checkpoint written by
    ``lm_train --mesh fsdp=2`` on two processes, restored by
    ``lm_generate --tensor-parallel 2`` on two processes into DTensor
    templates, decodes the tokens of one process's restore."""
    from tony_tpu_torch.examples import lm_generate

    for var in ("TONY_COORDINATOR_ADDRESS", "TONY_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    ck = str(tmp_path / "ck")
    got = run_ranks("lm_train", 2, {"argv": MODEL + [
        "--steps", "3", "--checkpoint-dir", ck, "--checkpoint-every", "2",
        "--batch-size", "8", "--seq-len", "32", "--mesh", "fsdp=2"]},
        tmp_path / "train")
    assert [r["rc"] for r in got] == [0, 0]
    gen = MODEL + ["--checkpoint-dir", ck, "--prompt", "1 2 3",
                   "--max-new", "5"]
    one = tmp_path / "one.json"
    assert lm_generate.main(gen + ["--metrics-out", str(one)]) == 0
    tp = tmp_path / "tp.json"
    got = run_ranks("lm_generate", 2, {"argv": gen + [
        "--tensor-parallel", "2", "--metrics-out", str(tp)]},
        tmp_path / "gen")
    assert [r["rc"] for r in got] == [0, 0]
    want = json.loads(one.read_text())["tokens"]
    result = json.loads(tp.read_text())
    assert result["tokens"] == want and len(want) == 5
    assert result["tensor_parallel"] == 2


def test_lm_generate_tensor_parallel_random_init(tmp_path, monkeypatch):
    """``lm_generate --tensor-parallel 2`` with random weights: each rank
    keeps its block of each leaf as it is drawn, and the decode has one
    process's tokens. Without the flag, a process of a TonY job joins no
    job: each rank decodes alone."""
    from tony_tpu_torch.examples import lm_generate

    for var in ("TONY_COORDINATOR_ADDRESS", "TONY_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    gen = MODEL + ["--prompt", "1 2 3", "--max-new", "5", "--seed", "4"]
    one = tmp_path / "one.json"
    assert lm_generate.main(gen + ["--metrics-out", str(one)]) == 0
    tp = tmp_path / "tp.json"
    got = run_ranks("lm_generate", 2, {"argv": gen + [
        "--tensor-parallel", "2", "--metrics-out", str(tp)]},
        tmp_path / "tp")
    assert [r["rc"] for r in got] == [0, 0]
    want = json.loads(one.read_text())["tokens"]
    assert json.loads(tp.read_text())["tokens"] == want and len(want) == 5
    got = run_ranks("lm_generate", 2, {"argv": gen}, tmp_path / "alone")
    assert [r["rc"] for r in got] == [0, 0]
