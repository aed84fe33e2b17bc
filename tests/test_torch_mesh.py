"""The port's mesh, rule tables and loader sharding (parallel/mesh.py,
parallel/sharding.py, data/loader.py, train/bootstrap.py) held against the
JAX package's (the counterparts of test_parallel.py:28-52 and :174-205):
MeshSpec resolution and mesh strings, the rule tables dict for dict, specs
and their DTensor placements, hybrid-mesh locality, and each process's
loader and sequence shard on 2- and 4-process meshes. The port's meshes
here are layouts (a DeviceMesh built for one rank without process groups);
one test joins a real one-process gloo group through ``train.init``."""

import importlib
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

import tony_tpu.data.loader as jloader
import tony_tpu.parallel.mesh as jmesh
import tony_tpu.parallel.sharding as jsharding
from tony_tpu.models import transformer as jT
from tony_tpu_torch.data import loader as ploader
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.parallel import mesh as pmesh
from tony_tpu_torch.parallel import sharding as psharding
from torch_dist_worker import free_port

TABLES = ("DP_RULES", "FSDP_RULES", "TP_RULES", "FSDP_TP_RULES",
          "TP_DECODE_RULES", "SP_RULES", "EP_RULES")


def _layout(desc: str, world: int, rank: int) -> DeviceMesh:
    """The port's mesh for ``desc`` over ``world`` ranks, as rank ``rank``
    sees it, without process groups."""
    ranks = pmesh.rank_array(pmesh.parse_mesh(desc), world)
    return DeviceMesh("cpu", torch.as_tensor(ranks),
                      mesh_dim_names=pmesh.AXIS_ORDER, _init_backend=False,
                      _rank=rank)


@pytest.mark.parametrize("kwargs,n", [
    (dict(fsdp=-1), 8), (dict(data=2, fsdp=1, tensor=4), 8),
    (dict(data=2, fsdp=-1, seq=2), 8), (dict(data=3, fsdp=-1), 8),
    (dict(data=2, fsdp=2), 8), (dict(data=-1, tensor=-1), 8),
    (dict(fsdp=1), 1),
])
def test_mesh_spec_resolve_matches_jax(kwargs, n):
    try:
        want = jmesh.MeshSpec(**kwargs).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh.MeshSpec(**kwargs).resolve(n)
        assert str(got.value) == str(e)
        return
    assert pmesh.MeshSpec(**kwargs).resolve(n) == want


@pytest.mark.parametrize("desc", ["", "fsdp=-1", "tensor=4", "seq=8",
                                  "data=2,fsdp=2,tensor=2",
                                  "fsdp=-1,tensor=2", "seq=2,tensor=2"])
def test_mesh_strings_match_jax(desc):
    want = dict(jmesh.mesh_from_string(desc).shape)
    assert pmesh.parse_mesh(desc).resolve(8) == want
    assert pmesh.rank_array(pmesh.parse_mesh(desc), 8).shape == tuple(
        want[a] for a in pmesh.AXIS_ORDER)


def test_mesh_string_errors_match_jax():
    for desc in ("model=2", "data=3"):
        with pytest.raises(ValueError) as want:
            jmesh.mesh_from_string(desc)
        with pytest.raises(ValueError) as got:
            pmesh.parse_mesh(desc).resolve(8)
        assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.mesh_from_string("data=2")


@pytest.mark.parametrize("name", TABLES)
def test_rule_tables_verbatim(name):
    assert getattr(psharding, name) == getattr(jsharding, name)
    merged = psharding.merge_rules(psharding.FSDP_TP_RULES,
                                   getattr(psharding, name))
    assert merged == jsharding.merge_rules(jsharding.FSDP_TP_RULES,
                                           getattr(jsharding, name))


def _logical_tuples():
    out = {("batch", "seq", "embed"), ("batch", None), ("batch",),
           ("embed", "mlp"), (None, None)}
    for experts in (0, 4):
        tree = jT.param_logical_axes(jT.TransformerConfig(n_experts=experts))
        assert tree == T.param_logical_axes(T.TransformerConfig(
            n_experts=experts))
        stack = [tree]
        while stack:
            node = stack.pop()
            for v in node.values():
                (stack.append(v) if isinstance(v, dict) else out.add(v))
    return sorted(out, key=str)


@pytest.mark.parametrize("name", TABLES)
def test_specs_and_placements_match_jax(name):
    rules = psharding.merge_rules(psharding.DP_RULES, getattr(psharding, name))
    jrules = jsharding.merge_rules(jsharding.DP_RULES, getattr(jsharding, name))
    for axes in _logical_tuples():
        want = tuple(jsharding.logical_to_spec(axes, jrules))
        spec = psharding.logical_to_spec(axes, rules)
        assert spec == want, axes
        named = [a for e in want if e is not None
                 for a in ((e,) if isinstance(e, str) else e)]
        if len(named) != len(set(named)):
            # an activation's batch and a param's embed both on fsdp: a
            # spec no array can take (NamedSharding refuses it too)
            with pytest.raises(ValueError, match="shards two dimensions"):
                psharding.spec_to_placements(spec)
            continue
        placements = psharding.spec_to_placements(spec)
        for mesh_axis, p in zip(pmesh.AXIS_ORDER, placements):
            dims = [d for d, e in enumerate(want)
                    if e is not None and mesh_axis in
                    ((e,) if isinstance(e, str) else e)]
            assert p == (Shard(dims[0]) if dims else Replicate()), (axes,
                                                                  mesh_axis)


@pytest.mark.parametrize("desc", ["fsdp=2,tensor=2", "data=2,seq=2",
                                  "tensor=4", "data=4"])
def test_mesh_shards_rule_matches_jax(desc):
    jm = jmesh.mesh_from_string(desc, devices=jax.devices()[:4])
    pm = _layout(desc, 4, 0)
    assert pmesh.mesh_shape(pm) == dict(jm.shape)
    for rules in (None, jsharding.FSDP_TP_RULES, jsharding.DP_RULES,
                  {**jsharding.DP_RULES, "act_seq": "seq"}):
        for row, default in (("batch", ("data", "fsdp")),
                             ("vocab", ("tensor",)), ("act_seq", ("seq",))):
            assert psharding.mesh_shards_rule(pm, rules, row, default) == \
                jsharding.mesh_shards_rule(jm, rules, row, default)


def test_local_slices_tile_the_full_tensor():
    """Each rank's block under FSDP_TP_RULES, put back by its coordinate,
    rebuilds the tensor (wq: embed over fsdp, heads over tensor)."""
    full = torch.arange(2 * 8 * 4 * 3, dtype=torch.float32).reshape(2, 8, 4, 3)
    spec = psharding.logical_to_spec(("layers", "embed", "heads", None),
                                     psharding.FSDP_TP_RULES)
    rebuilt = torch.zeros_like(full)
    for r in range(4):
        m = _layout("fsdp=2,tensor=2", 4, r)
        c = dict(zip(m.mesh_dim_names, m.get_coordinate()))
        rebuilt[:, c["fsdp"] * 4:(c["fsdp"] + 1) * 4,
                c["tensor"] * 2:(c["tensor"] + 1) * 2] = \
            psharding.local_slice(full, m, spec)
    assert torch.equal(rebuilt, full)
    with pytest.raises(ValueError, match="does not divide"):
        psharding.local_slice(torch.zeros(3, 2), _layout("fsdp=2", 2, 0),
                              ("fsdp",))


def test_hybrid_mesh_locality_matches_jax():
    """2 nodes of 4: data spans the nodes, fsdp and tensor stay inside one;
    the rank layout is the JAX package's device layout."""
    ici, dcn = dict(fsdp=2, tensor=2), dict(data=2, fsdp=1)
    want = jmesh.build_hybrid_mesh(
        ici=jmesh.MeshSpec(**ici), dcn=jmesh.MeshSpec(**dcn),
        devices=jax.devices(), num_slices=2)
    got = pmesh.hybrid_rank_array(pmesh.MeshSpec(**ici),
                                  pmesh.MeshSpec(**dcn), 8, 2)
    assert (got == np.vectorize(lambda d: d.id)(want.devices)).all()
    for data_idx in range(2):
        assert len({int(r) // 4 for r in got[0, data_idx].flat}) == 1
    with pytest.raises(ValueError, match="both DCN and ICI"):
        pmesh.hybrid_rank_array(pmesh.MeshSpec(data=2, fsdp=2),
                                pmesh.MeshSpec(data=2, fsdp=1), 8, 2)


# meshes whose batch axes span every process or none: the JAX package's
# (process_index, process_count) rule and the port's coordinate rule agree
SPANNING = ["data=2", "fsdp=2", "seq=2", "tensor=2", "data=4", "fsdp=4",
            "data=2,fsdp=2", "seq=4", "tensor=4", "seq=2,tensor=2"]


@pytest.mark.parametrize("desc", SPANNING)
def test_loader_and_seq_shards_match_jax(desc):
    world = int(np.prod(list(pmesh.parse_mesh(desc).resolve(
        2 if desc in ("data=2", "fsdp=2", "seq=2", "tensor=2") else 4)
        .values())))
    jm = jmesh.mesh_from_string(desc, devices=jax.devices()[:world])
    rules = {**jsharding.DP_RULES, "act_seq": "seq"}
    for p in range(world):
        pm = _layout(desc, world, p)
        assert ploader.loader_shard_info(pm, p, world) == \
            jloader.loader_shard_info(jm, p, world)
        assert ploader.seq_shard_info(pm, p, rules=rules) == \
            jloader.seq_shard_info(jm, p, rules=rules,
                                   device_process=lambda d: d.id)


def test_loader_shards_on_a_mixed_mesh():
    """data=2 x tensor=2 on 4 processes: the two ranks of a tensor pair hold
    one batch shard between them, so they load the same rows (the JAX
    package's rows-p::P rule assumes a host's devices span the tensor
    axis, which one card a process does not)."""
    got = [ploader.loader_shard_info(_layout("data=2,tensor=2", 4, p), p, 4)
           for p in range(4)]
    assert got == [(0, 2), (0, 2), (1, 2), (1, 2)]
    got = [ploader.seq_shard_info(_layout("data=2,seq=2", 4, p), p)
           for p in range(4)]
    assert got == [(0, 2), (1, 2), (0, 2), (1, 2)]


def test_init_joins_a_one_process_group(monkeypatch):
    """Under the contract, one process still joins a (gloo) group, and the
    mesh is a DeviceMesh of six axes of one; params placed by the rules
    are DTensors whose local block is the whole tensor."""
    from tony_tpu_torch import train

    monkeypatch.setenv("TONY_COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("TONY_PROCESS_ID", "0")
    monkeypatch.setenv("TONY_NUM_PROCESSES", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        train.init()
    info = train.init(device="cpu")
    try:
        assert info["backend"] == "gloo" and dist.get_world_size() == 1
        mesh = pmesh.single_device_mesh()
        assert pmesh.mesh_shape(mesh) == dict.fromkeys(pmesh.AXIS_ORDER, 1)
        assert pmesh.slice_topology()["num_devices"] == 1
        cfg = T.TransformerConfig(vocab_size=32, d_model=16, n_layers=1,
                                  n_heads=2, d_ff=32)
        params = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
        placed = psharding.shard_params(mesh, params,
                                        T.param_logical_axes(cfg),
                                        psharding.FSDP_TP_RULES)
        wq = placed["layers"]["wq"]
        assert wq.placements[pmesh.AXIS_ORDER.index("fsdp")] == Shard(1)
        assert torch.equal(wq.to_local(), params["layers"]["wq"])
        assert train.init(device="cpu")["backend"] == "gloo"   # idempotent
    finally:
        dist.destroy_process_group()


def test_bootstrap_slices_and_single_process(monkeypatch):
    from tony_tpu_torch import train

    for var in ("TONY_COORDINATOR_ADDRESS", "TONY_NUM_PROCESSES",
                "TONY_NUM_SLICES", "TONY_SLICE_ID"):
        monkeypatch.delenv(var, raising=False)
    assert train.init(device="cpu")["backend"] is None
    assert not dist.is_initialized()
    assert (train.num_slices(), train.slice_id()) == (1, 0)
    monkeypatch.setenv("TONY_NUM_SLICES", "2")
    monkeypatch.setenv("TONY_SLICE_ID", "1")
    assert (train.num_slices(), train.slice_id()) == (2, 1)
    assert pmesh.detect_num_slices() == 2
    from tony_tpu_torch import constants as c
    from tony_tpu import constants as jc

    assert (c.ENV_SLICE_ID, c.ENV_NUM_SLICES) == (jc.ENV_SLICE_ID,
                                                  jc.ENV_NUM_SLICES)
