"""Disaggregated prefill/decode roles on a mesh in the port
(models/serving.py ``SlotServer(role=, mesh=)``, ``split_kv_heads`` /
``join_kv_heads``, parallel/lockstep.py's import operation and export
slices) on 2 gloo processes, against the JAX package's one-device
engines, TINY widths at float32 from the same parameters (converted with
from_jax_params).

- A prefill role on ``tensor=2`` (each rank one of the two kv heads) and
  on ``data=2`` (each rank the blocks of its share of the slots) exports
  the one-device payload: the pinned keys, and K/V within 2e-5 of the JAX
  package's prefill-role payload (int8 values within one step, their
  scales within 2e-5, on ``tensor=2``).
- Such a payload decodes on a one-device engine of either package, and a
  one-device payload of either package decodes on a ``tensor=2`` and a
  ``data=2`` decode role: greedy tokens identical to the JAX solo paged
  engine's (one slot a request, so no slot is re-admitted: ROADMAP.md's
  reference-side facts).
- Rank 0 decides an import: a torn payload is a ValueError there, counted
  in ``kv_import_rejects``, and a full pool a QueueFullError with
  Retry-After; neither reaches the followers, whose host digests stay
  rank 0's. Imported on every rank alone, the full pool refuses at the
  same payload on each.
- The head split and join round-trip at t = 1, 2 and 4, with and without
  int8 scales."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import serving as jS
from tony_tpu.models import transformer as jT
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from torch_dist_worker import in_background, run_ranks

TINY = jT.TransformerConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=128, max_seq_len=128,
                            dtype=jnp.float32)
FIELDS = {**dataclasses.asdict(TINY), "dtype": "float32",
          "param_dtype": "float32"}
SRV = dict(slots=4, max_len=64, block_size=4, prefill_chunk=8, paged=True)
NEW = 8
ATOL = 2e-5


def _prompts():
    rng = np.random.default_rng(17)
    return [rng.integers(0, 256, int(n), dtype=np.int32)
            for n in (5, 11, 17, 22)]


def _run(srv, prompts, Req):
    reqs = [Req(prompt=p, max_new_tokens=NEW) for p in prompts]
    for r in reqs:
        srv.submit(r)
    done = srv.run_until_drained()
    return [done[r.id].tokens for r in reqs]


def _exports(srv, prompts, Req):
    reqs = [Req(prompt=p, max_new_tokens=NEW) for p in prompts]
    for r in reqs:
        srv.submit(r)
    done = srv.run_until_drained()
    assert {done[r.id].finish_reason for r in reqs} == {"prefilled"}
    return [json.loads(json.dumps(srv.export_blocks(r.id))) for r in reqs]


def _decode(srv, payloads):
    rids = [srv.import_blocks(pl) for pl in payloads]
    done = srv.run_until_drained()
    return [done[r].tokens for r in rids]


def _torn(payload):
    """Three damaged copies: a flipped byte, a truncated buffer, a
    foreign model."""
    import base64

    raw = bytearray(base64.b64decode(payload["blocks_k"]))
    raw[3] ^= 0xFF
    return [dict(payload, blocks_k=base64.b64encode(bytes(raw)).decode()),
            dict(payload, blocks_v=payload["blocks_v"][:-16]),
            dict(payload, model="other-model")]


@pytest.fixture(scope="module")
def model():
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), TINY))
    cfg = config_from_fields(FIELDS)
    return cfg, tree, from_jax_params(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def cases(model, tmp_path_factory):
    """The port's one-device payloads, then the ranks' launch in the
    background while the JAX package's payloads and solo tokens are
    computed, then a second launch decoding the JAX payloads on both
    meshes."""
    cfg, tree, params = model
    prompts = _prompts()
    port_one = _exports(S.SlotServer(params, cfg, device="cpu", role="prefill",
                                     **SRV), prompts, S.Request)
    # three slots on 11 blocks of 4 tokens: the first two requests take 8,
    # the third needs 6
    small = dict(SRV, role="decode", slots=3, kv_pool_blocks=11)
    runs = {}
    for mesh in ("tensor=2", "data=2"):
        tag = mesh.split("=")[0]
        runs[f"pre_{tag}"] = dict(mesh=mesh, kind="prefill", prompts=prompts,
                                  budgets=[NEW] * len(prompts),
                                  kw=dict(SRV, role="prefill"))
        runs[f"dec_{tag}"] = dict(mesh=mesh, kind="decode",
                                  payloads=port_one,
                                  kw=dict(SRV, role="decode"))
    runs["pre_tensor_int8"] = dict(runs["pre_tensor"],
                                   kw=dict(SRV, role="prefill",
                                           kv_dtype="int8"))
    runs["refuse_tensor"] = dict(mesh="tensor=2", kind="refuse",
                                 torn=_torn(port_one[1]), payloads=port_one,
                                 kw=small)
    alone = {"full_tensor": dict(mesh="tensor=2", kw=small,
                                 payloads=port_one)}
    first = in_background(lambda: run_ranks(
        "disagg_mesh", 2, dict(cfg=FIELDS, params=params, runs=runs,
                               alone=alone),
        tmp_path_factory.mktemp("disagg_mesh_a"), timeout=150))
    try:
        jax_one = {kv: _exports(jS.SlotServer(tree, TINY, role="prefill",
                                              kv_dtype=kv, **SRV),
                                prompts, jS.Request)
                   for kv in ("native", "int8")}
    except BaseException:
        first()
        raise
    second = in_background(lambda: run_ranks(
        "disagg_mesh", 2, dict(cfg=FIELDS, params=params, runs={
            f"dec_{m.split('=')[0]}": dict(mesh=m, kind="decode",
                                           payloads=jax_one["native"],
                                           kw=dict(SRV, role="decode"))
            for m in ("tensor=2", "data=2")}),
        tmp_path_factory.mktemp("disagg_mesh_b"), timeout=150))
    try:
        want = _run(jS.SlotServer(tree, TINY, **SRV), prompts, jS.Request)
        ranks = first()
    finally:
        ranks_jax = second()            # joined whatever happened above
    return dict(prompts=prompts, port_one=port_one, jax_one=jax_one,
                want=want, ranks=ranks, ranks_jax=ranks_jax)


def _kv(payload):
    """A payload's decoded (k, v, k_scale, v_scale) as float64 numpy."""
    return [None if t is None else t.double().numpy()
            for t in S.deserialize_kv_blocks(payload)]


@pytest.mark.parametrize("mesh", ["tensor", "data"])
def test_mesh_prefill_exports_the_one_device_payload(cases, mesh):
    """A prefill role on a mesh exports, for every request, the pinned
    keys and every kv head in the one-device order: its K/V within 2e-5
    of the JAX package's prefill-role payload, its entry and geometry
    the same."""
    rank0, rank1 = cases["ranks"]
    got = rank0[f"pre_{mesh}"]
    assert got["reasons"] == ["prefilled"] * len(cases["prompts"])
    assert got["digest"] == rank1[f"pre_{mesh}"]["digest"]
    for mine, ref in zip(got["payloads"], cases["jax_one"]["native"]):
        assert tuple(mine) == S.KV_IMPORT_KEYS
        for key in ("block_shape", "n_blocks", "body_len", "dtype",
                    "kv_block", "kv_dtype"):
            assert mine[key] == ref[key], key
        assert mine["entry"]["prompt"] == ref["entry"]["prompt"]
        k, v, ks, vs = _kv(mine)
        rk, rv, _, _ = _kv(ref)
        assert ks is None and vs is None
        np.testing.assert_allclose(k, rk, rtol=0, atol=ATOL)
        np.testing.assert_allclose(v, rv, rtol=0, atol=ATOL)


def test_mesh_prefill_int8_scales_join_along_the_heads(cases):
    """int8 KV on ``tensor=2``: the values and their scales join along
    the same head axis, against the JAX package's int8 payload (a value
    may round one step the other way)."""
    for mine, ref in zip(cases["ranks"][0]["pre_tensor_int8"]["payloads"],
                         cases["jax_one"]["int8"]):
        assert mine["scale_dtype"] == ref["scale_dtype"] == "bfloat16"
        k, v, ks, vs = _kv(mine)
        rk, rv, rks, rvs = _kv(ref)
        assert np.abs(k - rk).max() <= 1 and np.abs(v - rv).max() <= 1
        for a, b in ((ks, rks), (vs, rvs)):
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=ATOL)


@pytest.mark.parametrize("mesh", ["tensor", "data"])
def test_mesh_payload_decodes_on_one_device(cases, model, mesh):
    """The mesh's payloads on the JAX package's one-device decode role and
    on the port's: greedy tokens equal to the JAX solo paged engine's."""
    cfg, tree, params = model
    payloads = cases["ranks"][0][f"pre_{mesh}"]["payloads"]
    port = _decode(S.SlotServer(params, cfg, device="cpu", role="decode",
                                **SRV), payloads)
    jax_ = _decode(jS.SlotServer(tree, TINY, role="decode", **SRV), payloads)
    assert port == jax_ == cases["want"]


@pytest.mark.parametrize("source", ["port_one", "jax_one"])
@pytest.mark.parametrize("mesh", ["tensor", "data"])
def test_one_device_payload_decodes_on_a_mesh(cases, mesh, source):
    """One-device payloads of either package imported on a mesh's decode
    role (each rank its heads, or the share owning the slot its blocks):
    greedy tokens equal to the JAX solo paged engine's; every rank
    imported, with the same host state."""
    ranks = cases["ranks"] if source == "port_one" else cases["ranks_jax"]
    rank0, rank1 = ranks
    got = rank0[f"dec_{mesh}"]
    assert got["tokens"] == cases["want"]
    assert got["imports"] == len(cases["prompts"])
    assert got["digest"] == rank1[f"dec_{mesh}"]["digest"]


def test_mesh_refusals_stay_on_rank_zero(cases):
    """A torn payload is refused on rank 0 and counted; a full pool is a
    QueueFullError with Retry-After; the followers never see either and
    keep rank 0's host state; the accepted imports still decode as the
    solo engine does."""
    rank0, rank1 = cases["ranks"]
    got = rank0["refuse_tensor"]
    assert all(e for e in got["torn"]), got["torn"]
    assert got["rejects"] == len(got["torn"])
    assert got["full_at"] == 2 and got["retry_after_s"] > 0
    assert got["tokens"] == cases["want"][:2]
    assert got["digest"] == rank1["refuse_tensor"]["digest"]


def test_full_pool_refuses_alike_on_every_rank(cases):
    """Imported on each rank alone, the full pool refuses at the same
    payload with a Retry-After on every rank, leaving the same state (the
    same slots and free blocks; the ids are each process's own)."""
    a, b = (r["full_tensor"] for r in cases["ranks"])
    assert a["full_at"] == b["full_at"] == 2
    assert a["retry_after_s"] > 0 and b["retry_after_s"] > 0
    assert a["digest"]["free_blocks"] == b["digest"]["free_blocks"]
    assert [s for _, s in a["digest"]["slots"]] == \
        [s for _, s in b["digest"]["slots"]] == [0, 1]


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("t", [1, 2, 4])
def test_head_split_and_join_round_trip(t, scaled):
    """join(split(x, r, t) for r) is x byte for byte; each slice is the
    rank's heads; the payload of the joined slices is the whole pool's."""
    gen = torch.Generator().manual_seed(t)
    shape = (2, 3, 4, 4, 8)                     # [L, n, kvH, B, D]
    if scaled:
        bufs = [torch.randint(-127, 128, shape, generator=gen,
                              dtype=torch.int8) for _ in range(2)]
        bufs += [torch.rand(shape[:4], generator=gen).to(torch.bfloat16)
                 for _ in range(2)]
    else:
        bufs = [torch.randn(shape, generator=gen) for _ in range(2)]
    parts = [S.split_kv_heads(bufs, r, t) for r in range(t)]
    for r, part in enumerate(parts):
        w = shape[2] // t
        for got, whole in zip(part, bufs):
            assert torch.equal(got, whole[:, :, r * w:(r + 1) * w])
    joined = S.join_kv_heads(parts)
    assert all(torch.equal(a, b) for a, b in zip(joined, bufs))
    meta = dict(model="m", kv_block=4, kv_dtype="int8" if scaled else
                "native", body_len=11, entry={})
    assert S._payload(joined, **meta) == S._payload(bufs, **meta)
    with pytest.raises(ValueError, match="do not split"):
        S.split_kv_heads(bufs, 0, 3)
