"""The port's disaggregated prefill/decode roles (tony_tpu_torch.models.
serving ``role=``, ``serialize_kv_blocks`` / ``deserialize_kv_blocks``,
``export_blocks`` / ``import_blocks``; serve's ``--role``, POST /kv/import
and the ``"handoff"`` of a prefilled /generate) on the CPU, against the
JAX package.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``
(TINY widths, float32); prompts come from numpy.

- The wire format is the JAX package's byte for byte: the same pool
  blocks serialize to equal payloads (checksums included) in both
  packages, at float32, bf16 and int8 with bf16 scales, and each package
  decodes the other's.
- The cases of tests/test_paged_kv.py:316 (the role carve-outs), :365,
  :397, :428 and :477 and of tests/test_streaming.py:297 and :865 hold on
  the port: prefill on one engine, decode on another, token-identical to
  a solo paged engine; damage is a counted ValueError that leaves the
  pool untouched; a full replica is QueueFullError, never a queue.
- Across frameworks: a JAX prefill-role export decodes on a port decode
  replica, and a port export on a JAX one, each token-identical to the
  JAX ring engine at float32, native KV and int8 alike (both packages
  quantize by the same rule; at other seeds int8 may part at a near-tie,
  the ROADMAP's carve-out). The JAX paged engine is not the reference
  here: it re-admits into a slot whose predecessor it has not processed
  and then flakes under load (ROADMAP.md, reference-side facts).
- A payload exported after later prefills reused its blocks is still the
  one its prompt wrote (the snapshot is taken before the blocks free)."""

import base64
import dataclasses
import inspect
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tony_tpu.models import serving as jS
from tony_tpu.models import transformer as jT
from tony_tpu.models.generate import PrefixPool as JPrefixPool
from tony_tpu_torch.cli import serve
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.models.generate import PrefixPool

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=jnp.float32)
SRV = dict(slots=2, max_len=64, block_size=4, prefill_chunk=8)
TINY_FLAGS = ["--device", "cpu", "--d-model", "32", "--n-layers", "1",
              "--n-heads", "2", "--d-ff", "64", "--vocab", "64",
              "--dtype", "float32", "--slots", "2", "--max-len", "32",
              "--block-size", "4", "--prefill-chunk", "8"]


@pytest.fixture(scope="module")
def model():
    jcfg = jT.TransformerConfig(**TINY)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


def _prompt(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.int32)


def _mk(model, **kw):
    _, cfg, _, params = model
    return S.SlotServer(params, cfg, device="cpu", **{**SRV, **kw})


def _jmk(model, **kw):
    jcfg, _, tree, _ = model
    return jS.SlotServer(tree, jcfg, **{**SRV, **kw})


def _run(srv, prompts, max_new=8, Req=S.Request):
    reqs = [Req(prompt=p, max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        srv.submit(r)
    done = srv.run_until_drained()
    return [done[r.id].tokens for r in reqs]


def _export_one(pre, prompt, max_new=8, Req=S.Request):
    """Prefill one request on a prefill-role engine -> its payload."""
    r = Req(prompt=prompt, max_new_tokens=max_new)
    pre.submit(r)
    comp = pre.run_until_drained()[r.id]
    assert comp.finish_reason == "prefilled" and comp.tokens == []
    return pre.export_blocks(r.id)


def _wire(payload):
    return json.loads(json.dumps(payload))


# --------------------------------------------------------------------------
# the wire format against the JAX package's
# --------------------------------------------------------------------------

def test_kv_transfer_keys_pinned_to_jax():
    """tests/test_streaming.py:297: the payload and entry keys are the
    JAX package's tuples, and serve speaks the route, the role and the
    handoff."""
    assert S.KV_TRANSFER_VERSION == jS.KV_TRANSFER_VERSION
    assert S.KV_IMPORT_KEYS == jS.KV_IMPORT_KEYS
    assert S.KV_ENTRY_KEYS == jS.KV_ENTRY_KEYS
    src = inspect.getsource(serve)
    for word in ('"/kv/import"', '"role"', '"handoff"', '"/debug/profile"'):
        assert word in src, word


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_serialize_bytes_equal_jax(kind):
    """The same pool blocks through both packages' serializers: equal
    payloads, checksum included; each package decodes the other's to the
    same values."""
    rng = np.random.default_rng(5)
    shape = (2, 7, 2, 4, 16)                  # [L, n, kvH, B, D]
    ids = [5, 0, 3]
    if kind == "int8":
        k = rng.integers(-127, 128, shape, dtype=np.int8)
        v = rng.integers(-127, 128, shape, dtype=np.int8)
        ks = rng.uniform(1e-3, 2e-2, shape[:4]).astype(ml_dtypes.bfloat16)
        vs = rng.uniform(1e-3, 2e-2, shape[:4]).astype(ml_dtypes.bfloat16)
    else:
        dt = np.float32 if kind == "float32" else ml_dtypes.bfloat16
        k = rng.standard_normal(shape).astype(dt)
        v = rng.standard_normal(shape).astype(dt)
        ks = vs = None

    def t(x):
        if x is None:
            return None
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(x)

    entry = {"id": 3, "prompt": [1, 2, 3], "max_new_tokens": 4}
    meta = dict(model="default", kv_block=4, kv_dtype="int8" if ks is not
                None else "native", body_len=11, entry=entry)
    ours = S.serialize_kv_blocks(PrefixPool(t(k), t(v), t(ks), t(vs)), ids,
                                 **meta)
    ref = jS.serialize_kv_blocks(
        JPrefixPool(jnp.asarray(k), jnp.asarray(v),
                    None if ks is None else jnp.asarray(ks),
                    None if vs is None else jnp.asarray(vs)), ids, **meta)
    assert ours == ref
    assert set(ours) == set(S.KV_IMPORT_KEYS)
    pk, pv, pks, pvs = S.deserialize_kv_blocks(_wire(ref))
    jk, jv, jks, jvs = jS.deserialize_kv_blocks(_wire(ours))
    for got, want in ((pk, k[:, ids]), (pv, v[:, ids]),
                      (pks, None if ks is None else ks[:, ids]),
                      (pvs, None if vs is None else vs[:, ids])):
        if want is None:
            assert got is None
        else:
            assert torch.equal(got, t(np.ascontiguousarray(want)))
    for got, want in ((jk, k[:, ids]), (jv, v[:, ids])):
        np.testing.assert_array_equal(got, want)


def test_kv_block_serialize_roundtrip_f32_and_int8(model):
    """tests/test_paged_kv.py:365: an engine's export decodes exactly,
    scales too, and a JSON round trip changes nothing."""
    for kv_dtype in ("native", "int8"):
        pre = _mk(model, paged=True, role="prefill", kv_dtype=kv_dtype)
        payload = _export_one(pre, _prompt(11, seed=41))
        assert set(payload) == set(S.KV_IMPORT_KEYS)
        assert set(payload["entry"]) == set(S.KV_ENTRY_KEYS)
        k, v, ks, vs = S.deserialize_kv_blocks(payload)
        assert k.shape == v.shape and k.shape[1] == payload["n_blocks"]
        if kv_dtype == "int8":
            assert k.dtype == torch.int8 and ks.dtype == torch.bfloat16
            assert ks.shape == k.shape[:4] and vs.shape == k.shape[:4]
        else:
            assert ks is None and vs is None
        again = S.deserialize_kv_blocks(_wire(payload))
        for a, b in zip((k, v, ks, vs), again):
            assert (a is None and b is None) or torch.equal(a, b)
        pre.shutdown()


# --------------------------------------------------------------------------
# the engines (tests/test_paged_kv.py:316, :397, :428, :477)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(paged=True, role="verifier"), "role"),
    (dict(role="prefill"), "paged"),
], ids=["unknown", "prefill_without_paged"])
def test_role_carveouts(model, kw, match):
    with pytest.raises(ValueError, match=match):
        _mk(model, **kw)


def test_serve_role_flag(model):
    """serve --role reaches the engine; --role prefill needs --paged-kv;
    an unknown role is an argparse error."""
    args = serve.build_argparser().parse_args(
        TINY_FLAGS + ["--paged-kv", "--role", "prefill"])
    srv = serve.build_server(args)
    assert srv.role == "prefill" and srv.stats()["role"] == "prefill"
    srv.shutdown()
    with pytest.raises(ValueError, match="paged"):
        serve.build_server(serve.build_argparser().parse_args(
            TINY_FLAGS + ["--role", "prefill"]))
    with pytest.raises(SystemExit):
        serve.build_argparser().parse_args(TINY_FLAGS + ["--role", "x"])


def test_export_import_byte_identity_and_refcounts(model):
    """Prefill on one engine, decode on another: tokens identical to a
    solo paged engine. The exporter's pool drains back to free (the
    snapshot leaves the pool), both allocators pass check(), and the
    importer's pool states partition its pool."""
    prompts = [_prompt(9, seed=11), _prompt(13, seed=12)]
    solo = _run(_mk(model, paged=True), prompts)
    pre = _mk(model, paged=True, role="prefill")
    dec = _mk(model, paged=True, role="decode")
    total = pre.stats()["paged_kv"]["pool_blocks_total"]
    payloads = [_export_one(pre, p) for p in prompts]
    st = pre.stats()["paged_kv"]
    assert st["kv_exports"] == 2
    assert st["pool_blocks_free"] == total, "export must free the blocks"
    pre._allocator.check()
    rids = [dec.import_blocks(_wire(pl)) for pl in payloads]
    done = dec.run_until_drained()
    assert [done[r].tokens for r in rids] == solo
    assert dec.stats()["paged_kv"]["kv_imports"] == 2
    dec._allocator.check()
    ps = dec.stats()["paged_kv"]["pool_state"]
    assert set(ps) == {"free", "slot", "trie", "shared"}
    assert sum(ps.values()) == dec.stats()["paged_kv"]["pool_blocks_total"]
    with pytest.raises(KeyError):
        pre.export_blocks(12345)            # never prefilled here


def test_export_survives_the_blocks_reuse(model):
    """One slot on the prefill replica, so each prefill reuses the blocks
    the one before freed; exported only after all three, every payload
    still decodes to the solo engine's tokens."""
    prompts = [_prompt(n, seed=20 + n) for n in (9, 14, 6)]
    solo = _run(_mk(model, paged=True), prompts)
    pre = _mk(model, paged=True, role="prefill", slots=1,
              kv_pool_blocks=8)
    reqs = [S.Request(prompt=p, max_new_tokens=8) for p in prompts]
    for r in reqs:
        pre.submit(r)
    done = pre.run_until_drained()
    assert {c.finish_reason for c in done.values()} == {"prefilled"}
    payloads = [pre.export_blocks(r.id) for r in reqs]
    dec = _mk(model, paged=True, slots=3)
    rids = [dec.import_blocks(pl) for pl in payloads]
    done = dec.run_until_drained()
    assert [done[r].tokens for r in rids] == solo


def test_import_rejects_damage_loudly_then_replays(model):
    """Every damage mode is a ValueError counted in kv_import_rejects,
    the importer's pool untouched; the fallback (a re-prefill from the
    entry's prompt) completes as solo does."""
    prompt = _prompt(10, seed=51)
    solo = _run(_mk(model, paged=True), [prompt])
    pre = _mk(model, paged=True, role="prefill")
    dec = _mk(model, paged=True, role="decode")
    payload = _export_one(pre, prompt)
    free0 = dec.stats()["paged_kv"]["pool_blocks_free"]
    damaged = []
    for key, value in (("version", 99), ("model", "other-model"),
                       ("kv_block", 16), ("entry", None),
                       ("dtype", "float64"), ("n_blocks", 7)):
        damaged.append(dict(payload, **{key: value}))
    damaged.append(dict(payload, blocks_k=payload["blocks_k"][:-24]))
    raw = bytearray(base64.b64decode(payload["blocks_v"]))
    raw[0] ^= 0xFF                                  # a flipped bit
    damaged.append(dict(payload, blocks_v=base64.b64encode(bytes(raw))
                        .decode()))
    damaged.append(dict(payload, entry=dict(payload["entry"],
                                            prompt=[1, 2])))
    damaged.append(dict(payload, entry=dict(payload["entry"],
                                            prompt=[999] * 10)))
    for bad in damaged + ["not a dict"]:
        with pytest.raises(ValueError):
            dec.import_blocks(bad)
    st = dec.stats()["paged_kv"]
    assert st["kv_import_rejects"] == len(damaged) + 1
    assert st["kv_imports"] == 0
    assert st["pool_blocks_free"] == free0, "a rejected import leaked"
    dec._allocator.check()
    with pytest.raises(ValueError, match="prefill-role"):
        pre.import_blocks(payload)
    with pytest.raises(ValueError, match="paged"):
        _mk(model).import_blocks(payload)
    entry = payload["entry"]
    assert _run(dec, [np.asarray(entry["prompt"], np.int32)],
                entry["max_new_tokens"]) == solo
    dec._allocator.check()


def test_import_backpressure_is_queue_full(model):
    """A handoff needs a seat now: with both slots busy, import_blocks
    raises QueueFullError with a Retry-After estimate instead of
    queueing; with the pool short of blocks too; neither is damage."""
    pre = _mk(model, paged=True, role="prefill")
    dec = _mk(model, paged=True, role="decode")
    payloads = [_export_one(pre, _prompt(9 + i, seed=60 + i), max_new=24)
                for i in range(3)]
    dec.import_blocks(payloads[0])
    dec.import_blocks(payloads[1])              # both slots busy
    with pytest.raises(S.QueueFullError) as ei:
        dec.import_blocks(payloads[2])
    assert ei.value.retry_after_s > 0
    dec.run_until_drained()
    small = _mk(model, paged=True, kv_pool_blocks=9)
    small.import_blocks(payloads[0])             # 9 blocks of 4 tokens
    with pytest.raises(S.QueueFullError, match="pool blocks"):
        small.import_blocks(payloads[1])
    for eng in (dec, small):
        assert eng.stats()["paged_kv"]["kv_import_rejects"] == 0
        eng.run_until_drained()
        eng._allocator.check()


# --------------------------------------------------------------------------
# across frameworks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_handoff_across_frameworks(model, direction, kv_dtype):
    """A prefill-role export of one package decodes on the other's decode
    replica (through JSON, as over the wire; three slots for three
    imports, so no slot is re-admitted), token-identical to the JAX ring
    engine."""
    kw = dict(paged=True, kv_dtype=kv_dtype)
    prompts = [_prompt(n, seed=70 + n) for n in (5, 12, 17)]
    want = _run(_jmk(model, kv_dtype=kv_dtype), prompts, Req=jS.Request)
    if direction == "jax_to_port":
        pre, Req, dec = _jmk(model, role="prefill", **kw), jS.Request, \
            _mk(model, role="decode", slots=3, **kw)
    else:
        pre, Req, dec = _mk(model, role="prefill", **kw), S.Request, \
            _jmk(model, role="decode", slots=3, **kw)
    payloads = [_wire(_export_one(pre, p, Req=Req)) for p in prompts]
    rids = [dec.import_blocks(pl) for pl in payloads]
    done = dec.run_until_drained()
    assert [done[r].tokens for r in rids] == want
    for eng in (pre, dec):
        eng._allocator.check()
        eng.shutdown()


# --------------------------------------------------------------------------
# over HTTP (tests/test_streaming.py:865)
# --------------------------------------------------------------------------

def _app(model, start=True, **kw):
    """A ServeApp over a port engine behind HTTP; ``start=False`` leaves
    its serving loop off, so what is admitted stays put."""
    _, cfg, _, params = model
    app = serve.ServeApp(S.SlotServer(params, cfg, device="cpu",
                                      **{**SRV, **kw}))
    httpd = serve.make_httpd(app, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    if start:
        app.start()
    return app, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.headers, r.read().decode()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def test_kv_import_http_two_legs_byte_identical(model):
    """POST /generate on a prefill replica answers "prefilled" with the
    handoff in the same body; that body verbatim on a decode replica's
    /kv/import resumes as the solo engine decodes, buffered and with
    ?stream=true; a torn payload is a 400, a full replica a 429 with
    Retry-After; the roles and the transfer counters are on /stats and
    /metrics alike."""
    prompt = [int(t) for t in _prompt(7, seed=91)]
    (solo,) = _run(_mk(model, paged=True), [np.asarray(prompt)], 10)
    pre = _app(model, paged=True, role="prefill")
    dec = _app(model, paged=True, role="decode")
    full = _app(model, start=False, paged=True, role="decode", slots=1)
    try:
        for (_, _, url), role in ((pre, "prefill"), (dec, "decode")):
            assert json.loads(_get(url + "/stats"))["role"] == role

        def leg1():
            _, _, text = _post(pre[2] + "/generate",
                               {"prompt": prompt, "max_new_tokens": 10})
            body = json.loads(text)
            assert body["finish_reason"] == "prefilled"
            assert body["tokens"] == []
            assert set(body["handoff"]) == set(S.KV_IMPORT_KEYS)
            return body["handoff"]

        code, headers, text = _post(dec[2] + "/kv/import", leg1())
        body = json.loads(text)
        assert (code, body["tokens"], body["finish_reason"]) == \
            (200, solo, "length")
        assert headers["X-Tony-Trace-Id"]
        _, _, text = _post(dec[2] + "/kv/import?stream=true&timeout_s=60",
                           leg1())
        frames = [json.loads(line[len("data: "):])
                  for line in text.splitlines() if line.startswith("data: ")]
        assert [t for f in frames[:-1] for t in f["tokens"]] == solo
        assert frames[-1]["finish_reason"] == "length"
        torn = leg1()
        torn["blocks_k"] = torn["blocks_k"][:-24]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(dec[2] + "/kv/import", torn)
        assert ei.value.code == 400
        # a replica whose one slot holds an import (its loop is off, so
        # the slot stays held): the next import is a 429, never queued
        handoff = leg1()
        full[0].server.import_blocks(handoff)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(full[2] + "/kv/import", handoff)
        assert ei.value.code == 429 and int(ei.value.headers["Retry-After"])
        assert full[0].server.stats()["paged_kv"]["kv_import_rejects"] == 0
        for url, want in ((dec[2], {"serving_kv_imports_total": 2,
                                    "serving_kv_import_rejects_total": 1}),
                          (pre[2], {"serving_kv_exports_total": 4})):
            text = _get(url + "/metrics")
            pk = json.loads(_get(url + "/stats"))["paged_kv"]
            for fam, n in want.items():
                assert f"{fam} {n}" in text, fam
                key = fam[len("serving_"):-len("_total")]
                assert pk[key] == n, key
    finally:
        for app, httpd, _ in (pre, dec, full):
            httpd.shutdown()
            httpd.server_close()
        pre[0].shutdown()
        dec[0].shutdown()
        full[0].server.shutdown()       # its loop never started
