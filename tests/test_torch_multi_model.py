"""Port parity: multi-model serving (tony_tpu_torch.cli.serve ServeApp over
a {name: SlotServer} dict, the serve CLI's --model/--draft-model, one
journal across engines) against the JAX package on the CPU.

Parameters come from JAX ``transformer.init`` through ``from_jax_params``
(TINY widths, as tests/test_spec_serving.py); prompts from numpy; float32.

- Two models behind one app answer concurrently, each with its own
  greedy tokens (a solo generate of its weights); a nameless request gets
  the first; an unknown name raises (HTTP 400, /v1 included).
- /metrics has the ``serving_models`` info gauge, model-labeled series
  and a speculative engine's ``serving_spec_*`` families; /stats has
  ``models`` and ``registry`` with the JAX multi-model app's keys and
  JSON types.
- One engine's step failure does not strand another engine's drained
  completions; the journal carries the model through a restart, and the
  CLI resubmits each entry to its model's engine."""

import dataclasses
import json
import re
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.cli.serve import ServeApp as JServeApp
from tony_tpu.models import transformer as jT
from tony_tpu.models.registry import ModelRegistry as JModelRegistry
from tony_tpu.models.serving import SlotServer as JSlotServer
from tony_tpu_torch.cli import serve
from tony_tpu_torch.cli.serve import ServeApp, UnknownModelError
from tony_tpu_torch.events.journal import RequestJournal, read_journal
from tony_tpu_torch.models import generate as G
from tony_tpu_torch.models import serving as S
from tony_tpu_torch.models.convert import config_from_fields, from_jax_params
from tony_tpu_torch.models.registry import ModelRegistry

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, dtype=jnp.float32)
DRAFT = dict(vocab_size=256, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
             d_ff=64, max_seq_len=128, dtype=jnp.float32)
SRV = dict(slots=2, max_len=64, block_size=4, prefill_chunk=8)
PROMPT = [3, 5, 7, 9, 11]
MODEL_DIMS = ["--device", "cpu", "--vocab", "128", "--d-model", "32",
              "--n-layers", "2", "--n-heads", "2", "--d-ff", "64",
              "--dtype", "float32"]
CLI_DIMS = MODEL_DIMS + ["--slots", "2", "--max-len", "64", "--block-size",
                         "4", "--prefill-chunk", "8"]


def _model(fields, seed):
    jcfg = jT.TransformerConfig(**fields)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    tree = jax.device_get(jT.init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, tree, from_jax_params(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def models():
    return {"alpha": _model(TINY, 0), "beta": _model(TINY, 9),
            "mini": _model(DRAFT, 1)}


def _solo(m, prompt, n):
    _, cfg, _, params = m
    out = G.generate(params, cfg, torch.tensor([prompt]), n)
    return out[0].tolist()


def _app(models, spec_alpha=False, start=True, **kw):
    reg = ModelRegistry()
    for n in ("alpha", "beta"):
        reg.register(n, models[n][3], models[n][1], source=f"test:{n}")
    if spec_alpha:
        reg.register("mini", models["mini"][3], models["mini"][1])
        reg.get("alpha").draft = "mini"
        kw["spec_gamma"] = 2
    engines = {n: S.SlotServer(registry=reg, model=n, device="cpu",
                               **{**SRV, **kw}) for n in ("alpha", "beta")}
    app = ServeApp(engines)
    if start:
        app.start()
    return app


def _jax_app(models, spec_alpha=False):
    reg = JModelRegistry()
    for n in ("alpha", "beta"):
        reg.register(n, models[n][2], models[n][0], source=f"test:{n}")
    kw = {}
    if spec_alpha:
        reg.register("mini", models["mini"][2], models["mini"][0])
        reg.get("alpha").draft = "mini"
        kw["spec_gamma"] = 2
    engines = {n: JSlotServer(registry=reg, model=n, **SRV, **kw)
               for n in ("alpha", "beta")}
    app = JServeApp(engines)
    app.start()
    return app


class _Http:
    def __init__(self, app):
        self.httpd = serve.make_httpd(app, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def post(self, path, payload):
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                raw = r.read().decode()
                return r.status, raw
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=30) as r:
            return r.read().decode()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_two_models_concurrently_and_unknown(models):
    app = _app(models)
    try:
        wa, wb = _solo(models["alpha"], PROMPT, 6), _solo(models["beta"],
                                                          PROMPT, 6)
        assert wa != wb
        results = {}

        def call(name):
            results[name] = app.generate(PROMPT, 6, timeout=120, model=name)

        threads = [threading.Thread(target=call, args=(n,))
                   for n in ("alpha", "beta")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results["alpha"].tokens == wa
        assert results["beta"].tokens == wb
        assert app.generate(PROMPT, 6, timeout=120).tokens == wa
        with pytest.raises(UnknownModelError, match="nope"):
            app.generate(PROMPT, 4, timeout=10, model="nope")
        st = app.stats()
        assert set(st["models"]) == {"alpha", "beta"}
        assert st["slots"] == 4 and st["model"] == "alpha"
        assert st["models"]["beta"]["model"] == "beta"
        assert st["registry"] == ["alpha", "beta"]
    finally:
        app.shutdown()


def test_http_routes_by_model_and_400s_unknown(models):
    """/generate and /v1/completions route by ``model``, buffered and
    streamed; an unknown name is a 400 (/v1: invalid_request_error)."""
    app = _app(models)
    http = _Http(app)
    try:
        wa, wb = _solo(models["alpha"], PROMPT, 8), _solo(models["beta"],
                                                          PROMPT, 8)
        code, body = http.post("/generate", {"prompt": PROMPT,
                                             "max_new_tokens": 8,
                                             "model": "beta"})
        assert code == 200 and json.loads(body)["tokens"] == wb
        code, body = http.post("/generate", {"prompt": PROMPT,
                                             "max_new_tokens": 4,
                                             "model": "ghost"})
        assert code == 400 and "ghost" in json.loads(body)["error"]
        for name, want in (("alpha", wa), ("beta", wb)):
            code, body = http.post("/v1/completions", {
                "prompt": PROMPT, "max_tokens": 8, "model": name})
            out = json.loads(body)
            assert code == 200 and out["model"] == name
            assert out["choices"][0]["tokens"] == want
        code, raw = http.post("/v1/completions", {
            "prompt": PROMPT, "max_tokens": 8, "model": "beta",
            "stream": True})
        frames = [json.loads(x[6:]) for x in raw.split("\n")
                  if x.startswith("data: ") and x != "data: [DONE]"]
        assert [t for f in frames for t in f["choices"][0]["tokens"]] == wb
        code, body = http.post("/v1/completions", {
            "prompt": PROMPT, "max_tokens": 4, "model": "ghost"})
        assert code == 400
        assert json.loads(body)["error"]["type"] == "invalid_request_error"
    finally:
        http.close()
        app.shutdown()


def test_metrics_model_labels_and_spec_families(models):
    app = _app(models, spec_alpha=True)
    http = _Http(app)
    try:
        assert app.engines["alpha"]._spec
        assert not app.engines["beta"]._spec
        app.generate([1, 2, 3, 4], 4, timeout=120, model="alpha")
        app.generate([1, 2, 3, 4], 4, timeout=120, model="beta")
        text = http.get("/metrics")
        for needle in (
                'serving_models{model="alpha"} 1',
                'serving_models{model="beta"} 1',
                'serving_active_slots{model="alpha"}',
                'serving_queue_depth{model="beta"}',
                'serving_ttft_seconds_bucket{model="beta"',
                'serving_spec_rounds_total{model="alpha"}',
                'serving_spec_proposed_tokens_total{model="alpha"}',
                'serving_spec_accepted_tokens_total{model="alpha"}',
                'serving_spec_gamma{model="alpha"}',
                'serving_spec_acceptance_rate_bucket{model="alpha"',
                'serving_spec_verify_rounds_count{model="alpha"}'):
            assert needle in text, needle
        assert 'serving_spec_rounds_total{model="beta"}' not in text
        st = json.loads(http.get("/stats"))
        assert st["models"]["alpha"]["speculative"]["rounds"] > 0
        assert st["models"]["alpha"]["speculative"]["draft_model"] == "mini"
        assert "speculative" not in st["models"]["beta"]
        rounds = re.search(r'serving_spec_rounds_total\{model="alpha"\} (\d+)',
                           text)
        assert int(rounds.group(1)) == \
            st["models"]["alpha"]["speculative"]["rounds"]
    finally:
        http.close()
        app.shutdown()


def _shape(v, path="", out=None):
    """{dotted key: JSON type} of a /stats payload (the histogram
    snapshots under ``latency``, ``device.dispatch_ready`` and a model's
    ``latency`` by their shared shape; lists by their first element)."""
    out = {} if out is None else out
    if isinstance(v, dict):
        for k, x in v.items():
            key = f"{path}.{k}" if path else k
            if re.fullmatch(r"(models\.\w+\.)?(latency|device\.dispatch_"
                            r"ready)", path):
                key = f"{path}.*"
            _shape(x, key, out)
    elif isinstance(v, list):
        out[path] = "list"
        if v:
            _shape(v[0], path + "[]", out)
    else:
        out[path] = type(v).__name__
    return out


# /stats keys of one side only (as test_torch_serving_telemetry.py's
# lists), here also inside each model's payload
PORT_ONLY = {"torch_device", "replay", "decode_block_dispatch_ms_p50",
             "journal.compactions"}
JAX_ONLY = {"compile"}


def test_stats_keys_and_types_equal_jax_multi_model_app(models):
    """One request to each model through the port's two-engine app (one
    speculating) and the JAX package's: /stats has the same keys, the
    ``models`` partition and each engine's ``speculative`` section
    included, with the same JSON types, less the keys one side alone
    has."""
    ours_app, ref_app = _app(models, spec_alpha=True), _jax_app(
        models, spec_alpha=True)
    try:
        for app in (ours_app, ref_app):
            for name in ("alpha", "beta"):
                assert len(app.generate(PROMPT, 5, timeout=120,
                                        model=name).tokens) == 5
        ours, ref = ours_app.stats(), ref_app.stats()
    finally:
        ours_app.shutdown()
        ref_app.shutdown()
    assert set(ours["models"]) == set(ref["models"]) == {"alpha", "beta"}
    assert ours["registry"] == ref["registry"] == ["alpha", "beta", "mini"]
    a, b = _shape(ours), _shape(ref)

    def strip(keys, declared):
        keep = set()
        for k in keys:
            base = re.sub(r"^models\.\w+\.", "", k)
            if not any(base == r or base.startswith((r + ".", r + "["))
                       for r in declared):
                keep.add(k)
        return keep

    assert not strip(set(a) - set(b), PORT_ONLY)
    assert not strip(set(b) - set(a), JAX_ONLY)
    wrong = {k: (a[k], b[k]) for k in set(a) & set(b) if a[k] != b[k]}
    assert not wrong, wrong
    assert "models.alpha.speculative.acceptance_ewma" in a


def test_drained_completions_survive_the_other_engines_crash(models):
    app = _app(models, start=False)
    beta = app.engines["beta"]
    orig_step, state = beta.step, {"fired": False}

    def boom():
        if not state["fired"]:
            state["fired"] = True
            raise RuntimeError("chaos: beta step died")
        return orig_step()

    beta.step = boom
    app.start()
    try:
        wa = _solo(models["alpha"], PROMPT, 4)
        results = {}

        def call(name):
            try:
                results[name] = app.generate(PROMPT, 4, timeout=120,
                                             model=name)
            except Exception as e:          # beta may fail its request
                results[name] = e

        threads = [threading.Thread(target=call, args=(n,))
                   for n in ("alpha", "beta")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=150)
        assert state["fired"]
        assert not isinstance(results["alpha"], Exception), results["alpha"]
        assert results["alpha"].tokens == wa
        assert not isinstance(results["beta"], TimeoutError)
        # beta's engine alone was reset; alpha's was not
        assert beta.resets == 1 and app.engines["alpha"].resets == 0
    finally:
        app.shutdown()


def test_journal_model_field_roundtrip(tmp_path):
    path = tmp_path / "requests.journal.jsonl"
    j = RequestJournal(path=path)
    j.submit(1, [1, 2], 8, model="alpha")
    j.emit(1, [5])
    j.submit(2, [3], 4, model="beta")
    j.submit(3, [4], 4)                 # a record with no model
    j.close()
    j2, entries = RequestJournal.recover(path)
    by_id = {e.id: e for e in entries}
    assert by_id[1].model == "alpha" and by_id[1].emitted == [5]
    assert by_id[2].model == "beta" and by_id[3].model is None
    j2.close()


def test_cli_registry_and_shared_journal_recovery(tmp_path, capsys):
    """``serve --model a=random:0 --model b=ckpt:<dir>``: two engines, the
    checkpoint's weights on b; a dead process's journal entries go back
    to their own models' engines (the one with no model to the default),
    an entry of a model no longer served is dropped, and the shared file
    compacts once, to the live resubmissions."""
    from tony_tpu_torch.examples import lm_train

    ck = tmp_path / "ck"
    lm_train.main(MODEL_DIMS + [
        "--steps", "3", "--batch-size", "2", "--seq-len", "16",
        "--checkpoint-dir", str(ck), "--checkpoint-every", "3"])
    trace = tmp_path / "tr"
    trace.mkdir()
    dead = RequestJournal(path=trace / "requests.journal.jsonl")
    dead.submit(9001, [1, 2, 3], 8, model="a")
    dead.emit(9001, [5, 6])
    dead.submit(9002, [4, 5, 6], 8, model="b")
    dead.submit(9003, [7, 8], 4)
    dead.submit(9004, [9], 4, model="gone")
    dead.close()
    args = serve.build_argparser().parse_args(CLI_DIMS + [
        "--model", "a=random:0", "--model", f"b=ckpt:{ck}",
        "--trace-dir", str(trace)])
    app = serve.build_app(args)
    try:
        out = capsys.readouterr().out
        assert "resumed 2 unfinished request(s) for model 'a'" in out
        assert "resumed 1 unfinished request(s) for model 'b'" in out
        assert "['gone']" in out
        assert list(app.engines) == ["a", "b"]
        assert app.engines["a"].pending == 2 and app.engines["b"].pending == 1
        assert len(read_journal(trace / "requests.journal.jsonl")) == 3
        ckpt = serve.load_model(serve.build_argparser().parse_args(
            CLI_DIMS + ["--checkpoint-dir", str(ck)]))[0]
        assert torch.equal(app.engines["b"]._params["embed"],
                           ckpt["embed"])
        assert not torch.equal(app.engines["a"]._params["embed"],
                               ckpt["embed"])
        app.start()
        b_tok = app.generate([1, 2, 3], 4, timeout=120, model="b").tokens
        params, cfg = serve.load_named_model(f"ckpt:{ck}", args)
        assert b_tok == G.generate(params, cfg, torch.tensor([[1, 2, 3]]),
                                   4)[0].tolist()
    finally:
        app.shutdown()


@pytest.mark.parametrize("flags,match", [
    (["--model", "a=random", "--checkpoint-dir", "/x"], "exclusive"),
    (["--model", "noequals"], "NAME=SPEC"),
    (["--model", "draft=random:1", "--draft-model", "random:2"],
     "reserved name 'draft'"),
    (["--model", "a=random:1", "--draft-model", "a"], "its own draft"),
])
def test_cli_registry_rejections(flags, match):
    args = serve.build_argparser().parse_args(CLI_DIMS + flags)
    with pytest.raises(SystemExit, match=match):
        serve.build_registry(args)


def test_cli_self_draft_and_random_spec(models):
    """``--model main=random:S --model twin=random:S --draft-model twin``
    speculates with an identical draft (acceptance 1); ``--draft-model
    random`` with one at the --draft-* dims; both answer the spec-off
    server's tokens, and the draft gets no engine."""
    base = serve.build_app(serve.build_argparser().parse_args(
        CLI_DIMS + ["--model", "main=random:3"]))
    twin = serve.build_app(serve.build_argparser().parse_args(
        CLI_DIMS + ["--model", "main=random:3", "--model", "twin=random:3",
                    "--draft-model", "twin", "--spec-gamma", "2"]))
    rnd = serve.build_app(serve.build_argparser().parse_args(
        CLI_DIMS + ["--model", "main=random:3", "--draft-model", "random:5",
                    "--draft-d-model", "32", "--draft-n-layers", "1",
                    "--draft-n-heads", "1"]))
    apps = (base, twin, rnd)
    try:
        assert list(twin.engines) == list(rnd.engines) == ["main"]
        assert twin.server.draft_model == "twin"
        assert rnd.server.draft_model == "draft"
        assert rnd.server._draft_cfg.head_dim == 32
        for app in apps:
            app.start()
        prompts = [[1, 2, 3, 4, 5, 6], [9, 8, 7], [11, 30, 2, 2], [5]]

        def burst(app):         # concurrent, so both slots speculate
            waits = [app.submit_async(p, 16, timeout=120) for p in prompts]
            for _, ev in waits:
                assert ev.wait(120)
            return [app.take_result(rid).tokens for rid, _ in waits]

        want = burst(base)
        assert burst(twin) == want and burst(rnd) == want
        ewma = {n: a.stats()["speculative"]["acceptance_ewma"]
                for n, a in (("twin", twin), ("rnd", rnd))}
        assert ewma["twin"] > 0.8 and ewma["rnd"] < 0.6
        assert twin.stats()["speculative"]["gamma_pinned"] is True
    finally:
        for app in apps:
            app.shutdown()
