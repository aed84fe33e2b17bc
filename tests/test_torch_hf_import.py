"""Port parity: HF Llama/Mistral import (tony_tpu_torch.models.hf_import
``config_from_hf``, ``params_from_hf``, ``load_hf`` and its safetensors
reader; lm_generate's and serve's ``--hf-checkpoint``) against the JAX
package's import and the transformers models on the CPU.

Tiny random ``LlamaForCausalLM``/``MistralForCausalLM`` models are built
here from ``torch.manual_seed`` and written with ``save_pretrained``;
nothing is downloaded. The port reads the directory without transformers
or safetensors; the JAX package's ``load_hf`` reads it through
transformers. Both give float32 masters of the same values, so the port's
parameters equal the JAX import's exactly; logits are held to the
transformers model at the JAX package's tolerances (2e-4, 3e-4), and
greedy tokens equal the JAX ``generate``'s and transformers'
``generate(do_sample=False)`` (seed 0's prompt was checked for near-ties:
every step's top-2 gap above 1e-3). transformers is imported in a fixture
with TensorFlow and Flax off: collection stays free of its import."""

import dataclasses
import importlib
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import transformer as jT
from tony_tpu.models.hf_import import load_hf as jax_load_hf
from tony_tpu_torch.cli import serve
from tony_tpu_torch.examples import lm_generate
from tony_tpu_torch.models import generate as G
from tony_tpu_torch.models import hf_import as H
from tony_tpu_torch.models import transformer as T
from tony_tpu_torch.train.step import _leaves

jG = importlib.import_module("tony_tpu.models.generate")

BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64)


@pytest.fixture(scope="module")
def tfm():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


def _flat(tree, prefix=""):
    out = {}
    for name in sorted(tree):
        node = tree[name]
        if isinstance(node, dict):
            out.update(_flat(node, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = np.asarray(node)
    return out


def _save(tfm, path, cls, seed, **kw):
    """A random transformers model saved at ``path`` -> the model (eval)."""
    torch.manual_seed(seed)
    cfg_cls = {"llama": tfm.LlamaConfig, "mistral": tfm.MistralConfig}[cls]
    model_cls = {"llama": tfm.LlamaForCausalLM,
                 "mistral": tfm.MistralForCausalLM}[cls]
    hf = model_cls(cfg_cls(**{**BASE, **kw})).eval()
    hf.save_pretrained(path)
    return hf


@pytest.fixture(scope="module")
def llama(tfm, tmp_path_factory):
    path = tmp_path_factory.mktemp("llama")
    hf = _save(tfm, path, "llama", 0, rms_norm_eps=1e-6, rope_theta=10000.0)
    return path, hf


def _logits(params, cfg, ids):
    return T.apply(params, torch.from_numpy(ids).long(), cfg)[0].detach()


def test_hf_import_llama_parity(llama):
    """test_models.py:1004's counterpart: the port's import of the saved
    directory equals the JAX package's, its logits match transformers', and
    its greedy tokens equal the JAX generate's and transformers'."""
    path, hf = llama
    params, cfg = H.load_hf(path, dtype=torch.float32, device="cpu")
    jparams, jcfg = jax_load_hf(str(path), dtype=jnp.float32)
    assert dataclasses.asdict(cfg) == {
        **dataclasses.asdict(jcfg), "dtype": torch.float32,
        "param_dtype": torch.float32}
    want = _flat(jax.device_get(jparams))
    got = dict(_leaves(params))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)

    ids = np.random.default_rng(0).integers(0, 128, (2, 16))
    with torch.no_grad():
        hf_logits = hf(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(_logits(params, cfg, ids).numpy(), hf_logits,
                               rtol=2e-4, atol=2e-4)
    out = G.generate(params, cfg, torch.from_numpy(ids[:1]).long(), 8)
    ref = np.asarray(jG.generate(jparams, jcfg, jnp.asarray(ids[:1]), 8))
    np.testing.assert_array_equal(out.numpy(), ref)
    hf_out = hf.generate(torch.from_numpy(ids[:1]), max_new_tokens=8,
                         do_sample=False)[0, 16:].numpy()
    np.testing.assert_array_equal(out[0].numpy(), hf_out)


def test_hf_import_mistral_sliding_window_parity(tfm, tmp_path):
    """test_models.py:1040's counterpart: rms eps 1e-5 and the sliding
    window map onto norm_eps and attn_window (from the config object and
    from config.json alike); logits match at L > window."""
    hf = _save(tfm, tmp_path, "mistral", 1, rms_norm_eps=1e-5,
               sliding_window=8)
    cfg = H.config_from_hf(hf.config, dtype=torch.float32)
    assert cfg.attn_window == 8 and cfg.norm_eps == 1e-5
    assert cfg == H.config_from_hf(
        json.loads((tmp_path / "config.json").read_text()), torch.float32)
    params, cfg2 = H.load_hf(tmp_path, torch.float32, "cpu")
    assert cfg2 == cfg
    ids = np.random.default_rng(1).integers(0, 128, (2, 32))
    with torch.no_grad():
        hf_logits = hf(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(_logits(params, cfg, ids).numpy(), hf_logits,
                               rtol=3e-4, atol=3e-4)
    with pytest.raises(ValueError, match="unsupported model_type"):
        H.config_from_hf(tfm.GPT2Config())
    with pytest.raises(ValueError, match="unsupported model_type"):
        H.config_from_hf({"model_type": "gpt2"})


def test_hf_import_llama3_rope_scaling_parity(tfm):
    """test_models.py:1077's counterpart: the llama3 frequency rule matches
    transformers past the original context; other rope types are
    rejected."""
    scaling = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 32}
    hf_cfg = tfm.LlamaConfig(**{**BASE, "max_position_embeddings": 96},
                             rope_theta=10000.0, rope_scaling=scaling)
    torch.manual_seed(2)
    hf = tfm.LlamaForCausalLM(hf_cfg).eval()
    cfg = H.config_from_hf(hf_cfg, dtype=torch.float32)
    assert cfg.rope_scaling == ("llama3", 8.0, 1.0, 4.0, 32)
    params = H.params_from_hf(hf.state_dict(), cfg, device="cpu")
    ids = np.random.default_rng(2).integers(0, 128, (2, 80))
    with torch.no_grad():
        hf_logits = hf(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(_logits(params, cfg, ids).numpy(), hf_logits,
                               rtol=3e-4, atol=3e-4)
    with pytest.raises(ValueError, match="rope_scaling type"):
        H.config_from_hf(tfm.LlamaConfig(
            **BASE, rope_scaling={"rope_type": "yarn", "factor": 4.0}))


def test_hf_import_rejects_unimplemented_config_features(tfm):
    """test_models.py:1116's counterpart: attention and MLP biases are
    rejected in the config, bias tensors in the state dict."""
    with pytest.raises(ValueError, match="attention_bias"):
        H.config_from_hf(tfm.LlamaConfig(**BASE, attention_bias=True))
    with pytest.raises(ValueError, match="mlp_bias"):
        H.config_from_hf({**BASE, "model_type": "llama", "mlp_bias": True})
    ok_cfg = H.config_from_hf(tfm.LlamaConfig(**BASE), dtype=torch.float32)
    torch.manual_seed(0)
    sd = dict(tfm.LlamaForCausalLM(tfm.LlamaConfig(**BASE)).state_dict())
    sd["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(64)
    with pytest.raises(ValueError, match="bias"):
        H.params_from_hf(sd, ok_cfg, device="cpu")


def test_tied_embeddings_use_embed_transposed(tfm, tmp_path):
    """A tied model's directory has no lm_head.weight: the unembed is the
    embedding transposed, as in the JAX package's import."""
    _save(tfm, tmp_path, "llama", 3, tie_word_embeddings=True)
    assert "lm_head.weight" not in H.read_state_dict(tmp_path)
    params, _ = H.load_hf(tmp_path, torch.float32, "cpu")
    jparams, _ = jax_load_hf(str(tmp_path), dtype=jnp.float32)
    np.testing.assert_array_equal(params["unembed"].numpy(),
                                  params["embed"].numpy().T)
    np.testing.assert_array_equal(params["unembed"].numpy(),
                                  np.asarray(jparams["unembed"]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_safetensors_reader_matches_library(tfm, tmp_path, dtype):
    """The port's reader against safetensors.torch.load_file: one file of
    several dtypes and a zero-size tensor, and a model saved in ``dtype``
    as shards with an index (and as pytorch_model.bin)."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g).to(dtype),
               "b": torch.randn(7, generator=g).to(torch.bfloat16),
               "c": torch.randn(2, 2, 2, generator=g),
               "empty": torch.zeros(0, 4, dtype=dtype)}
    save_file(tensors, tmp_path / "one.safetensors",
              metadata={"format": "pt"})
    got = H.read_safetensors(tmp_path / "one.safetensors")
    want = load_file(tmp_path / "one.safetensors")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name

    torch.manual_seed(4)
    hf = tfm.LlamaForCausalLM(tfm.LlamaConfig(**BASE)).to(dtype)
    sharded = tmp_path / "sharded"
    hf.save_pretrained(sharded, max_shard_size="100KB")
    files = H.weight_files(sharded)
    assert len(files) > 1 and all(f.suffix == ".safetensors" for f in files)
    want = {}
    for f in files:
        want.update(load_file(f))
    got = H.read_state_dict(sharded)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    binary = tmp_path / "bin"
    hf.save_pretrained(binary, safe_serialization=False)
    assert [f.name for f in H.weight_files(binary)] == ["pytorch_model.bin"]
    got = H.read_state_dict(binary)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    with pytest.raises(FileNotFoundError):
        H.weight_files(tmp_path / "missing")


def test_lm_generate_hf_checkpoint(llama, tmp_path):
    """test_models.py:1145's counterpart (without --tensor-parallel):
    lm_generate --hf-checkpoint takes the checkpoint's dims and vocabulary,
    its tokens equal the JAX generate's on the JAX import, and
    --weight-dtype int8 decodes the same checkpoint; --checkpoint-dir is
    exclusive with it."""
    path, _ = llama
    jparams, jcfg = jax_load_hf(str(path), dtype=jnp.float32)
    want = np.asarray(jG.generate(jparams, jcfg, jnp.asarray([[1, 2, 3, 4]]),
                                  8))[0].tolist()
    for weight_dtype in ("native", "int8"):
        out = tmp_path / f"{weight_dtype}.json"
        rc = lm_generate.main(
            ["--device", "cpu", "--hf-checkpoint", str(path), "--dtype",
             "float32", "--prompt", "1 2 3 4", "--max-new", "8",
             "--weight-dtype", weight_dtype, "--metrics-out", str(out)])
        assert rc == 0
        m = json.loads(out.read_text())
        assert len(m["tokens"]) == 8 and m["hf_load_s"] > 0
        if weight_dtype == "native":
            assert m["tokens"] == want
        else:
            ref = jG.generate(jparams, jcfg, jnp.asarray([[1, 2, 3, 4]]), 8,
                              weight_dtype="int8")
            assert m["tokens"] == np.asarray(ref)[0].tolist()
    with pytest.raises(SystemExit, match="exclusive"):
        lm_generate.main(["--device", "cpu", "--hf-checkpoint", str(path),
                          "--checkpoint-dir", str(tmp_path)])


def test_serve_hf_checkpoint_over_http(llama, tmp_path):
    """serve --hf-checkpoint (ring, and --paged-kv with --weight-dtype
    int8) answers POST /generate with the tokens of a SlotServer on the
    port's import; --checkpoint-dir is exclusive with it."""
    path, _ = llama
    params, cfg = H.load_hf(path, torch.float32, "cpu")
    prompt = [5, 17, 42, 9, 3]
    for extra in ([], ["--paged-kv", "--kv-block", "8", "--weight-dtype",
                       "int8"]):
        args = serve.build_argparser().parse_args(
            ["--device", "cpu", "--port", "0", "--hf-checkpoint", str(path),
             "--dtype", "float32", "--slots", "2", "--max-len", "64",
             "--block-size", "4", "--prefill-chunk", "8"] + extra)
        app = serve.build_app(args)
        assert app.server.cfg == cfg
        app.start()
        httpd = serve.make_httpd(app, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"
            body = json.dumps({"prompt": prompt,
                               "max_new_tokens": 6}).encode()
            with urllib.request.urlopen(url, body, timeout=60) as resp:
                got = json.loads(resp.read())["tokens"]
        finally:
            httpd.shutdown()
            app.shutdown()
            thread.join(timeout=30)
        from tony_tpu_torch.models import serving as S

        ref = S.SlotServer(params, cfg, device="cpu", slots=2, max_len=64,
                           block_size=4, prefill_chunk=8,
                           paged=bool(extra), kv_block=8 if extra else 0,
                           weight_dtype="int8" if extra else "native")
        r = S.Request(prompt=prompt, max_new_tokens=6)
        ref.submit(r)
        assert got == ref.run_until_drained()[r.id].tokens, extra
    args = serve.build_argparser().parse_args(
        ["--device", "cpu", "--hf-checkpoint", str(path), "--checkpoint-dir",
         str(tmp_path)])
    with pytest.raises(SystemExit, match="exclusive"):
        serve.load_model(args)
