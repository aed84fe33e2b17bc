"""Import HuggingFace Llama and Mistral checkpoints into the flagship model
(port of the JAX package's models/hf_import.py).

The flagship transformer is the Llama graph (rotate-half RoPE, GQA,
SwiGLU, pre-RMSNorm), so a Llama or Mistral checkpoint maps onto it by
transposing weights alone:

    from tony_tpu_torch.models.hf_import import load_hf

    params, cfg = load_hf("/path/to/llama")   # float32 masters on the card
    out = generate(params, cfg, prompt, 64)

Supported: ``model_type`` "llama" and "mistral", tied embeddings, GQA,
Mistral's sliding window (-> ``cfg.attn_window``) and Llama-3.x
``rope_scaling`` (rope type "llama3" -> ``cfg.rope_scaling``). Other rope
types, attention or MLP biases and bias tensors are rejected: importing
them would serve wrong logits.

Layouts (HF's nn.Linear stores [out, in]; the flagship stores [in, out]):
  q_proj [H*hd, d] -> wq [d, H, hd]        o_proj [d, H*hd] -> wo [H, hd, d]
  k/v_proj [kvH*hd, d] -> wk/wv [d, kvH, hd]
  gate/up_proj [f, d] -> w_gate/w_up [d, f]  down_proj [d, f] -> w_down [f, d]
  lm_head [V, d] -> unembed [d, V] (embed transposed when it is absent)

``load_hf`` reads a checkpoint directory without ``transformers`` or
``safetensors``: ``config.json``, then ``model.safetensors`` or the shards
``model.safetensors.index.json`` names (else ``pytorch_model.bin`` or its
index, through ``torch.load(weights_only=True)``). A safetensors file is
an 8-byte little-endian header length, a JSON header of names, dtypes,
shapes and byte offsets, then the raw bytes; ``read_safetensors`` maps the
file privately and builds each tensor with ``torch.frombuffer`` over the
map, so the file is read once, by the copy to the device.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
from pathlib import Path
from typing import Any, Mapping

import torch

from ..device import resolve_device
from .transformer import TransformerConfig

_SUPPORTED = ("llama", "mistral")
# the safetensors dtype names a Llama-family checkpoint uses
_SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
                       "F32": torch.float32}


def _get(hf_config: Any, key: str, default=None):
    """A field of a config.json mapping or of a transformers config."""
    if isinstance(hf_config, Mapping):
        return hf_config.get(key, default)
    return getattr(hf_config, key, default)


def config_from_hf(hf_config: Any,
                   dtype: torch.dtype = torch.bfloat16) -> TransformerConfig:
    """A LlamaConfig or MistralConfig (or its config.json as a mapping) ->
    TransformerConfig."""
    mt = _get(hf_config, "model_type", "")
    if mt not in _SUPPORTED:
        raise ValueError(
            f"unsupported model_type {mt!r}; supported: {_SUPPORTED} "
            "(the flagship graph is Llama-shaped: RoPE/GQA/SwiGLU/RMSNorm)")
    scaling = _get(hf_config, "rope_scaling")
    rope_scaling = None
    if scaling:
        kind = scaling.get("rope_type", scaling.get("type", ""))
        if kind != "llama3":
            raise ValueError(
                f"rope_scaling type {kind!r} is not supported (implemented: "
                "'llama3'); importing would serve wrong logits at long "
                "positions")
        rope_scaling = ("llama3", float(scaling["factor"]),
                        float(scaling["low_freq_factor"]),
                        float(scaling["high_freq_factor"]),
                        int(scaling["original_max_position_embeddings"]))
    for attr in ("attention_bias", "mlp_bias"):
        if _get(hf_config, attr, False):
            raise ValueError(
                f"{attr}=True is not supported: the flagship graph has no "
                "bias terms, so the checkpoint's bias tensors would be "
                "silently dropped")
    heads = _get(hf_config, "num_attention_heads")
    return TransformerConfig(
        vocab_size=_get(hf_config, "vocab_size"),
        d_model=_get(hf_config, "hidden_size"),
        n_layers=_get(hf_config, "num_hidden_layers"),
        n_heads=heads,
        n_kv_heads=_get(hf_config, "num_key_value_heads", heads),
        d_ff=_get(hf_config, "intermediate_size"),
        max_seq_len=_get(hf_config, "max_position_embeddings", 2048),
        rope_theta=_get(hf_config, "rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        norm_eps=_get(hf_config, "rms_norm_eps", 1e-6),
        attn_window=int(_get(hf_config, "sliding_window") or 0),
        dtype=dtype)


def params_from_hf(state_dict: Mapping[str, torch.Tensor],
                   cfg: TransformerConfig, device=None) -> dict:
    """HF state_dict -> the flagship's parameter dict of float32 masters on
    ``device`` (None: the card), layer weights stacked [n_layers, ...] as
    transformer.init builds them. Each tensor moves in its own dtype and
    converts on the device."""
    bias_keys = [k for k in state_dict if k.endswith(".bias")]
    if bias_keys:
        raise ValueError(
            f"checkpoint has bias tensors the flagship graph cannot consume "
            f"(e.g. {bias_keys[0]!r}); importing would drop them silently")
    device = resolve_device(device)
    hd, d, L = cfg.head_dim, cfg.d_model, cfg.n_layers

    def tensor(key):
        return state_dict[key].to(device).float()

    def stack(fmt: str, transform):
        return torch.stack([transform(tensor(fmt.format(i=i)))
                            for i in range(L)])

    def same(w):
        return w

    attn = "model.layers.{i}.self_attn."
    mlp = "model.layers.{i}.mlp."
    params = {
        "embed": tensor("model.embed_tokens.weight").clone(),
        "layers": {
            "attn_norm": stack("model.layers.{i}.input_layernorm.weight",
                               same),
            "wq": stack(attn + "q_proj.weight",
                        lambda w: w.T.reshape(d, cfg.n_heads, hd)),
            "wk": stack(attn + "k_proj.weight",
                        lambda w: w.T.reshape(d, cfg.n_kv_heads, hd)),
            "wv": stack(attn + "v_proj.weight",
                        lambda w: w.T.reshape(d, cfg.n_kv_heads, hd)),
            "wo": stack(attn + "o_proj.weight",
                        lambda w: w.T.reshape(cfg.n_heads, hd, d)),
            "mlp_norm": stack(
                "model.layers.{i}.post_attention_layernorm.weight", same),
            "w_gate": stack(mlp + "gate_proj.weight", lambda w: w.T),
            "w_up": stack(mlp + "up_proj.weight", lambda w: w.T),
            "w_down": stack(mlp + "down_proj.weight", lambda w: w.T),
        },
        "final_norm": tensor("model.norm.weight").clone(),
    }
    if "lm_head.weight" in state_dict:
        params["unembed"] = tensor("lm_head.weight").T.contiguous()
    else:                               # tied embeddings
        params["unembed"] = params["embed"].T.contiguous()
    return params


def read_safetensors(file) -> dict:
    """One .safetensors file -> {name: CPU tensor}. The tensors view a
    private (copy-on-write) map of the file, which lives as long as they
    do; nothing is read until a tensor is used."""
    with open(file, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{file}: tensor {name!r} has dtype "
                             f"{info['dtype']!r}; supported: "
                             f"{sorted(_SAFETENSORS_DTYPES)}")
        begin, end = info["data_offsets"]
        count = math.prod(info["shape"])
        if end - begin != count * dtype.itemsize or base + end > len(mapped):
            raise ValueError(f"{file}: tensor {name!r}'s byte range "
                             f"[{begin}, {end}) does not hold its shape "
                             f"{info['shape']}")
        t = (torch.frombuffer(mapped, dtype=dtype, count=count,
                              offset=base + begin)
             if count else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"])
    return out


def weight_files(path) -> list:
    """The weight files of a checkpoint directory, in the order they are
    read: model.safetensors, the shards of its index, pytorch_model.bin or
    the shards of its index."""
    path = Path(path)
    for name in ("model.safetensors", "pytorch_model.bin"):
        if (path / name).is_file():
            return [path / name]
        index = path / f"{name}.index.json"
        if index.is_file():
            shards = json.loads(index.read_text())["weight_map"].values()
            return [path / s for s in sorted(set(shards))]
    raise FileNotFoundError(
        f"{path}: no model.safetensors, pytorch_model.bin or index of their "
        "shards")


def read_state_dict(path) -> dict:
    """A checkpoint directory's tensors, {name: CPU tensor}."""
    state_dict = {}
    for file in weight_files(path):
        if file.suffix == ".safetensors":
            state_dict.update(read_safetensors(file))
        else:
            state_dict.update(torch.load(file, map_location="cpu",
                                         weights_only=True, mmap=True))
    return state_dict


def load_hf(path, dtype: torch.dtype = torch.bfloat16, device=None):
    """A local HF checkpoint directory -> (params, cfg): float32 masters on
    ``device`` (None: the card), activations in ``dtype``."""
    cfg = config_from_hf(json.loads((Path(path) / "config.json").read_text()),
                         dtype=dtype)
    return params_from_hf(read_state_dict(path), cfg, device), cfg


__all__ = ["config_from_hf", "params_from_hf", "load_hf", "read_safetensors",
           "read_state_dict", "weight_files"]
