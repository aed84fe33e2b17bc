"""Convert the JAX package's transformer parameters and config to the port's.

The port keeps the JAX layouts (``wq [L, d, h, k]`` and so on), so a
parameter converts with a dtype and device move and no transpose. The input
is the ``transformer.init`` tree as numpy arrays (``jax.device_get`` gives
one); this module itself imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .transformer import TransformerConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a dtype name ("bfloat16", ...) or
    anything numpy reads as a dtype (a numpy or JAX scalar type)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = str(dtype)
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def config_from_fields(fields: dict) -> TransformerConfig:
    """A TransformerConfig from the JAX config's fields
    (``dataclasses.asdict`` of it), with dtypes given by name or as torch
    dtypes."""
    known = {f.name for f in dataclasses.fields(TransformerConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"fields the port's config does not have: "
                         f"{sorted(unknown)}")
    fields = dict(fields)
    for key in ("dtype", "param_dtype"):
        if key in fields:
            fields[key] = torch_dtype(fields[key])
    if fields.get("rope_scaling") is not None:
        fields["rope_scaling"] = tuple(fields["rope_scaling"])
    return TransformerConfig(**fields)


def _expected_shapes(cfg: TransformerConfig) -> dict:
    L, d, h, kv, hd, f, v = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                             cfg.vocab_size)
    layers = {"attn_norm": (L, d), "wq": (L, d, h, hd), "wk": (L, d, kv, hd),
              "wv": (L, d, kv, hd), "wo": (L, h, hd, d), "mlp_norm": (L, d)}
    e = cfg.n_experts
    if e > 0:
        layers.update(router=(L, d, e), w_in=(L, e, d, f), w_out=(L, e, f, d))
    else:
        layers.update(w_gate=(L, d, f), w_up=(L, d, f), w_down=(L, f, d))
    return {"embed": (v, d), "layers": layers, "final_norm": (d,),
            "unembed": (d, v)}


def _to_torch(x, device, dtype) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # numpy holds it, torch cannot take it
        a = a.astype(np.float32)
    # a writable copy: the arrays jax.device_get returns are read-only
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def from_jax_params(tree: dict, cfg: TransformerConfig, device,
                    dtype: torch.dtype | None = None) -> dict:
    """The JAX ``transformer.init`` tree (numpy leaves) -> the port's
    parameter dict on ``device`` in ``dtype`` (default cfg.param_dtype).
    Raises on a missing, extra or misshapen leaf. An MoE config
    (``n_experts > 0``) takes the ``router``/``w_in``/``w_out`` tree in place
    of the dense MLP's."""
    dtype = cfg.param_dtype if dtype is None else dtype

    def convert(node, shapes, path):
        if set(node) != set(shapes):
            raise ValueError(f"parameter keys at {path or 'root'}: got "
                             f"{sorted(node)}, expected {sorted(shapes)}")
        out = {}
        for name, want in shapes.items():
            if isinstance(want, dict):
                out[name] = convert(node[name], want, f"{path}{name}.")
                continue
            t = _to_torch(node[name], device, dtype)
            if tuple(t.shape) != want:
                raise ValueError(f"{path}{name}: shape {tuple(t.shape)}, "
                                 f"expected {want}")
            out[name] = t
        return out

    return convert(tree, _expected_shapes(cfg), "")


def from_jax_opt_state(opt_state_tree, cfg: TransformerConfig, device,
                       dtype: torch.dtype | None = None) -> dict:
    """The JAX package's optimizer state (numpy leaves) -> the port's AdamW
    state ``{"count", "mu", "nu"}``. The JAX state is the optax chain's
    ``(clip_by_global_norm state, adamw state)``: the clip keeps nothing,
    and the adamw chain's first state is ``ScaleByAdamState(count, mu,
    nu)``, whose moments have the parameters' tree. Raises when the tree
    has another shape."""
    try:
        clip, (adam, *_) = opt_state_tree
        count, mu, nu = adam.count, adam.mu, adam.nu
        empty_clip = len(clip) == 0
    except (TypeError, ValueError, AttributeError) as e:
        raise ValueError("expected the optax chain state (clip_by_global_"
                         "norm, adamw) with ScaleByAdamState at the head of "
                         "the adamw chain") from e
    if not empty_clip:
        raise ValueError("the clip_by_global_norm state should be empty")
    return {"count": int(np.asarray(count)),
            "mu": from_jax_params(mu, cfg, device, dtype),
            "nu": from_jax_params(nu, cfg, device, dtype)}


__all__ = ["from_jax_params", "from_jax_opt_state", "config_from_fields",
           "torch_dtype"]
