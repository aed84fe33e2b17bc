"""MNIST MLP and synthetic data (port of the JAX package's models/mnist.py).

The same 784-512-512-10 MLP, as a list of ``{"w": [fan_in, fan_out],
"b": [fan_out]}`` dicts in the JAX package's layout, so parameters convert
between the packages by a dtype and device move. Randomness comes from an
explicit ``torch.Generator`` (``jax.random`` streams cannot be reproduced in
torch; parity tests convert the JAX package's parameters and data).
"""

from __future__ import annotations

import torch


def init_mlp(generator: torch.Generator, sizes=(784, 512, 512, 10),
             dtype=torch.float32, device=None) -> list[dict]:
    """Normal(0, 1/fan_in) weights, zero biases, drawn on the generator's
    device and moved to ``device``."""
    params = []
    gen_device = generator.device
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=gen_device) * fan_in ** -0.5
        params.append({"w": w.to(device=device, dtype=dtype),
                       "b": torch.zeros(fan_out, dtype=dtype,
                                        device=device)})
    return params


def mlp_apply(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def loss_fn(params: list[dict], x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the labels."""
    logp = torch.log_softmax(mlp_apply(params, x), dim=-1)
    return -torch.take_along_dim(logp, y[:, None].long(), dim=-1).mean()


def accuracy(params: list[dict], x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    return (mlp_apply(params, x).argmax(dim=-1) == y).float().mean()


def synthetic_mnist(generator: torch.Generator, n: int = 60000):
    """Class-conditional Gaussian blobs in 784-d: learnable, hermetic.
    -> (x float32 [n, 784], y int64 [n]) on the generator's device."""
    dev = generator.device
    y = torch.randint(0, 10, (n,), generator=generator, device=dev)
    centers = torch.randn((10, 784), generator=generator, device=dev) * 2.0
    x = centers[y] + torch.randn((n, 784), generator=generator, device=dev)
    return x.float(), y
