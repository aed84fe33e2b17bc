"""The port's MNIST model (models/mnist.py) against the JAX package's on
the same parameters and data (converted from JAX), at float32 on the CPU:
forward, loss and accuracy within 2e-5, gradients within 1e-4, and 20 Adam
steps against optax.adam within 1e-4 in the parameters; and the port's
example (examples/mnist.py) writes the JAX example's metrics keys."""

import json

import jax
import numpy as np
import optax
import pytest
import torch

from tony_tpu.models import mnist as jm
from tony_tpu_torch.models import mnist as pm

FWD_ATOL = 2e-5
GRAD_ATOL = 1e-4
PARAM_ATOL = 1e-4


def _to_torch(params):
    return [{k: torch.tensor(np.asarray(v)) for k, v in layer.items()}
            for layer in params]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's parameters and data as numpy, and its outputs."""
    params = jax.tree.map(np.asarray, jm.init_mlp(jax.random.PRNGKey(1)))
    x, y = jm.synthetic_mnist(jax.random.PRNGKey(0), n=256)
    x, y = np.asarray(x), np.asarray(y)
    loss, grads = jax.value_and_grad(jm.loss_fn)(params, x, y)
    # 20 Adam steps over 8 batches of 32, as the example's loop slices them
    opt = optax.adam(1e-3)

    @jax.jit
    def step(p, state, xb, yb):
        upd, state = opt.update(jax.grad(jm.loss_fn)(p, xb, yb), state)
        return optax.apply_updates(p, upd), state

    state = opt.init(params)
    p = params
    batches = [(x[i * 32:(i + 1) * 32], y[i * 32:(i + 1) * 32])
               for i in range(8)]
    for i in range(20):
        p, state = step(p, state, *batches[i % 8])
    return dict(params=params, x=x, y=y, batches=batches,
                logits=np.asarray(jm.mlp_apply(params, x)),
                loss=float(loss), acc=float(jm.accuracy(params, x, y)),
                grads=jax.tree.map(np.asarray, grads),
                trained=jax.tree.map(np.asarray, p))


def test_forward_loss_and_accuracy_match_jax(ref):
    params = _to_torch(ref["params"])
    x, y = torch.tensor(ref["x"]), torch.tensor(ref["y"])
    np.testing.assert_allclose(pm.mlp_apply(params, x).numpy(),
                               ref["logits"], atol=FWD_ATOL, rtol=0)
    assert abs(float(pm.loss_fn(params, x, y)) - ref["loss"]) < FWD_ATOL
    assert abs(float(pm.accuracy(params, x, y)) - ref["acc"]) < FWD_ATOL


def test_gradients_match_jax(ref):
    params = _to_torch(ref["params"])
    leaves = [t.requires_grad_(True) for layer in params
              for t in (layer["w"], layer["b"])]
    loss = pm.loss_fn(params, torch.tensor(ref["x"]), torch.tensor(ref["y"]))
    grads = torch.autograd.grad(loss, leaves)
    want = [g for layer in ref["grads"] for g in (layer["w"], layer["b"])]
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0)


def test_twenty_adam_steps_match_optax(ref):
    params = _to_torch(ref["params"])
    leaves = [t.requires_grad_(True) for layer in params
              for t in (layer["w"], layer["b"])]
    opt = torch.optim.Adam(leaves, lr=1e-3)
    for step in range(20):
        xb, yb = ref["batches"][step % 8]
        loss = pm.loss_fn(params, torch.tensor(xb), torch.tensor(yb))
        grads = torch.autograd.grad(loss, leaves)
        for t, g in zip(leaves, grads):
            t.grad = g
        opt.step()
    want = [v for layer in ref["trained"] for v in (layer["w"], layer["b"])]
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.detach().numpy(), w, atol=PARAM_ATOL,
                                   rtol=0)


def test_init_and_data_follow_the_generator():
    a = pm.init_mlp(torch.Generator().manual_seed(1))
    b = pm.init_mlp(torch.Generator().manual_seed(1))
    assert [tuple(layer["w"].shape) for layer in a] == \
        [(784, 512), (512, 512), (512, 10)]
    for la, lb, fan_in in zip(a, b, (784, 512, 512)):
        assert torch.equal(la["w"], lb["w"]) and not la["b"].any()
        assert abs(float(la["w"].std()) * fan_in ** 0.5 - 1) < 0.05
    x, y = pm.synthetic_mnist(torch.Generator().manual_seed(0), n=512)
    x2, y2 = pm.synthetic_mnist(torch.Generator().manual_seed(0), n=512)
    assert x.shape == (512, 784) and x.dtype == torch.float32
    assert y.dtype == torch.int64 and int(y.min()) >= 0 and int(y.max()) < 10
    assert torch.equal(x, x2) and torch.equal(y, y2)


@pytest.fixture(scope="module")
def jax_example_keys():
    """The keys of the JAX example's --metrics-out: its ``metrics`` dict
    literal, read from the source (running it compiles two scans)."""
    import ast
    import inspect

    from tony_tpu.examples import mnist_jax

    tree = ast.parse(inspect.getsource(mnist_jax.main))
    (literal,) = [n.value for n in ast.walk(tree)
                  if isinstance(n, ast.Assign)
                  and [t.id for t in n.targets
                       if isinstance(t, ast.Name)] == ["metrics"]]
    return {k.value for k in literal.keys}


def test_example_trains_and_writes_the_jax_examples_keys(tmp_path,
                                                         jax_example_keys):
    from tony_tpu_torch.examples import mnist

    out = tmp_path / "m.json"
    assert mnist.main(["--device", "cpu", "--steps", "20",
                       "--steps-per-call", "10", "--batch-size", "64",
                       "--metrics-out", str(out)]) == 0
    m = json.loads(out.read_text())
    assert set(m) == jax_example_keys
    assert m["accuracy"] > 0.9 and m["final_loss"] < 0.1
    assert m["steps_per_call"] == 10 and m["steps_per_call_short"] == 5
    assert len(m["window_call_times_s"]) == 2
    assert m["process"]["backend"] is None and m["num_devices"] == 1
