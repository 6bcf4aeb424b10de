"""``SparseLinear`` in the port against the JAX package's flax layer.

The same layer (test_nn.py's matrix, with a bias) trains for 8 steps,
``optax.sgd(0.5)`` in JAX and ``torch.optim.SGD(lr=0.5)`` here, toward
the same target from the same inputs: the loss agrees at every step within
a relative 1e-5 (the two sum the forward's products in different orders,
and JAX's K1 rounds through split-bf16 products). A port layer loaded with
the flax params after step 4 continues to the same losses at steps 5-8.
Parameter names, the ``state_dict`` and the masks line up with flax's;
``resync`` leaves the bias alone. The JAX run is a module-scoped fixture.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
optax = pytest.importorskip("optax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpusparse.nn import SparseLinear as JSparseLinear  # noqa: E402
from tpusparse.testing import generators as jgen  # noqa: E402
from tpusparse_torch import load_trainable_arrays  # noqa: E402
from tpusparse_torch.formats import CsrMatrix  # noqa: E402
from tpusparse_torch.nn import SparseLinear  # noqa: E402

STEPS, LR, RTOL = 8, 0.5, 1e-5
CPU = "cpu"


@pytest.fixture(scope="module")
def flax_run():
    a = jgen.random_sparse_matrix(384, 256, density=0.25, seed=51)
    cls = JSparseLinear.from_dense(a, use_bias=True)
    layer = cls()
    xs = jgen.random_sparse_batch(8, 384, density=0.5, seed=53)
    target = np.tanh(xs @ a * 0.5).astype(np.float32)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(xs))["params"]
    tx = optax.sgd(LR)
    state = tx.init(params)

    @jax.jit
    def step(p, s):
        def loss_fn(pp):
            return jnp.mean((layer.apply({"params": pp}, xs) - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(grads, s, p)
        return loss, optax.apply_updates(p, updates), s

    losses, snaps = [], []
    for _ in range(STEPS):
        snaps.append({k: np.array(v) for k, v in params.items()})
        loss, params, state = step(params, state)
        losses.append(float(loss))
    masks = {k: np.asarray(v) for k, v in cls.masks.items()}
    return a, xs, target, losses, snaps, masks


def _train(layer, xs, target, steps):
    opt = torch.optim.SGD(layer.parameters(), lr=LR)
    xt, tt = torch.from_numpy(xs), torch.from_numpy(target)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = ((layer(xt) - tt) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def test_losses_match_flax_every_step(flax_run):
    a, xs, target, losses, snaps, masks = flax_run
    layer = SparseLinear.from_dense(a, use_bias=True, device=CPU)
    start = {k: v.detach().clone() for k, v in layer.named_parameters()}
    got = _train(layer, xs, target, STEPS)
    np.testing.assert_allclose(got, losses, rtol=RTOL, atol=0)
    assert got[-1] < got[0]
    for k, v in layer.named_parameters():          # every parameter moved
        assert v.grad is not None and not torch.equal(v.detach(), start[k])
    for k in ("vals", "vals_t"):                   # pads never did
        assert not getattr(layer, k).detach()[~layer.masks[k]].any()
        assert np.array_equal(layer.masks[k].numpy(), masks[k])


def test_jax_trained_layer_continues_in_the_port(flax_run):
    a, xs, target, losses, snaps, _ = flax_run
    layer = SparseLinear.from_csr(CsrMatrix.from_dense(a), use_bias=True,
                                  device=CPU)
    assert load_trainable_arrays(layer, snaps[4]) is layer
    got = _train(layer, xs, target, STEPS - 4)
    np.testing.assert_allclose(got, losses[4:], rtol=RTOL, atol=0)
    for bad in ({k: v for k, v in snaps[4].items() if k != "bias"},
                {**snaps[4], "bias": snaps[4]["bias"][:-1]}):
        with pytest.raises(ValueError):
            load_trainable_arrays(layer, bad)


def test_names_state_dict_and_masks_line_up_with_flax(flax_run):
    a, xs, _, _, snaps, masks = flax_run
    layer = SparseLinear.from_dense(a, use_bias=True, device=CPU)
    shapes = {k: tuple(v.shape) for k, v in layer.named_parameters()}
    assert shapes == {k: v.shape for k, v in snaps[0].items()}
    assert set(layer.state_dict()) == {"vals", "vals_t", "bias"}
    for k, v in snaps[0].items():                  # the flax init, exactly
        assert np.array_equal(getattr(layer, k).detach().numpy(), v)
    assert {k: m.shape for k, m in layer.masks.items()} == \
        {k: m.shape for k, m in masks.items()}
    y = layer(xs)
    assert y.shape == (8, 256) and y.grad_fn is not None
    np.testing.assert_allclose(y.detach().numpy(),
                               xs.astype(np.float64) @ a, rtol=0, atol=1e-5)
    assert "nnz=" in repr(layer)


def test_resync_preserves_bias():
    a = jgen.random_sparse_matrix(384, 256, density=0.25, seed=51)
    layer = SparseLinear.from_dense(a, use_bias=True, device=CPU)
    tied = layer.vals_t.detach().clone()
    with torch.no_grad():
        layer.bias.add_(1.25)
        layer.vals_t.add_(torch.where(layer.masks["vals_t"], 1e-3, 0.0))
    bias = layer.bias.detach().clone()
    layer.resync()
    assert torch.equal(layer.bias.detach(), bias)
    assert torch.equal(layer.vals_t.detach(), tied)
    assert layer.vals_t.requires_grad and isinstance(layer.vals_t,
                                                     torch.nn.Parameter)


def test_activation_no_bias_and_input_grad():
    a = jgen.random_sparse_matrix(256, 256, density=0.3, seed=54)
    layer = SparseLinear.from_dense(a, activation=torch.relu, device=CPU)
    assert layer.bias is None and set(layer.state_dict()) == {"vals",
                                                              "vals_t"}
    x = torch.from_numpy(jgen.random_sparse_vector(256, 0.5,
                                                   seed=55)).requires_grad_()
    y = layer(x)
    assert y.shape == (256,) and bool((y >= 0).all())
    y.sum().backward()
    live = (x.detach().numpy() @ a.astype(np.float64)) > 0
    np.testing.assert_allclose(x.grad.numpy(), a.astype(np.float64) @ live,
                               rtol=0, atol=1e-5)
    xs = torch.from_numpy(jgen.random_sparse_batch(6, 256, 0.5, seed=56)
                          ).reshape(2, 3, 256).requires_grad_()
    ys = layer(xs)                                 # leading dims kept
    assert ys.shape == (2, 3, 256)
    np.testing.assert_allclose(
        ys.detach().numpy(), np.maximum(xs.detach().double().numpy() @ a,
                                        0), rtol=0, atol=1e-5)
    ys.sum().backward()
    assert xs.grad.shape == xs.shape
