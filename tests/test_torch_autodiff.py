"""``linear_map`` and ``trainable_linear`` in the port against the JAX
package's.

- The twin pack is the JAX package's bit for bit: the sorted CSR's SELL
  packs in both layouts, ``sell_slot_flat`` of both, the signed planes and
  the masks, and from them ``params``, ``masks`` and ``apply.statics``; an
  unsorted CSR gives the same.
- ``trainable_linear``'s ``dvals`` and ``dvals_t`` stay within 1e-5 of
  ``jax.grad`` (Pallas interpret mode) for spmv and spmm, with ``.grad``
  set on every input asked for and pad slots exactly 0. Its forward and dx
  run K1, which the JAX package computes through split-bf16 products
  (``kernels/precision.py``): those sit up to 2.3e-5 from the float64
  oracle here, the port's within 1e-6. So y and dx are held to 1e-5 of the
  float64 oracle and to 1e-4 of ``jax.grad``. The loss is ``sum(y * t)``
  for a fixed t in [-1, 1], so the cotangents stay near 1 and an absolute
  tolerance means what it says.
- ``linear_map``'s dx over SELL, TCSR, RSELL and DIA is held the same way,
  with the 2 GB guard and the shape check.
- Three SGD steps keep the twins tied to rtol 1e-5; ``resync`` re-ties them
  exactly; weights trained in JAX load into the port's params.

The JAX calls are gathered in module-scoped fixtures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.autodiff import _TwinPack as JTwin
from tpusparse.autodiff import linear_map as jlinear_map
from tpusparse.autodiff import trainable_linear as jtrainable
from tpusparse.formats.csr import CsrMatrix as JCsr
from tpusparse.formats.dia import DiaMatrix as JDia
from tpusparse.formats.rsell import RsellMatrix as JRsell
from tpusparse.formats.sell import SellMatrix as JSell
from tpusparse.formats.tcsr import TcsrMatrix as JTcsr
from tpusparse.testing import generators as jgen
from tpusparse_torch import (DiaMatrix, RsellMatrix, SellMatrix, TcsrMatrix,
                             linear_map, load_trainable_arrays,
                             trainable_linear)
from tpusparse_torch.autodiff import _TwinPack
from tpusparse_torch.formats import CsrMatrix

ATOL = 1e-5        # K10 against jax.grad; y and dx against float64
ATOL_K1 = 1e-4     # y and dx against the JAX package's split-bf16 K1
M, N = 384, 256
CPU = "cpu"


def _port(jc):
    return CsrMatrix(jc.shape, jc.row_ptr, jc.col_idx, jc.values)


def _shuffled(c, seed):
    """The same matrix with each CSR row's entries in a random order."""
    rng = np.random.default_rng(seed)
    ci, vals = np.array(c.col_idx), np.array(c.values)
    for r in range(len(c.row_ptr) - 1):
        lo, hi = int(c.row_ptr[r]), int(c.row_ptr[r + 1])
        perm = rng.permutation(hi - lo)
        ci[lo:hi], vals[lo:hi] = ci[lo:hi][perm], vals[lo:hi][perm]
    assert not np.array_equal(ci, c.col_idx)
    return CsrMatrix(c.shape, c.row_ptr, ci, vals)


def _target(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_train():
    """JAX's trainable_linear on test_autodiff.py's matrix, and jax.grad of
    sum(apply(p, x) * t) for a vector and a batch of 3."""
    a = jgen.random_sparse_matrix(M, N, density=0.25, seed=21)
    jc = JCsr.from_dense(a, use_native=False)
    apply, params, masks, _ = jtrainable(jc)
    runs = {}
    for kind, x in (("spmv", jgen.random_sparse_vector(M, 0.5, seed=22)),
                    ("spmm", jgen.random_sparse_batch(3, M, 0.5, seed=25))):
        t = _target(x.shape[:-1] + (N,), seed=x.ndim)
        y, vjp = jax.vjp(apply, params, jnp.asarray(x))
        dp, dx = vjp(jnp.asarray(t))
        runs[kind] = (x, t, np.asarray(y), {k: np.asarray(v) for k, v in
                                            dp.items()}, np.asarray(dx))
    return a, jc, apply, params, masks, runs


def test_twin_pack_matches_jax(jax_train):
    a, jc, japply, jparams, jmasks, _ = jax_train
    jp = JTwin(jc)
    for c in (_port(jc), _shuffled(_port(jc), 3)):
        tp = _TwinPack(c)
        for k in ("idx", "vals"):
            assert np.array_equal(tp.fmt[k].numpy(), np.asarray(getattr(
                jp.fmt, k))) and np.array_equal(tp.fmt_t[k].numpy(),
                                                np.asarray(getattr(jp.fmt_t,
                                                                   k)))
        for k in ("flat_f", "flat_t", "s_f", "s_t", "mask_f", "mask_t"):
            u, v = getattr(tp, k), getattr(jp, k)
            assert u.dtype == v.dtype and np.array_equal(u, v), k
        assert (tp.fmt["w"], tp.fmt_t["w"]) == (jp.fmt.w, jp.fmt_t.w)
        apply, params, masks, _ = trainable_linear(c, device=CPU)
        for k in ("vals", "vals_t"):
            assert params[k].requires_grad and params[k].is_leaf
            assert np.array_equal(params[k].detach().numpy(), jparams[k])
            assert np.array_equal(masks[k].numpy(), jmasks[k])
        assert set(apply.statics) == set(japply.statics)
        for k, v in apply.statics.items():
            assert v.dtype == torch.int8
            assert np.array_equal(v.numpy(), japply.statics[k]), k


@pytest.mark.parametrize("sort", ["sorted", "unsorted"])
@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_trainable_grads_match_jax(jax_train, kind, sort):
    a, jc, _, _, _, runs = jax_train
    x, t, jy, jdp, jdx = runs[kind]
    c = _port(jc) if sort == "sorted" else _shuffled(_port(jc), 4)
    apply, params, masks, _ = trainable_linear(c, device=CPU)
    xt = torch.from_numpy(x).requires_grad_()
    y = apply(params, xt)
    assert y.shape == jy.shape and y.grad_fn is not None
    a64 = a.astype(np.float64)
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=0, atol=ATOL_K1)
    np.testing.assert_allclose(y.detach().numpy(), x @ a64, rtol=0,
                               atol=ATOL)
    (y * torch.from_numpy(t)).sum().backward()
    assert xt.grad is not None and xt.grad.shape == xt.shape
    np.testing.assert_allclose(xt.grad.numpy(), jdx, rtol=0, atol=ATOL_K1)
    np.testing.assert_allclose(xt.grad.numpy(), t @ a64.T, rtol=0, atol=ATOL)
    for k in ("vals", "vals_t"):
        grad = params[k].grad
        assert grad is not None and grad.shape == params[k].shape
        np.testing.assert_allclose(grad.numpy(), jdp[k], rtol=0, atol=ATOL)
        assert not grad[~masks[k]].any()            # pads exactly 0


def test_trainable_honours_needs_input_grad(jax_train):
    a, jc, _, _, _, runs = jax_train
    x, t, _, jdp, jdx = runs["spmm"]
    apply, params, _, _ = trainable_linear(_port(jc), device=CPU)
    tt = torch.from_numpy(t)
    y = apply(params, x)                         # x is data: no dx
    dv, dvt = torch.autograd.grad((y * tt).sum(), [params["vals"],
                                                   params["vals_t"]])
    np.testing.assert_allclose(dvt.numpy(), jdp["vals_t"], rtol=0, atol=ATOL)
    params["vals"].requires_grad_(False)
    xt = torch.from_numpy(x).requires_grad_()
    (dx,) = torch.autograd.grad((apply(params, xt) * tt).sum(), [xt])
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=0, atol=ATOL_K1)
    assert params["vals"].grad is None and params["vals_t"].grad is None


def _unpack_dense(pack, v, transpose=False):
    """Dense A (or A.T) from values ``v`` in one of the pack's layouts."""
    s = pack.s_t if transpose else pack.s_f
    m, n = pack.fmt_t["shape"] if transpose else pack.fmt["shape"]
    j, t, w, r = np.nonzero(s >= 0)
    d = np.zeros((s.shape[1] * 128, s.shape[0] * 128), np.float32)
    d[t * 128 + s[j, t, w, r], j * 128 + r] = np.asarray(v)[j, t, w, r]
    return d[:m, :n]


def test_sgd_keeps_twins_tied_and_resync_reties(jax_train):
    a, jc, _, _, _, _ = jax_train
    c = _port(jc)
    pack = _TwinPack(c)
    apply, params, masks, resync = trainable_linear(c, device=CPU)
    x = torch.from_numpy(jgen.random_sparse_vector(M, 0.5, seed=24))
    opt = torch.optim.SGD(params.values(), lr=1e-2)
    start = {k: v.detach().clone() for k, v in params.items()}
    for _ in range(3):
        opt.zero_grad()
        (apply(params, x) ** 2).sum().backward()
        opt.step()
    for k in ("vals", "vals_t"):                 # both copies moved, pads not
        assert not torch.equal(params[k], start[k])
        assert not params[k].detach()[~masks[k]].any()
    d1 = _unpack_dense(pack, params["vals"].detach())
    d2 = _unpack_dense(pack, params["vals_t"].detach(), transpose=True).T
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-7)
    with torch.no_grad():
        params["vals_t"].add_(torch.where(masks["vals_t"], 1e-3, 0.0))
    assert resync(params) is params and params["vals_t"].requires_grad
    d2 = _unpack_dense(pack, params["vals_t"].detach(), transpose=True).T
    assert np.array_equal(d1, d2)
    (dx,) = torch.autograd.grad(apply(params, x.requires_grad_()).sum(), [x])
    np.testing.assert_allclose(dx.numpy(), d1.astype(np.float64).sum(axis=1),
                               rtol=0, atol=1e-4)   # the live transpose


def test_resync_int64_gather_is_the_int32_bits(jax_train, monkeypatch):
    """Past ``INT32_SLOTS`` slots the re-tie map keeps int64 indices;
    lowered to 1, this small pack takes that branch, and ``resync`` must
    give the int32 map's bits."""
    from tpusparse_torch import autodiff

    c = _port(jax_train[1])
    nudge = torch.from_numpy(_target(_TwinPack(c).fmt["vals"].shape, 31))
    out = {}
    for limit in (autodiff.INT32_SLOTS, 1):
        monkeypatch.setattr(autodiff, "INT32_SLOTS", limit)
        gather, _ = _TwinPack(c).retie_map()
        _, params, masks, resync = trainable_linear(c, device=CPU)
        with torch.no_grad():
            params["vals"].add_(torch.where(masks["vals"], nudge, 0.0))
        out[gather.dtype] = resync(params)["vals_t"].detach().clone()
    assert set(out) == {np.dtype(np.int32), np.dtype(np.int64)}
    a, b = out.values()
    assert torch.equal(a, b) and a.any()


def test_jax_trained_params_load_into_the_port(jax_train):
    a, jc, _, jparams, _, runs = jax_train
    x, t, _, jdp, _ = runs["spmv"]
    trained = {k: (jparams[k] - 0.5 * jdp[k]).astype(np.float32)
               for k in jparams}                 # one SGD step taken in JAX
    apply, params, _, _ = trainable_linear(_port(jc), device=CPU)
    assert load_trainable_arrays(params, trained) is params
    for k in trained:
        assert np.array_equal(params[k].detach().numpy(), trained[k])
        assert params[k].requires_grad and params[k].is_leaf
    dense = _unpack_dense(_TwinPack(_port(jc)), trained["vals"])
    y = apply(params, x)
    np.testing.assert_allclose(y.detach().numpy(), x.astype(np.float64)
                               @ dense, rtol=0, atol=1e-4)
    (y * torch.from_numpy(t)).sum().backward()  # and trains on from there
    np.testing.assert_allclose(params["vals"].grad.numpy(), jdp["vals"],
                               rtol=0, atol=ATOL)
    bad = [{"vals": trained["vals"]},
           {**trained, "bias": np.zeros(N, np.float32)},
           {**trained, "vals": trained["vals"].astype(np.float64)},
           {**trained, "vals_t": trained["vals_t"][:1]}]
    for leaves in bad:
        with pytest.raises(ValueError):
            load_trainable_arrays(params, leaves)


def _jax_fmt(kind, jc):
    return {"sell": JSell, "tcsr": JTcsr, "rsell": JRsell,
            "dia": JDia}[kind].from_csr(jc)


def _port_fmt(kind, c):
    return {"sell": SellMatrix, "tcsr": TcsrMatrix, "rsell": RsellMatrix,
            "dia": DiaMatrix}[kind].from_csr(c, device=CPU)


def _linear_case(kind):
    if kind == "dia":
        return jgen.stencil_csr((32, 32))
    a = jgen.random_sparse_matrix(M, N, density=0.25, seed=11)
    return JCsr.from_dense(a, use_native=False)


@pytest.fixture(scope="module")
def jax_linear():
    """jax.grad of sum(linear_map(fmt)(x) * t) for each format."""
    out = {}
    for kind in ("sell", "tcsr", "rsell", "dia"):
        jc = _linear_case(kind)
        m, n = jc.shape
        x = jgen.random_sparse_vector(m, 0.5, seed=12)
        t = _target((n,), seed=13)
        f = jlinear_map(_jax_fmt(kind, jc), csr=jc)
        g = jax.grad(lambda xx: jnp.sum(f(xx) * t))(jnp.asarray(x))
        out[kind] = (jc, x, t, np.asarray(g))
    return out


@pytest.mark.parametrize("kind", ["sell", "tcsr", "rsell", "dia"])
def test_linear_map_grads_match_jax(jax_linear, kind):
    jc, x, t, jg = jax_linear[kind]
    c = _port(jc)
    fmt = _port_fmt(kind, c)
    a = c.to_dense().astype(np.float64)
    tt = torch.from_numpy(t)
    for f in (linear_map(fmt, csr=c), linear_map(fmt),
              linear_map(fmt, _port_fmt(kind, c.transpose()))):
        xt = torch.from_numpy(x).requires_grad_()
        y = f(xt)
        np.testing.assert_allclose(y.detach().numpy(), x @ a, rtol=0,
                                   atol=ATOL)
        (y * tt).sum().backward()
        assert xt.grad.shape == xt.shape
        np.testing.assert_allclose(xt.grad.numpy(), jg, rtol=0, atol=ATOL_K1)
        np.testing.assert_allclose(xt.grad.numpy(), t @ a.T, rtol=0,
                                   atol=ATOL)
    xb = torch.from_numpy(jgen.random_sparse_batch(2, c.shape[0], 0.5,
                                                   seed=14)).requires_grad_()
    tb = torch.from_numpy(_target((2, c.shape[1]), seed=15))
    (linear_map(fmt, csr=c)(xb) * tb).sum().backward()   # spmm: dx = g @ A.T
    assert xb.grad.shape == xb.shape
    np.testing.assert_allclose(xb.grad.numpy(), tb.double().numpy() @ a.T,
                               rtol=0, atol=ATOL)


def test_linear_map_guard_and_shape_check():
    a = jgen.random_sparse_matrix(256, 128, density=0.3, seed=35)
    s = SellMatrix.from_dense(a, device=CPU)
    with pytest.raises(ValueError, match="transpose"):
        linear_map(s, fmt_t=s)
    s.shape = (40000, 40000)                     # a huge logical shape
    with pytest.raises(ValueError, match="GB"):
        linear_map(s)
    x = np.zeros(256, np.float32)                # data needs no grad
    y = linear_map(SellMatrix.from_dense(a, device=CPU))(x)
    assert y.shape == (128,) and not y.requires_grad
