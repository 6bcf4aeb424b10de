"""Iterative solvers over the packed formats: CG, BiCGStab, GMRES and
batched CG, with Jacobi and Chebyshev preconditioners.

Counterpart of ``tpusparse/solve.py``, with the same recurrences, stopping
rules and return shapes. The JAX loops are ``lax.while_loop`` /
``fori_loop`` programs; here they are Python loops that test the same
stopping rule before every iteration, so the iteration counts agree. That
test reads one scalar back from the device each iteration (a host sync);
a solve is therefore ``iters`` x (the operator's time + the vector ops +
one sync), and the sync stays until the loop moves onto the device.

Convention (as in the JAX package): the op is ``y = x @ A``, so
``fmt.spmv(v) == Aᵀ v``. For a SYMMETRIC system matrix ``S`` that is
``S v``: ``cg(fmt, b)`` solves ``S z = b`` when ``fmt`` packs ``S``. For a
NONSYMMETRIC ``S``, pack ``S.T`` and use ``bicgstab`` or ``gmres``.

``a`` is a packed format (its ``spmv``, or ``spmm`` for ``cg_multi``) or
any callable ``v -> v @ S``. The solvers run on the device of ``b``;
reductions are fp32 whatever the operand dtype. ``info`` holds ``iters``
(an int) and ``resnorm`` (a tensor on that device).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

Apply = Callable[[torch.Tensor], torch.Tensor]
_TINY = 1e-30


def _as_apply(a: Any) -> Apply:
    if callable(a) and not hasattr(a, "spmv"):
        return a
    return a.spmv


def _rhs(a: Any, b) -> torch.Tensor:
    """``b`` as a tensor: a tensor stays where it is; host data goes to the
    operator's device (a format's), else stays on the host."""
    if isinstance(b, torch.Tensor):
        return b
    return torch.as_tensor(b, device=getattr(a, "device", None))


def _vdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    # accumulate reductions in fp32 regardless of operand dtype
    return torch.sum((u * v).float())


def _identity(v: torch.Tensor) -> torch.Tensor:
    return v


def _limit(b: torch.Tensor, tol: float, atol: float,
           dot=_vdot) -> torch.Tensor:
    """``max(tol * ||b||, atol)``, in fp32 on b's device."""
    return torch.clamp(tol * torch.sqrt(dot(b, b)), min=atol)


def cg(a: Any, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
       maxiter: int | None = None, m_inv: Apply | None = None):
    """Conjugate gradient for ``S z = b``, ``S`` symmetric positive
    definite. ``m_inv``: an optional preconditioner application. Stops when
    ``||r|| <= max(tol * ||b||, atol)`` or after ``maxiter`` iterations
    (default ``len(b)``). Returns ``(z, info)``."""
    apply = _as_apply(a)
    b = _rhs(a, b)
    if b.ndim != 1:
        raise ValueError(f"cg solves one system; b must be 1-D, got "
                         f"shape {tuple(b.shape)}")
    maxiter = b.shape[-1] if maxiter is None else maxiter
    x = torch.zeros_like(b) if x0 is None else _rhs(a, x0)
    prec = _identity if m_inv is None else m_inv

    r = b - apply(x)
    z = prec(r)
    p = z
    rz = _vdot(r, z)
    limit2 = _limit(b, tol, atol) ** 2
    k = 0
    while k < maxiter and bool(_vdot(r, r) > limit2):
        ap = apply(p)
        alpha = rz / _vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = _vdot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, {"iters": k, "resnorm": torch.sqrt(_vdot(r, r))}


def jacobi_preconditioner(diag, eps: float = 1e-12) -> Apply:
    """Inverse-diagonal preconditioner ``v -> v / diag`` for ``cg``;
    ``diag`` (numpy or tensor) is the system matrix's diagonal, moved to
    the vector's device at the first application."""
    d = diag.float() if isinstance(diag, torch.Tensor) else \
        torch.from_numpy(np.array(diag, dtype=np.float32))
    inv = {d.device: 1.0 / (d + eps)}

    def apply(v: torch.Tensor) -> torch.Tensor:
        if v.device not in inv:
            inv[v.device] = next(iter(inv.values())).to(v.device)
        return v * inv[v.device]

    return apply


def bicgstab(a: Any, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
             maxiter: int | None = None, m_inv: Apply | None = None):
    """BiCGStab for ``S z = b`` with nonsymmetric ``S`` (van der Vorst
    '92): two operator applications an iteration. ``a`` applies
    ``v -> S v`` (a format packing ``S.T``, or a callable). The same
    stopping rule and return shape as ``cg``. When the shadow residual
    drifts orthogonal to ``r`` (the rho inner product's cosine falls under
    1e-8) the Krylov pair restarts from ``r``; a zero denominator freezes
    the state instead of producing NaN, as in the JAX package."""
    apply = _as_apply(a)
    b = _rhs(a, b)
    if b.ndim != 1:
        raise ValueError(f"bicgstab solves one system; b must be 1-D, got "
                         f"shape {tuple(b.shape)}")
    maxiter = b.shape[-1] if maxiter is None else maxiter
    x = torch.zeros_like(b) if x0 is None else _rhs(a, x0)
    prec = _identity if m_inv is None else m_inv
    one = torch.ones((), dtype=torch.float32, device=b.device)
    zero = torch.zeros_like(one)

    r = b - apply(x)
    rhat = r                                   # shadow residual (restartable)
    rho = alpha = omega = one
    v = p = torch.zeros_like(b)
    limit2 = _limit(b, tol, atol) ** 2
    k = 0
    while k < maxiter and bool(_vdot(r, r) > limit2):
        rho_new = _vdot(rhat, r)
        rr = _vdot(r, r)
        restart = torch.abs(rho_new) <= 1e-8 * torch.sqrt(
            _vdot(rhat, rhat) * rr) + _TINY
        rhat = torch.where(restart, r, rhat)
        rho_new = torch.where(restart, rr, rho_new)
        beta = (rho_new / torch.where(restart, one, rho)) \
            * (alpha / torch.where(restart, one, omega))
        p = torch.where(restart, r, r + beta * (p - omega * v))
        ph = prec(p)
        v = apply(ph)
        denom = _vdot(rhat, v)
        ok = torch.abs(denom) > _TINY
        alpha = torch.where(ok, rho_new / torch.where(ok, denom, one), alpha)
        s = r - alpha * v
        sh = prec(s)
        t = apply(sh)
        tt = _vdot(t, t)
        omega_new = torch.where(tt > _TINY,
                                _vdot(t, s) / torch.clamp(tt, min=_TINY),
                                zero)
        x = torch.where(ok, x + alpha * ph + omega_new * sh, x)
        r = torch.where(ok, s - omega_new * t, r)
        omega = torch.where(ok & (torch.abs(omega_new) > _TINY), omega_new,
                            omega)
        rho = torch.where(ok, rho_new, rho)
        k += 1
    return x, {"iters": k, "resnorm": torch.sqrt(_vdot(r, r))}


def _start_vector(a: Any, n: int, seed: int, device=None) -> torch.Tensor:
    """A standard normal (n,) fp32 vector from a CPU ``torch.Generator``
    seeded with ``seed`` (the same draw on every device), on ``device``
    (None: the operator's device, if it has one)."""
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(n, generator=gen, dtype=torch.float32)
    return v.to(device if device is not None
                else getattr(a, "device", None))


def estimate_lmax(a: Any, n: int | None = None, *, iters: int = 20,
                  seed: int = 0, safety: float = 1.1,
                  device=None) -> torch.Tensor:
    """Largest-eigenvalue estimate by ``iters`` steps of power iteration,
    times ``safety`` (Chebyshev bounds must contain the spectrum). ``n``
    defaults to the format's output width. The start vector is drawn from
    a CPU ``torch.Generator`` seeded with ``seed`` (so it is the same on
    every device; it is not the JAX package's ``PRNGKey`` draw) and moved
    to ``device`` (default: the format's; a callable needs it)."""
    apply = _as_apply(a)
    if n is None:
        n = a.shape[1]
    v = _start_vector(a, n, seed, device)
    v = v / torch.sqrt(torch.sum(v * v))
    for _ in range(iters):
        w = apply(v)
        v = w / torch.clamp(torch.sqrt(torch.sum(w * w)), min=_TINY)
    return safety * torch.sqrt(torch.sum(apply(v) ** 2))


def chebyshev_preconditioner(a: Any, lmax, lmin=None,
                             degree: int = 8) -> Apply:
    """Degree-``degree`` Chebyshev approximation of the operator's inverse
    over ``[lmin, lmax]`` (Saad §12.3) as an ``m_inv``: each application
    is ``degree`` operator applications and no triangular solve. ``lmin``
    defaults to ``lmax / 30``; ``eig.spectrum_bounds`` gives both ends.
    The coefficients are fp32, as in the JAX package."""
    apply = _as_apply(a)
    lmax = torch.as_tensor(lmax, dtype=torch.float32)
    lmin = lmax / 30.0 if lmin is None else \
        torch.as_tensor(lmin, dtype=torch.float32)
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma = theta / delta

    def m_inv(v: torch.Tensor) -> torch.Tensor:
        rho = 1.0 / sigma
        d = v / theta
        z = d
        r = v - apply(z)
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
            z = z + d
            r = r - apply(d)
            rho = rho_new
        return z

    return m_inv


def gmres(a: Any, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
          restart: int = 30, maxiter: int | None = None,
          m_inv: Apply | None = None):
    """Restarted GMRES(``restart``) for nonsymmetric ``S`` (pack ``S.T``,
    as for ``bicgstab``). ``m_inv`` is applied on the right, so the
    residual test sees the true residual. Arnoldi orthogonalises by CGS2
    (two classical Gram-Schmidt passes, each two products over the whole
    basis); the small least-squares problem is solved through the SVD
    (``_lstsq``), which a breakdown mid-cycle (a zero basis tail) does not
    upset. ``maxiter`` counts inner steps; cycles are whole, and
    ``info["iters"]`` is cycles x ``restart``."""
    apply = _as_apply(a)
    b = _rhs(a, b)
    if b.ndim != 1:
        raise ValueError(f"gmres solves one system; b must be 1-D, got "
                         f"shape {tuple(b.shape)}")
    n = b.shape[-1]
    maxiter = n if maxiter is None else maxiter
    max_outer = -(-maxiter // restart)
    x = torch.zeros_like(b) if x0 is None else _rhs(a, x0)
    prec = _identity if m_inv is None else m_inv
    dev = b.device
    limit = _limit(b, tol, atol)
    e1 = torch.zeros(restart + 1, dtype=torch.float32, device=dev)
    e1[0] = 1.0

    def cycle(x: torch.Tensor) -> torch.Tensor:
        r = b - apply(x)
        beta = torch.sqrt(_vdot(r, r))
        v_basis = torch.zeros((restart + 1, n), dtype=torch.float32,
                              device=dev)
        v_basis[0] = r / torch.clamp(beta, min=_TINY)
        h = torch.zeros((restart + 1, restart), dtype=torch.float32,
                        device=dev)
        for j in range(restart):
            w = apply(prec(v_basis[j]))
            # CGS2: rows past j are zero, so the projections self-mask
            c1 = v_basis @ w
            w = w - c1 @ v_basis
            c2 = v_basis @ w
            w = w - c2 @ v_basis
            hj = torch.sqrt(_vdot(w, w))
            v_basis[j + 1] = torch.where(
                hj > _TINY, w / torch.clamp(hj, min=_TINY),
                torch.zeros_like(w))
            h[:, j] = c1 + c2
            h[j + 1, j] = hj
        y = _lstsq(h, beta * e1)
        return x + prec(y @ v_basis[:restart])

    r0 = b - apply(x)
    res = torch.sqrt(_vdot(r0, r0))
    k = 0
    while k < max_outer and bool(res > limit):
        x = cycle(x)
        r = b - apply(x)
        res = torch.sqrt(_vdot(r, r))
        k += 1
    return x, {"iters": k * restart, "resnorm": res}


def _lstsq(h: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares through the SVD, singular values under
    ``eps * max(h.shape)`` of the largest dropped (``jnp.linalg.lstsq``'s
    rule): a rank-deficient ``h`` is harmless."""
    u, s, vh = torch.linalg.svd(h, full_matrices=False)
    mask = s >= torch.finfo(h.dtype).eps * max(h.shape) * s[0]
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vh.T @ (s_inv * (u.T @ rhs))


def _rowdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(nrhs, 1) fp32 reductions."""
    return torch.sum((u * v).float(), dim=1, keepdim=True)


def cg_multi(a: Any, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
             maxiter: int | None = None, m_inv: Apply | None = None):
    """Batched CG: ``S Z[i] = B[i]`` for ``nrhs`` right-hand sides, ``b``
    of shape ``(nrhs, n)``; one ``spmm`` an iteration instead of ``nrhs``
    SpMVs. Each row has its own alpha, beta and limit
    (``max(tol * ||b_i||, atol)``); converged rows freeze (alpha 0) while
    the rest iterate, and the loop ends when all are converged or at
    ``maxiter``. ``info["resnorm"]`` is ``(nrhs,)``, ``iters`` shared.
    ``m_inv`` maps ``(nrhs, n) -> (nrhs, n)``."""
    apply = a if callable(a) and not hasattr(a, "spmm") else a.spmm
    b = _rhs(a, b)
    if b.ndim != 2:
        raise ValueError(f"cg_multi wants b of shape (nrhs, n); got "
                         f"{tuple(b.shape)} (for one system use cg)")
    maxiter = b.shape[-1] if maxiter is None else maxiter
    x = torch.zeros_like(b) if x0 is None else _rhs(a, x0)
    prec = _identity if m_inv is None else m_inv
    zero = torch.zeros((), dtype=torch.float32, device=b.device)
    one = torch.ones_like(zero)

    r = b - apply(x)
    z = prec(r)
    p = z
    rz = _rowdot(r, z)
    limit2 = _limit(b, tol, atol, _rowdot) ** 2
    k = 0
    while k < maxiter and bool(torch.any(_rowdot(r, r) > limit2)):
        active = _rowdot(r, r) > limit2
        ap = apply(p)
        pap = _rowdot(p, ap)
        big = torch.abs(pap) > _TINY
        alpha = torch.where(active & big,
                            rz / torch.where(big, pap, one), zero)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = _rowdot(r, z)
        big = torch.abs(rz) > _TINY
        beta = torch.where(active & big,
                           rz_new / torch.where(big, rz, one), zero)
        p = torch.where(active, z + beta * p, p)
        rz = torch.where(active, rz_new, rz)
        k += 1
    return x, {"iters": k, "resnorm": torch.sqrt(_rowdot(r, r))[:, 0]}
