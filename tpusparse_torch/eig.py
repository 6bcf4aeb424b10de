"""Lanczos eigensolver over the packed formats.

Counterpart of ``tpusparse/eig.py``: ``lanczos`` with full
reorthogonalisation (CGS2), ``eigsh`` (``which`` LA/SA/BE, with residuals)
and ``spectrum_bounds`` (the containing interval that
``solve.chebyshev_preconditioner`` takes). The small ``(ncv, ncv)``
eigenproblem is ``torch.linalg.eigh``, as it is ``jnp.linalg.eigh`` in the
JAX package. The operator convention is ``solve.py``'s: for the symmetric
matrices Lanczos applies to, ``a.spmv(v)`` is ``A v``.

Without an explicit ``v0`` the start vector is drawn from a CPU
``torch.Generator`` seeded with ``seed`` (the same on every device; not the
JAX package's ``PRNGKey`` draw) and moved to ``device`` (default: the
format's device; a callable operator needs ``v0`` or ``device``).
"""

from __future__ import annotations

from typing import Any

import torch

from tpusparse_torch.solve import _TINY, _as_apply, _start_vector


def lanczos(a: Any, ncv: int, *, v0=None, n: int | None = None,
            seed: int = 0, device=None):
    """``ncv`` Lanczos steps with full reorthogonalisation. Returns
    ``(t, v_basis)``: the symmetrised ``(ncv, ncv)`` projection
    ``V A Vᵀ`` and the ``(ncv, n)`` orthonormal basis; an exact breakdown
    zeroes the rest of the basis."""
    apply = _as_apply(a)
    if n is None:
        n = v0.shape[-1] if v0 is not None else a.shape[1]
    if v0 is None:
        v0 = _start_vector(a, n, seed, device)
    elif not isinstance(v0, torch.Tensor):
        v0 = torch.as_tensor(v0, device=device if device is not None
                             else getattr(a, "device", None))
    v0 = v0.float()
    dev = v0.device

    v_basis = torch.zeros((ncv + 1, n), dtype=torch.float32, device=dev)
    v_basis[0] = v0 / torch.clamp(torch.sqrt(torch.sum(v0 * v0)), min=_TINY)
    h = torch.zeros((ncv + 1, ncv), dtype=torch.float32, device=dev)
    for j in range(ncv):
        w = apply(v_basis[j]).float()
        # CGS2: rows past j are zero, so full-basis projections self-mask
        c1 = v_basis @ w
        w = w - c1 @ v_basis
        c2 = v_basis @ w
        w = w - c2 @ v_basis
        hj = torch.sqrt(torch.sum(w * w))
        v_basis[j + 1] = torch.where(hj > _TINY,
                                     w / torch.clamp(hj, min=_TINY),
                                     torch.zeros_like(w))
        h[:, j] = c1 + c2
        h[j + 1, j] = hj
    t = h[:ncv]
    return 0.5 * (t + t.T), v_basis[:ncv]


def eigsh(a: Any, k: int = 6, *, which: str = "LA", ncv: int | None = None,
          v0=None, n: int | None = None, seed: int = 0,
          return_vectors: bool = True, device=None):
    """Extremal eigenpairs of a symmetric operator by Lanczos. ``which``:
    ``"LA"`` (largest), ``"SA"`` (smallest) or ``"BE"`` (``ceil(k/2)``
    from the top, the rest from the bottom). ``ncv`` defaults to
    ``max(2k + 1, 20)``, capped at ``n``. Returns ``(evals, evecs,
    resid)``: ``evals`` ascending ``(k,)``, ``evecs`` ``(k, n)`` Ritz
    vectors (None unless ``return_vectors``) and the residual norms
    ``||A v - λ v||``, which say which pairs converged."""
    if n is None:
        n = v0.shape[-1] if v0 is not None else a.shape[1]
    if ncv is None:
        ncv = max(2 * k + 1, 20)
    ncv = min(ncv, n)
    if not 1 <= k <= ncv:
        raise ValueError(f"need 1 <= k <= ncv, got k={k} ncv={ncv}")
    if which not in ("LA", "SA", "BE"):
        raise ValueError(f"which must be LA|SA|BE, got {which!r}")

    t, v_basis = lanczos(a, ncv, v0=v0, n=n, seed=seed, device=device)
    w, s = torch.linalg.eigh(t)                     # ascending
    if which == "LA":
        idx = torch.arange(ncv - k, ncv)
    elif which == "SA":
        idx = torch.arange(k)
    else:                                           # BE
        hi = (k + 1) // 2
        idx = torch.cat([torch.arange(k - hi), torch.arange(ncv - hi, ncv)])
    idx = idx.to(w.device)
    evals = w[idx]
    evecs = s[:, idx].T @ v_basis                   # (k, n) Ritz vectors
    apply = _as_apply(a)
    av = torch.stack([apply(v).float() for v in evecs])
    resid = torch.sqrt(torch.sum((av - evals[:, None] * evecs) ** 2, dim=1))
    return evals, (evecs if return_vectors else None), resid


def spectrum_bounds(a: Any, *, ncv: int = 32, n: int | None = None,
                    seed: int = 0, safety: float = 1.02, device=None):
    """``(lmin, lmax)`` containing the spectrum of a symmetric positive
    definite operator: each end of the Ritz spectrum widened by its
    residual, then by ``safety``. The top end is a true bound; the bottom
    has no finite-step certificate and falls toward the floor
    ``lmax * 1e-8`` when unconverged, which widens the interval instead of
    excluding spectrum."""
    evals, _, resid = eigsh(a, k=2, which="BE", ncv=ncv, n=n, seed=seed,
                            return_vectors=False, device=device)
    lmax = (evals[-1] + resid[-1]) * safety
    lmin = torch.maximum((evals[0] - resid[0]) / safety, lmax * 1e-8)
    return lmin, lmax
