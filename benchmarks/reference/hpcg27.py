"""Plain reference of the hpcg27 configuration: HPCG's 27-point operator
on a 3-D grid (26 on the diagonal, -1 for every neighbour inside the
grid), its right-hand sides, the true residual of a solution in float64,
and the TF32 control.

Plain torch; it imports nothing of the program. Point ``(ix, iy, iz)`` is
unknown ``ix + nx * (iy + ny * iz)``, as in HPCG.
"""

from __future__ import annotations

import math

import torch

from benchmarks.plain import generator, tf32


def size(dims) -> int:
    return math.prod(dims)


def nnz(dims) -> int:
    """Stored entries of the operator: per axis 3 s - 2 pairs within one
    step of each other."""
    return math.prod(3 * s - 2 for s in dims)


def apply(cfg: dict, v: torch.Tensor, dims) -> torch.Tensor:
    """``A v`` in ``v``'s dtype: the 27-point box is separable, so the sum
    over the box is three passes of [1, 1, 1] along the axes."""
    nx, ny, nz = dims
    box = v.reshape(nz, ny, nx)
    for d in range(3):
        s = box.clone()
        s.narrow(d, 1, box.shape[d] - 1).add_(box.narrow(d, 0,
                                                         box.shape[d] - 1))
        s.narrow(d, 0, box.shape[d] - 1).add_(box.narrow(d, 1,
                                                         box.shape[d] - 1))
        box = s
    diag, off = cfg["diagonal"], cfg["off_diagonal"]
    return ((diag - off) * v + off * box.reshape(-1)).reshape(v.shape)


def rhs(seed: int, i: int, n: int, device) -> torch.Tensor:
    """The ``i``-th right-hand side of a run: uniform(-1, 1), fp32. White
    noise holds every mode of the operator, the smoothest too, so each
    solve works through the whole spectrum, as HPCG's does."""
    g = generator(device, seed, 3, i)
    return torch.rand(n, generator=g, device=device).mul_(2).sub_(1)


def residual(cfg: dict, x: torch.Tensor, b: torch.Tensor, dims) -> float:
    """``||b - A x|| / ||b||`` in float64; infinite where x is not finite."""
    x64, b64 = x.double(), b.double()
    if not torch.isfinite(x64).all():
        return math.inf
    return float(torch.linalg.vector_norm(b64 - apply(cfg, x64, dims))
                 / torch.linalg.vector_norm(b64))


class Control:
    """The control: plain CG in float32 in the program's place, each
    operator application taking its vector rounded to TF32 (10 mantissa
    bits; the operator's values are exact there). The configuration states
    float32 with TF32 off, so this is the nearest precision below it."""

    def __init__(self, cfg: dict):
        self.cfg = cfg

    def operator(self, dims, device):
        return tuple(dims)

    def solve(self, dims, b, tol, maxiter, apply_=None):
        a = lambda v: apply(self.cfg, tf32(v), dims)    # noqa: E731
        x = torch.zeros_like(b)
        r = b.clone()
        p = r.clone()
        rr = torch.dot(r, r)
        limit2 = tol * tol * float(torch.dot(b, b))
        k = 0
        while k < maxiter and float(rr) > limit2:
            ap = a(p)
            alpha = rr / torch.dot(p, ap)
            x += alpha * p
            r -= alpha * ap
            rr_new = torch.dot(r, r)
            p = r + (rr_new / rr) * p
            rr = rr_new
            k += 1
        return x, k

    def route(self, op) -> str:
        return "control: plain CG, TF32 operator"
