"""Plain reference of the sgemv4096 configuration: its inputs, ``Y = X A``
in float64, the bytes a product needs, and the TF32 control.

Plain torch; it imports nothing of the program. A run makes its inputs
here from the seed, on the device, and hands the same tensors to the
program; the check makes the weights again from the seed.
"""

from __future__ import annotations

import math

import torch

from benchmarks.plain import generator, tf32


def weight(cfg: dict, seed: int, layer: int, device) -> torch.Tensor:
    """A_l, (m, n) fp32: uniform(-1, 1) values on a Bernoulli(density)
    support, a value drawn as exactly 0 stored as 1e-3."""
    g = generator(device, seed, 1, layer)
    shape = (cfg["m"], cfg["n"])
    vals = torch.rand(shape, generator=g, device=device).mul_(2).sub_(1)
    keep = torch.rand(shape, generator=g, device=device) < cfg["density"]
    vals.masked_fill_(vals == 0, 1e-3)
    return vals.masked_fill_(~keep, 0.0)


def x_pool(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The pool of activations, (pool, batch, m) fp32: uniform(-1, 1) on a
    Bernoulli(x_density) support."""
    g = generator(device, seed, 2)
    shape = (traffic["pool"], traffic["batch"], cfg["m"])
    vals = torch.rand(shape, generator=g, device=device).mul_(2).sub_(1)
    keep = torch.rand(shape, generator=g, device=device) < cfg["x_density"]
    return vals.masked_fill_(~keep, 0.0)


def product_bytes(a: torch.Tensor, pool: torch.Tensor) -> list[int]:
    """The bytes one product of A with each pool entry needs, counted from
    the problem and not from any format: 4 B for each stored value of A in
    a row that some row of X touches, X read once and Y written once."""
    row_nnz = (a != 0).sum(dim=1).double()                    # (m,)
    touched = (pool != 0).any(dim=1).double()                 # (pool, m)
    b, (m, n) = pool.shape[1], a.shape
    need = touched @ row_nnz
    return [int(4 * v + 4 * b * (m + n)) for v in need.tolist()]


def product_error(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> float:
    """The widest gap between ``y`` and ``x A`` in float64, each element's
    gap over the sum of its terms' magnitudes (``|x| |A|``); infinite where
    ``y`` has the wrong size, is not finite or is nonzero where every term
    is zero."""
    x64, a64 = x.double().reshape(-1, a.shape[0]), a.double()
    if y.numel() != x64.shape[0] * a.shape[1]:
        return math.inf
    y64 = y.double().reshape(x64.shape[0], a.shape[1])
    if not torch.isfinite(y64).all():
        return math.inf
    gap = (y64 - x64 @ a64).abs()
    scale = x64.abs() @ a64.abs()
    zero = scale == 0
    if (gap[zero] > 0).any():
        return math.inf
    return float((gap[~zero] / scale[~zero]).max()) if (~zero).any() else 0.0


class Control:
    """The control: the reference in the program's place, its operands
    rounded to TF32 (10 mantissa bits) and summed in float32, as a TF32
    tensor-core product computes. The configuration states float32 with
    TF32 off, so this is the nearest precision below it."""

    def __init__(self, cfg: dict):
        torch.backends.cuda.matmul.allow_tf32 = False

    def pack(self, a: torch.Tensor, batch: int) -> torch.Tensor:
        return tf32(a)

    def product(self, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return tf32(x) @ p

    def route(self, p) -> str:
        return "control: dense TF32"
