"""What the plain references share: seed streams and TF32 rounding.
Plain torch and numpy; nothing of the program."""

from __future__ import annotations

import numpy as np
import torch


def stream_seed(seed: int, *tags: int) -> int:
    """A 64-bit generator seed for one input stream of a run's ``seed``."""
    ss = np.random.SeedSequence([seed % 2 ** 64, *tags])
    return int(ss.generate_state(1, np.uint64)[0])


def generator(device, seed: int, *tags: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *tags))
    return g


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (fp32) rounded to TF32's 10 mantissa bits, to nearest even:
    what a TF32 tensor-core product does to its operands."""
    b = t.contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & -0x2000
    return b.view(torch.float32)
