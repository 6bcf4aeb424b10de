"""The yardstick's table of peaks and its shares.

Frozen here, apart from the program, so that a change to the program cannot
move the yardstick. Published rates of the part (NVIDIA's data sheet, SXM
part, dense, at its full 700 W); every run prints the card's name and power
limit beside them, since a card capped below 700 W runs slower under load.
"""

from __future__ import annotations

import subprocess

# HBM bytes/s and float32 FLOP/s outside the tensor cores, matched on the
# lowered CUDA device name, longest key first ("h100 pcie" before "h100")
PEAKS = {
    "h100": {"hbm_Bps": 3.35e12, "fp32_flops": 67e12},       # H100 SXM5
    "h100 pcie": {"hbm_Bps": 2.0e12, "fp32_flops": 51e12},
    "h100 nvl": {"hbm_Bps": 3.9e12, "fp32_flops": 60e12},
    "h200": {"hbm_Bps": 4.8e12, "fp32_flops": 67e12},
}
# a share of a bound above this is an artifact of the counting or the
# timing, never a result: the run fails
ARTIFACT_SHARE = 1.05


def peaks_of(kind: str) -> dict[str, float]:
    kind = kind.lower()
    for key in sorted(PEAKS, key=len, reverse=True):
        if key in kind:
            return PEAKS[key]
    raise ValueError(f"no published peaks for {kind!r}")


def card_info() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def share(amount: float, seconds: float, peak: float, what: str) -> float:
    """``amount / peak`` over ``seconds``, in percent; raises above
    ``ARTIFACT_SHARE``."""
    s = amount / peak / seconds
    if s > ARTIFACT_SHARE:
        raise AssertionError(f"{what}: {100 * s:.2f}% of its bound is above "
                             f"{100 * ARTIFACT_SHARE:.0f}%: the amount is "
                             f"counted too high or the time leaves out work")
    return 100.0 * s
