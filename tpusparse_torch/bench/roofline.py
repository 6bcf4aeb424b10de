"""Roofline accounting against the card's published HBM rate.

Every kernel of the headline path is bound by bytes, so the least time a
call can take is ``bytes / HBM rate``. The rate is the published peak of
the part (NVIDIA's data sheet: 3.35 TB/s for the H100 SXM), not a measured
one; results carry the card's name and ``power.limit`` beside it, because
a card capped below 700 W runs slower under load. A share above
``ARTIFACT_SHARE`` is physically impossible and is flagged as an artifact,
never reported as a result.
"""

from __future__ import annotations

import subprocess
from typing import Any

import torch

# Published HBM bandwidth per part (GB/s); matched on the lowered CUDA
# device name, longest key first ("h100 pcie" before "h100").
HBM_GBPS = {
    "h100": 3350.0,        # H100 SXM5 80 GB HBM3
    "h100 pcie": 2000.0,
    "h100 nvl": 3900.0,
    "h200": 4800.0,
}
ARTIFACT_SHARE = 1.05


def detect_hbm_gbps(kind: str | None = None) -> float:
    kind = (kind or torch.cuda.get_device_name(0)).lower()
    for key in sorted(HBM_GBPS, key=len, reverse=True):
        if key in kind:
            return HBM_GBPS[key]
    raise ValueError(f"no published HBM rate for {kind!r}; add it to HBM_GBPS")


def card_info() -> dict[str, Any]:
    """Name and power limit as ``nvidia-smi`` reports them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    line = out.strip().splitlines()[0]
    limit = line.split(",", 1)[1].strip()
    try:
        watts = float(limit.split()[0])
    except ValueError:              # "[N/A]" on parts that report none
        watts = None
    return {"line": line, "power_limit_w": watts}


def format_bytes(fmt: Any) -> int:
    """Total device bytes a kernel must stream to read this format once:
    ``read_bytes()`` where a format stores bytes no product needs (the
    zero slots of SELL, RSELL and TCSR's SELL tier, the zero blocks of BSR
    and TCSR's dense tier, BELL's zero pads and rank carries), else
    ``device_bytes()``."""
    if isinstance(fmt, torch.Tensor):
        return fmt.numel() * fmt.element_size()
    if hasattr(fmt, "read_bytes"):
        return int(fmt.read_bytes())
    return int(fmt.device_bytes())


def roofline_fraction(bytes_moved: int, seconds: float,
                      hbm_gbps: float | None = None) -> float:
    """Achieved fraction of the HBM speed of light for this byte count."""
    if hbm_gbps is None:
        hbm_gbps = detect_hbm_gbps()
    return bytes_moved / (hbm_gbps * 1e9) / seconds


def checked_share(bytes_moved: int, seconds: float, what: str,
                  hbm_gbps: float | None = None) -> float:
    """``roofline_fraction``, raising above ``ARTIFACT_SHARE``: such a time
    is an artifact of the measurement, never a result."""
    share = roofline_fraction(bytes_moved, seconds, hbm_gbps)
    if share > ARTIFACT_SHARE:
        raise AssertionError(f"{what}: share {share:.3f} of the bytes bound "
                             f"is above {ARTIFACT_SHARE}: an artifact, not "
                             f"a result")
    return share
