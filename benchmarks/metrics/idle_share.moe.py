"""The device's idle share in the FFN stack: 1 - (the union of the device
operations' intervals) / (the traced window)."""

from benchmarks.readers import idle_share


def read(rec):
    return idle_share(rec, "tps.moe")
