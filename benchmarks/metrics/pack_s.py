"""Host seconds of set-up spent making the program's operator from the
inputs: ``auto_format`` (statistics, pack and upload) over the stack, or
the device-built ``DiaMatrix``."""


def read(rec):
    v = rec["counters"].get("pack_s")
    return None if v is None else float(v)
