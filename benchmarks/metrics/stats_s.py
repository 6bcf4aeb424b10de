"""Host seconds of set-up in the router's statistics: the program's
counter ``auto_format.stats_s``, A's copy to the host through
``matrix_stats``, summed over the stack's packs. A part of ``pack_s``.

The counter runs from the process's start and only ``auto_format`` moves
it: a run packs its stack once, at set-up, so the reading is set-up's.
Only a program module the run has loaded is read; a program without the
counter gives None."""

import sys


def read(rec):
    auto = getattr(sys.modules.get("tpusparse_torch.formats.auto"),
                   "auto_format", None)
    v = getattr(auto, "stats_s", None)
    return None if v is None else float(v)
