"""Shifts of the chip refinement backend a solve whose probe solve failed
and that went to a host ``splu`` instead (counter
``nt.refine.chip.fallbacks``), over the profiled solves; nothing where the
traffic refines on the host or the program counts no fallbacks."""
from portbench.spans import traced


def read(record):
    got = traced(record)
    if got is None or "nt.refine.chip.fallbacks" not in got[1]:
        return None
    return got[1]["nt.refine.chip.fallbacks"] / got[2]
