"""Shifts the chip refinement backend factors and solves on the device a
solve, those that pass its probe solve (counter
``nt.refine.chip.shifts``), over the profiled solves; nothing where the
traffic refines on the host or the program counts no such shifts."""
from portbench.spans import traced


def read(record):
    got = traced(record)
    if got is None or "nt.refine.chip.shifts" not in got[1]:
        return None
    return got[1]["nt.refine.chip.shifts"] / got[2]
