"""Seconds a solve of the chip refinement backend's host assembly: the
banded and low-rank parts of M(sigma) at every shift, interleaved and
stacked for the device (span ``nt.refine.chip.assemble`` in
``BatchedShiftSMW``), over the profiled solves; nothing where the traffic
refines on the host."""
from portbench.spans import mean_seconds


def read(record):
    return mean_seconds(record, "nt.refine.chip.assemble")
