"""Seconds a solve of the chip refinement backend's low-rank correction:
the float64 solves B^-1 L of every shift and the inverse of each 2R x 2R
capacitance (span ``nt.refine.chip.smw`` in ``BatchedShiftSMW``), over the
profiled solves, on the device's clock on the card; nothing where the
traffic refines on the host."""
from portbench.device_spans import mean_device_seconds


def read(record):
    return mean_device_seconds(record, "nt.refine.chip.smw")
