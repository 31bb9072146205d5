"""Seconds a solve of the chip refinement backend's batched float32 SPIKE
factorization of every shift, with the float64 band it refines against
(span ``nt.refine.chip.factor`` in ``BatchedShiftSMW``), over the profiled
solves, on the device's clock on the card; nothing where the traffic
refines on the host."""
from portbench.device_spans import mean_device_seconds


def read(record):
    return mean_device_seconds(record, "nt.refine.chip.factor")
