"""Seconds a solve of the Newton refinement's host residual products (span
``nt.refine.residual``: the per-term products of the sweeps, of the chip
backend's probe solves and of the default measure, and their weighted
sums), over the profiled solves, on the host's clock; nothing where the
traffic refines nothing or the program records no such span."""
from portbench.spans import mean_seconds


def read(record):
    return mean_seconds(record, "nt.refine.residual")
