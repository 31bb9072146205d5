"""Seconds a solve of the Newton refinement's shifted factorizations (span
``nt.refine.factor``: a scipy ``splu`` a pair on the host backend), over
the profiled solves; nothing where the traffic refines nothing."""
from portbench.spans import mean_seconds


def read(record):
    return mean_seconds(record, "nt.refine.factor")
