"""Seconds a solve of the scan's first step and CUDA graph capture (span
``nt.scan.capture`` in ``StepGraph.advance``), over the profiled
solves."""
from portbench.spans import mean_seconds


def read(record):
    return mean_seconds(record, "nt.scan.capture")
