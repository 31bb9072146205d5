"""Seconds a solve of the error measure inside the scan's host Ritz checks
(span ``nt.scan.check.measure``: the user's ``errmeasure`` on the most
promising Ritz pairs), over the profiled solves."""
from portbench.spans import mean_seconds


def read(record):
    return mean_seconds(record, "nt.scan.check.measure")
