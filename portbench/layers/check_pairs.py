"""Ritz pairs the scan's host peeks hand to the user's ``errmeasure`` a
solve (counter ``nt.scan.check.pairs``), over the profiled solves; nothing
where the program counts no such pairs."""
from portbench.spans import traced


def read(record):
    got = traced(record)
    if got is None or "nt.scan.check.pairs" not in got[1]:
        return None
    return got[1]["nt.scan.check.pairs"] / got[2]
