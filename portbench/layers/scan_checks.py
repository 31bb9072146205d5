"""Host peeks of the IAR scan a solve, each a Ritz extraction and its
measure at a check (the calls of span ``nt.scan.check``), over the profiled
solves; nothing where the program records no such span."""
from portbench.spans import traced


def read(record):
    got = traced(record)
    if got is None or "nt.scan.check" not in got[0]:
        return None
    return got[0]["nt.scan.check"]["calls"] / got[2]
