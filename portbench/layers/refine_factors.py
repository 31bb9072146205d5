"""Shifted factorizations the Newton refinement makes a solve (counter
``nt.refine.factorizations``: one a ``splu``, one a shift of a batched
device factorization), over the profiled solves; nothing where the
traffic refines nothing."""
from portbench.spans import traced


def read(record):
    got = traced(record)
    if got is None or "nt.refine.factorizations" not in got[1]:
        return None
    return got[1]["nt.refine.factorizations"] / got[2]
