"""Entries of L and U a shifted factorization of the Newton refinement
stores (counter ``nt.refine.lu_fill``, SuperLU's stored count of each
``splu``, over ``nt.refine.factorizations``: on the host backend every
factorization is a ``splu``), over the profiled solves; nothing where the
traffic refines nothing or the program counts no fill."""
from portbench.spans import traced


def read(record):
    got = traced(record)
    if got is None:
        return None
    counters = got[1]
    if "nt.refine.lu_fill" not in counters \
            or not counters.get("nt.refine.factorizations"):
        return None
    return counters["nt.refine.lu_fill"] / counters["nt.refine.factorizations"]
