"""Passes of the Newton refinement a solve, each chunk's first and each
straggler pass (the calls of span ``nt.refine.factor``: on the chip backend
one a pass, its batched factorization and probe; on the host one a pass
that factors, which is every pass where no solver was handed in), over the
profiled solves; nothing where the traffic refines nothing or the program
records no such span."""
from portbench.spans import traced


def read(record):
    got = traced(record)
    if got is None or "nt.refine.factor" not in got[0]:
        return None
    return got[0]["nt.refine.factor"]["calls"] / got[2]
