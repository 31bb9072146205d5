"""Seconds a solve the Newton refinement spends on its terms' host forms
(span ``nt.refine.ops``: the test that the terms are those of the held
forms, and on a miss the build of the row-support groups), over the
profiled solves, on the host's clock; nothing where the traffic refines
nothing or the program records no such span."""
from portbench.spans import mean_seconds


def read(record):
    return mean_seconds(record, "nt.refine.ops")
