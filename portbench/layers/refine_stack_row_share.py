"""Share of the rows one tall stack of all terms would hold that the
Newton refinement's residual products compute (100 times counter
``nt.refine.stack_rows`` over ``nt.refine.stack_rows_full``, the terms
stacked by row support against all terms over all rows), over the profiled
solves; nothing where the traffic refines nothing or the program counts no
such rows."""
from portbench.spans import traced


def read(record):
    got = traced(record)
    if got is None:
        return None
    rows = got[1].get("nt.refine.stack_rows")
    full = got[1].get("nt.refine.stack_rows_full")
    if rows is None or not full:
        return None
    return 100.0 * rows / full
