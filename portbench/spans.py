"""The program's own spans and counters, as the readers in ``layers/`` take
them.

``neptpu_torch.trace`` records, while the torch profiler runs, what the
program's spans and counters saw into its profile collector: in a traced
run, the first ``harness.TRACE_SOLVES`` solves of the window.  A reader
takes the collector's totals over those solves (the window's records
marked ``traced``).  A program without ``neptpu_torch.trace`` gives
nothing, and the reader returns None.
"""


def program_trace():
    """The module ``neptpu_torch.trace``, or None where the program has
    none."""
    try:
        from neptpu_torch import trace
    except ImportError:
        return None
    return trace


def traced(record):
    """``(totals, counters, solves)`` of the profiled solves: the profile
    collector's totals by span name and its counters, and how many solves
    ran under the profiler; None where the program records no spans or no
    solve was profiled."""
    trace = program_trace()
    solves = sum(1 for s in record["window"]["solves"] if s["traced"])
    if trace is None or not solves:
        return None
    col = trace.profiled()
    return col.totals(), col.counters(), solves


def mean_seconds(record, name):
    """Seconds of the span ``name`` a profiled solve; None where it never
    ran."""
    got = traced(record)
    if got is None or name not in got[0]:
        return None
    return got[0][name]["seconds"] / got[2]
