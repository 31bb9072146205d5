"""Seconds the process paid once to load the port: the import of
``neptpu_torch`` (span ``nt.load.import``) and the load, or build, of the
kernel library (``nt.load.kernel_library``), from the program's load
totals."""
from portbench.spans import program_trace


def read(record):
    trace = program_trace()
    if trace is None:
        return None
    load = trace.load_totals()
    parts = [load[name]["seconds"] for name in (
        "nt.load.import", "nt.load.kernel_library") if name in load]
    return sum(parts) if parts else None
