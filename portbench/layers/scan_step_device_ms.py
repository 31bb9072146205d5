"""Device milliseconds a replayed scan step: the CUDA-event time of the
runs of replays (span ``nt.scan.steps``) over the replays
(``nt.scan.replays``), summed over the profiled solves."""
from portbench.spans import traced


def read(record):
    got = traced(record)
    if got is None:
        return None
    totals, counters, _ = got
    ms = totals.get("nt.scan.steps", {}).get("device_ms")
    replays = counters.get("nt.scan.replays", 0)
    return ms / replays if ms is not None and replays else None
