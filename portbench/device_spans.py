"""Seconds of a program span, a profiled solve, on the device's clock where
the span records CUDA events (``device=True`` spans on the card: the
device-stream interval between its two events, idle gaps inside the span
included), on the host's clock elsewhere (the CPU)."""
from portbench.spans import traced


def mean_device_seconds(record, name):
    """Seconds of the span ``name`` a profiled solve; None where it never
    ran or the program records no spans."""
    got = traced(record)
    if got is None or name not in got[0]:
        return None
    t = got[0][name]
    seconds = t["device_ms"] * 1e-3 if "device_ms" in t else t["seconds"]
    return seconds / got[2]
