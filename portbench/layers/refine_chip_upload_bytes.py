"""Bytes the chip refinement backend copies from the host to the device a
solve as it builds its shift batches (counter
``nt.refine.chip.upload_bytes``: a plan's device form, once a plan, and
every batch's weights), over the profiled solves; nothing where the
traffic refines on the host or the program counts no such bytes."""
from portbench.spans import traced


def read(record):
    got = traced(record)
    if got is None or "nt.refine.chip.upload_bytes" not in got[1]:
        return None
    return got[1]["nt.refine.chip.upload_bytes"] / got[2]
