"""Share of the Newton refinement's calls that reuse the held host forms of
their terms (100 times counter ``nt.refine.ops_held`` over it plus
``nt.refine.ops_built``), over the profiled solves; nothing where the
traffic refines nothing or the program counts neither."""
from portbench.spans import traced


def read(record):
    got = traced(record)
    if got is None:
        return None
    held = got[1].get("nt.refine.ops_held", 0)
    built = got[1].get("nt.refine.ops_built", 0)
    if not held + built:
        return None
    return 100.0 * held / (held + built)
