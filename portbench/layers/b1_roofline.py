"""Per cent of its roofline that kernel B1 (the stacked-DIA SpMV) reaches in
the traced solves: the least time of every B1 launch by the frozen bound
(each input read once, each output written once, against the published
3.35 TB/s and 67 TFLOP/s float32 of one H100), summed, over the launches'
summed device time from the profiler's trace.  Each launch is read from its
kernel's name: the pair or the single entry, and the data type; its shape
is that of the cell's bank."""
import re

from portbench.measures import bound

TYPES = {"float": ("float32", 4), "double": ("float64", 8),
         "__nv_bfloat16": ("bfloat16", 2)}


def launch(name):
    """``(operands, dtype name, itemsize)`` of a B1 launch, or None."""
    m = re.search(r"dia_lincomb(_pair)?_kernel<\s*(\w+)", name)
    if m is None or m.group(2) not in TYPES:
        return None
    return (2 if m.group(1) else 1,) + TYPES[m.group(2)]


def read(record):
    tr, shape = record["trace"], record["b1_shape"]
    if not tr or shape is None:
        return None
    n, m, ndiag = shape
    least = spent = 0.0
    for name, dur_us in tr["b1"]:
        kind = launch(name)
        if kind is None or dur_us <= 0:
            continue
        ops, dtype, size = kind
        least += bound(n, m, ndiag, ops, size, dtype)[0] * 1e3
        spent += dur_us
    return 100.0 * least / spent if spent else None
