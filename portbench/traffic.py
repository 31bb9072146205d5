"""The one generator of the benchmark's traffic: a closed loop of solves,
each at a shift drawn from the run's seed as a traffic file describes it.

A traffic file's ``shift`` holds ``real``, a ``[lo, hi]`` band, ``imag``, a
number, and ``points``: the band is cut into that many equal strata and
their midpoints are the sweep's shifts, as a user sweeping the band on a
grid sends them.  Every block of ``points`` consecutive requests visits each
point once, in an order drawn from the seed.  So every seed asks for the
same set of shifts, and a window of whole blocks does the same work
whatever the seed, in another order.
"""
from __future__ import annotations

import numpy as np


def rng_of(seed):
    """A NumPy generator for any whole number (negative ones included)."""
    seed = int(seed)
    return np.random.default_rng([abs(seed), int(seed < 0)])


def grid(traffic):
    """The sweep's shifts: the midpoints of the band's strata."""
    spec = traffic["shift"]
    lo, hi = (float(x) for x in spec["real"])
    n = int(spec["points"])
    return [complex(lo + (i + 0.5) * (hi - lo) / n, float(spec["imag"]))
            for i in range(n)]


def shift_stream(traffic, seed):
    """The endless sequence of complex shifts of a run with ``seed``."""
    points = grid(traffic)
    rng = rng_of(seed)
    while True:
        for i in rng.permutation(len(points)):
            yield points[i]


def warmup_shift(traffic):
    """The set-up's warm-up shift: the middle of the band, which no grid of
    an even number of points holds."""
    lo, hi = (float(x) for x in traffic["shift"]["real"])
    return complex(0.5 * (lo + hi), float(traffic["shift"]["imag"]))
