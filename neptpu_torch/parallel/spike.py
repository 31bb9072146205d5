"""Row-interleaved real encoding of complex banded matrices (host numpy)."""
from __future__ import annotations

import numpy as np

__all__ = ["interleave_complex_banded"]


def interleave_complex_banded(strips, offsets):
    """Complex banded (strips over ``offsets``) -> real banded in the
    row-interleaved ordering x = [re_0, im_0, re_1, im_1, ...].

    Each complex entry ``z`` at (r, c) becomes the 2x2 block
    ``[[Re z, -Im z], [Im z, Re z]]`` at rows (2r, 2r+1) / cols (2c, 2c+1),
    so a complex offset ``d`` maps to real offsets ``2d-1, 2d, 2d+1`` and the
    matrix stays banded."""
    strips = np.asarray(strips)
    n = strips.shape[1]
    roffs = sorted({2 * d + s for d in offsets for s in (-1, 0, 1)})
    out = np.zeros((len(roffs), 2 * n), dtype=strips.real.dtype)
    idx = {o: j for j, o in enumerate(roffs)}
    r = np.arange(n)
    for j, d in enumerate(offsets):
        rows = r[: n - d] if d >= 0 else r[-d:]
        re = strips[j].real[rows]
        im = strips[j].imag[rows]
        out[idx[2 * d], 2 * rows] += re
        out[idx[2 * d], 2 * rows + 1] += re
        out[idx[2 * d + 1], 2 * rows] += -im
        out[idx[2 * d - 1], 2 * rows + 1] += im
    return out, roffs
