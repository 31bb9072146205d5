"""Target-set discretization and the point-in-polygon test, on the host in
numpy (the JAX package's ``neptpu/solvers/rk/polygon.py``, copied)."""
from __future__ import annotations

import numpy as np

__all__ = ["discretizepolygon", "inpolygon"]


def _det3p(q1x, q1y, q2x, q2y, px, py):
    return (q1x - px) * (q2y - py) - (q2x - px) * (q1y - py)


def inpolygon(px, py, polyx, polyy):
    """Hormann-Agathos crossing test."""
    if not (np.isfinite(px) and np.isfinite(py)):
        return False
    c = False
    npts = len(polyx)
    for idx in range(npts):
        q1x, q1y = polyx[idx], polyy[idx]
        q2x, q2y = polyx[(idx + 1) % npts], polyy[(idx + 1) % npts]
        if q1x == px and q1y == py:
            return True  # on vertex
        if q2y == py:
            if q2x == px:
                return True
            if q1y == py and (q2x > px) == (q1x < px):
                return True  # on edge
        if (q1y < py) != (q2y < py):  # crossing
            if q1x >= px:
                if q2x > px:
                    c = not c
                else:
                    det = _det3p(q1x, q1y, q2x, q2y, px, py)
                    if np.isclose(det, 0):
                        return True
                    if (det > 0) == (q2y > q1y):
                        c = not c
            elif q2x > px:
                det = _det3p(q1x, q1y, q2x, q2y, px, py)
                if np.isclose(det, 0):
                    return True
                if (det > 0) == (q2y > q1y):
                    c = not c
    return c


def discretizepolygon(z=None, include_interior_points=False, npts=10000, nptsint=5):
    """Boundary (and optionally interior) discretization of a polygon, disk
    (single point) or interval (two points)."""
    if z is None or len(z) == 0:
        z = [0.0 + 0.0j]
    z = [complex(p) for p in z]
    if len(z) == 1:
        zz = list(z[0] + np.exp(2j * np.pi * np.arange(1, npts + 1) / npts))
    elif len(z) == 2:
        zz = list(
            (z[1] - z[0]) / 2 * (np.cos(np.pi * np.arange(npts - 1, -1, -1) / (npts - 1)) + 1)
            + z[0]
        )
    else:
        zcl = z + [z[0]]
        L = sum(abs(zcl[i + 1] - zcl[i]) for i in range(len(zcl) - 1))
        ind = 0
        alph = 0.0
        zz = [zcl[0]]
        remL = L / npts
        while len(zz) < npts:
            d = abs(zcl[ind + 1] - zcl[ind])
            if (1 - alph) * d < remL:
                ind += 1
                remL -= (1 - alph) * d
                alph = 0.0
            else:
                alph += remL / d
                remL = L / npts
                zz.append(zcl[ind] + alph * (zcl[ind + 1] - zcl[ind]))
        z = zcl
    zz = np.asarray(list(zz) + list(z), dtype=complex)

    if not include_interior_points:
        return zz, np.zeros(0, dtype=complex)

    if len(z) == 2:
        xnr = 2 * nptsint
        if xnr % 2 == 0:
            xnr += 1
        xpts = np.linspace(z[0], z[1], xnr)
        return zz, np.asarray(xpts[1::2], dtype=complex)

    points = zz[: len(zz) - len(z)] if len(z) == 1 else np.asarray(z)
    realz = np.real(points)
    imagz = np.imag(points)
    real_min, real_max = realz.min(), realz.max()
    imag_min, imag_max = imagz.min(), imagz.max()
    Z = np.zeros(0, dtype=complex)
    it = 0
    spacing = (real_max - real_min) / 2.0001 / np.sqrt(nptsint)
    while len(Z) < nptsint:
        it += 1
        if it > 10:
            raise RuntimeError(
                "Failed to find interior polygon points. Polygon too narrow? "
                "(Note that intervals should be given by their two endpoints only.)"
            )
        xnr = int((real_max - real_min) / (2 * spacing))
        ynr = int((imag_max - imag_min) / (2 * spacing))
        spacing /= 2**0.25
        if xnr <= 1 or ynr <= 1:
            continue
        xpts = np.linspace(real_min, real_max, xnr)[1::2]
        ypts = np.linspace(imag_min - 1e-16, imag_max + 1e-16, ynr)[1::2]
        cand = np.array([x + 1j * y for x in xpts for y in ypts])
        Z = np.array([p for p in cand if inpolygon(p.real, p.imag, realz, imagz)])
    return zz, Z
