"""Krylov orthogonalization: tall-skinny products ``V^H w`` and updates
``w - V h`` on the device of the basis.  Strategies: DGKS (iterated classical
Gram-Schmidt with the eta criterion), classical and modified Gram-Schmidt.
"""
from __future__ import annotations

import math

import torch

from ..core.exceptions import LostOrthogonalityException

__all__ = ["DGKS", "ClassicalGS", "ModifiedGS", "orthogonalize_and_normalize"]


class DGKS:
    def __init__(self, eta: float = 1 / math.sqrt(2), max_reorth: int = 3):
        self.eta = float(eta)
        self.max_reorth = max_reorth


class ClassicalGS:
    pass


class ModifiedGS:
    pass


_METHODS = (DGKS, ClassicalGS, ModifiedGS)


def _cgs_step(V, w):
    h = V.conj().T @ w
    return w - V @ h, h


def orthogonalize_and_normalize(V, w, method=None):
    """Orthogonalize w against the (orthonormal) columns of V.

    Returns ``(w_out, h, beta)`` with ``w_out`` unit-norm, ``h`` the
    projection coefficients (accumulated over reorthogonalizations) and
    ``beta`` the normalization factor — the (k+1, k) Hessenberg entry.

    ``method``: an instance of DGKS/ClassicalGS/ModifiedGS, one of those
    classes (instantiated with its defaults), or any other callable with the
    same ``(V, w) -> (w_unit, h, beta)`` contract.
    """
    if method is None:
        method = DGKS()
    if isinstance(method, type) and issubclass(method, _METHODS):
        method = method()
    if not isinstance(method, _METHODS):
        if callable(method):
            return method(V, w)
        raise TypeError(
            f"orthmethod must be DGKS/ClassicalGS/ModifiedGS or a "
            f"callable (V, w) -> (w, h, beta); got {type(method).__name__}")
    w = torch.as_tensor(w, device=V.device)
    k = V.shape[1]
    dt = torch.promote_types(V.dtype, w.dtype)
    V = V.to(dt)
    w = w.to(dt)
    if k == 0:
        beta = torch.linalg.vector_norm(w)
        return w / beta, torch.zeros(0, dtype=dt, device=V.device), beta

    if isinstance(method, ModifiedGS):
        h = []
        for j in range(k):
            hj = torch.vdot(V[:, j], w)
            w = w - hj * V[:, j]
            h.append(hj)
        h = torch.stack(h)
    elif isinstance(method, ClassicalGS):
        w, h = _cgs_step(V, w)
    else:  # DGKS
        norm0 = float(torch.linalg.vector_norm(w))
        w, h = _cgs_step(V, w)
        for _ in range(method.max_reorth):
            norm1 = float(torch.linalg.vector_norm(w))
            if norm1 > method.eta * norm0:
                break
            norm0 = norm1
            w, dh = _cgs_step(V, w)
            h = h + dh
    beta = torch.linalg.vector_norm(w)
    if float(beta) == 0.0:
        raise LostOrthogonalityException(
            "breakdown: candidate vector in span of basis")
    return w / beta, h, beta
