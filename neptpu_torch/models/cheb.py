"""ChebPEP: the Chebyshev interpolant of a NEP on [a, b].

The interpolant is an SPMF whose term functions are the Chebyshev
polynomials T_j scaled to [a, b], evaluated on matrices by the three-term
recurrence (exact for polynomials and valid on Jordan-chain inputs).  The
coefficients are formed on the host from the samples ``M(x_k)`` at the
Chebyshev points; the bank lives on the original problem's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.sparse import make_term_bank
from ..solvers.common import nep_device
from .spmf import SPMF_NEP

__all__ = ["ChebPEP", "chebyshev_nodes", "chebyshev_compute_coefficients",
           "cheb_fun"]


def chebyshev_nodes(a, b, k):
    """k Chebyshev points scaled to [a, b]."""
    return (a + b) / 2 + (b - a) / 2 * np.cos(
        (2 * np.arange(1, k + 1) - 1) * np.pi / (2 * k))


def cheb_fun(a, b, j):
    """Matrix function ``S -> T_j(2 (S - aI)/(b-a) - I)`` by the three-term
    recurrence."""

    def f(S):
        I = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
        X = 2.0 * (S - a * I) / (b - a) - I
        if j == 0:
            return I
        Tkm1, Tk = I, X
        for _ in range(j - 1):
            Tkm1, Tk = Tk, 2.0 * X @ Tk - Tkm1
        return Tk

    return f


def chebyshev_compute_coefficients(a, b, Fk, xk):
    """Chebyshev coefficients of the matrix samples ``Fk`` at the Chebyshev
    points ``xk`` (Mason & Handscomb, ch. 8)."""
    k = len(Fk)
    t = 2 * (np.asarray(xk) - a) / (b - a) - 1
    theta = np.arccos(np.clip(t, -1, 1))
    Tmat = np.cos(np.arange(k)[:, None] * theta[None, :]) * 2 / k
    Tmat[0, :] *= 0.5
    return [sum(Fk[j] * Tmat[i, j] for j in range(k)) for i in range(k)]


class ChebPEP(SPMF_NEP):
    """Chebyshev-basis interpolant of ``orgnep`` with ``k`` interpolation
    points on [a, b]; ``device``: where its bank lives (default: the
    original's device, else the card)."""

    def __init__(self, orgnep, k: int = 9, a: float = -1.0, b: float = 1.0,
                 device=None):
        if device is None:
            device = nep_device(orgnep)
        xk = chebyshev_nodes(a, b, k)
        Fk = []
        for x in xk:
            M = orgnep.Mder(x)
            M = M if isinstance(M, torch.Tensor) else M.to_dense()
            Fk.append(M.detach().cpu().numpy())
        Ck = chebyshev_compute_coefficients(a, b, Fk, xk)
        super().__init__(None, [cheb_fun(a, b, j) for j in range(k)],
                         bank=make_term_bank(Ck, device=device))
        self.a = float(a)
        self.b = float(b)
        self.k = k
        self.orgnep = orgnep
