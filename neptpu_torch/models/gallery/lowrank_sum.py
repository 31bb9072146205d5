"""Gallery problems combining a sum of problems with low-rank factorized
terms: the sine problem and the Schrodinger equation with a moving boundary
condition."""
from __future__ import annotations

import numpy as np
import torch

from ...config import resolve_device
from ...ops import matfun
from ..lowrank import LowRankFactorizedNEP
from ..pep import PEP
from ..spmf import SPMF_NEP
from ..sumnep import SPMFSumNEP, SumNEP

__all__ = ["make_sine_nep", "schrodinger_movebc"]


def make_sine_nep(load, device=None):
    """PEP + rank-2 matrix-sine term; ``load(relpath)`` reads the data
    files ``converted_sine/sine_{A0,A1,A2,V,Q}``."""
    import scipy.sparse as sp

    device = resolve_device(device)
    A0 = load("converted_sine/sine_A0.txt")
    A1 = load("converted_sine/sine_A1.txt")
    A2 = load("converted_sine/sine_A2.txt")
    V = load("converted_sine/sine_V.txt").toarray()
    Q = load("converted_sine/sine_Q.txt").toarray()
    n = A0.shape[0]
    Z = sp.csr_matrix((n, n))
    pep = PEP([A0, A1, Z, Z, A2], device=device)
    sin_nep = SPMF_NEP([V @ Q.T], [matfun.sinm], device=device)
    return SPMFSumNEP(pep, sin_nep)


def schrodinger_movebc(n=1000, L0=1.0, L1=8.0, alpha=25 * np.pi / 2,
                       V0=10.0, device=None):
    """Schrodinger equation with a moving boundary condition: an SPMF plus
    low-rank sinh/cosh/sqrt terms."""
    import scipy.sparse as sp

    device = resolve_device(device)
    xv = np.linspace(0, L0, n)
    h = xv[1] - xv[0]

    def Vfun(x):
        return 1 + np.sin(alpha * x)

    # short diagonals padded with zeros to the common size n
    Dn = sp.diags(
        [np.concatenate([np.ones(n - 2), [0.0]]) / h**2,
         np.concatenate([-2 * np.ones(n - 1), [0.0]]) / h**2,
         np.ones(n - 1) / h**2],
        [-1, 0, 1], shape=(n, n)).tocsr()
    Vn = sp.diags(np.concatenate([Vfun(xv[:-1]), [0.0]])).tocsr()
    In = sp.diags(np.concatenate([np.ones(n - 1), [0.0]])).tocsr()

    def hh(S):
        return matfun.sqrtm(S + V0 * matfun.eye_like(S))

    def g(S):
        return matfun.coshm((L1 - L0) * hh(S))

    def f(S):
        H = hh(S)
        if S.ndim >= 2:
            return torch.linalg.solve(H, matfun.sinhm((L1 - L0) * H))
        return matfun.sinhm((L1 - L0) * H) / H

    nep1 = SPMF_NEP([Dn - Vn, In], [matfun.eye_like, lambda S: -S],
                    device=device)
    Lv1 = np.zeros((n, 1))
    Lv1[-1, 0] = 1.0
    Lv2 = np.zeros((n, 1))
    Lv2[-1, 0] = 1.0
    Uv1 = np.zeros((n, 1))
    Uv1[-1, 0] = 1.0
    Uv2 = np.zeros((n, 1))
    Uv2[-3:, 0] = [1 / (2 * h), -2 / h, 3 / (2 * h)]
    nep2 = LowRankFactorizedNEP([Lv1, Lv2], [Uv1, Uv2], [g, f], device=device)
    return SumNEP(nep1, nep2)
