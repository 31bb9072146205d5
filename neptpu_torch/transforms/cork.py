"""CORK pencils (compact rational Krylov linearizations): ``CORKPencil``
from the IAR-Taylor or the NLEIGS Leja-Bagby structure, ``build_pencil``
assembling the generalized pencil ``(A, B)``, and the low-rank tail
compression ``CORKPencilLR``/``low_rank_compress``.

The pencil's blocks are host numpy (complex128 where the structure is
complex), as the small pencils of the rational solvers are; ``build_pencil``
returns the assembled pair as tensors on the requested device (the card by
default)."""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..core.nep import compute_Mder

__all__ = [
    "CORKPencil",
    "CORKPencilLR",
    "CorkLinearization",
    "DefaultCorkLinearization",
    "IarCorkLinearization",
    "NleigsCorkLinearization",
    "build_pencil",
    "low_rank_compress",
]


def _dense(M):
    if isinstance(M, np.ndarray):
        return M
    if not isinstance(M, torch.Tensor):
        M = M.to_dense()
    return M.detach().cpu().numpy()


class CorkLinearization:
    """Strategy base for CORKPencil construction."""


class IarCorkLinearization(CorkLinearization):
    def __init__(self, d: int = 10):
        self.d = d


class DefaultCorkLinearization(IarCorkLinearization):
    """The default strategy: the IAR/Taylor linearization."""


class NleigsCorkLinearization(CorkLinearization):
    def __init__(self, Sigma=(-1.0 - 1j, -1.0 + 1j, 1.0 + 1j, 1.0 - 1j),
                 Xi=(np.inf,), maxdgr: int = 100, tollin: float = 1e-6):
        self.Sigma = list(Sigma)
        self.Xi = list(Xi)
        self.maxdgr = maxdgr
        self.tollin = tollin


class CORKPencil:
    def __init__(self, M, N, Av, Bv):
        self.M = np.asarray(M)
        self.N = np.asarray(N)
        self.Av = [_dense(A) for A in Av]
        self.Bv = [_dense(B) for B in Bv]

    @classmethod
    def from_nep(cls, nep, lin):
        if isinstance(lin, IarCorkLinearization):
            d = lin.d
            M = np.eye(d)[1:, :]
            N = np.diag(1.0 / np.arange(1, d), k=-1)[1:, :]
            Av = [-_dense(compute_Mder(nep, 0.0, 0))]
            Av += [np.zeros_like(Av[0]) for _ in range(d - 1)]
            Bv = [_dense(compute_Mder(nep, 0.0, j)) / j
                  for j in range(1, d + 1)]
            return cls(M, N, Av, Bv)
        if isinstance(lin, NleigsCorkLinearization):
            from ..solvers.rk.nleigs_coefficients import nleigs_coefficients

            D, beta, xi, sigma = nleigs_coefficients(
                nep, lin.Sigma, Xi=lin.Xi, maxdgr=lin.maxdgr,
                tollin=lin.tollin)
            D = [_dense(Dj) for Dj in D]
            d = len(beta) - 1
            sigma = np.asarray(sigma[: d + 1], dtype=complex)
            beta = np.asarray(beta[: d + 1], dtype=complex)
            xi = np.asarray(xi[: d + 1], dtype=complex)
            # M: sigma below the diagonal, beta on it; N: ones below, beta/xi
            # on it; both without their first row and last column
            Mfull = np.zeros((d + 1, d + 1), dtype=complex)
            Mfull[np.arange(1, d + 1), np.arange(d)] = sigma[:d]
            Mfull[np.arange(d), np.arange(d)] = beta[:d]
            M = Mfull[1:d, :d]
            Nfull = np.zeros((d + 1, d + 1), dtype=complex)
            Nfull[np.arange(1, d + 1), np.arange(d)] = 1.0
            Nfull[np.arange(d), np.arange(d)] = beta[:d] / xi[:d]
            N = Nfull[1:d, :d]
            Av = [D[j] for j in range(d - 1)]
            Av.append(D[d - 1] - sigma[d - 1] / beta[d] * D[d])
            Bv = [D[j] / xi[d] for j in range(d - 1)]
            Bv.append(D[d - 1] / xi[d] - D[d] / beta[d])
            return cls(M, N, Av, Bv)
        raise ValueError(f"unknown linearization {lin}")


def _out(A, B, device):
    device = resolve_device(device)
    return (torch.as_tensor(A, device=device),
            torch.as_tensor(B, device=device))


def build_pencil(cp, device=None):
    """``(A, B)`` of the generalized pencil, as tensors on ``device``."""
    if isinstance(cp, CORKPencilLR):
        return _build_pencil_lr(cp, device)
    n = cp.Av[0].shape[0]
    I = np.eye(n)
    A = np.vstack([np.hstack(cp.Av), np.kron(cp.M, I)])
    B = np.vstack([np.hstack(cp.Bv), np.kron(cp.N, I)])
    return _out(A, B, device)


class CORKPencilLR:
    def __init__(self, M, N, Av, AvLR, Bv, BvLR, Z):
        self.M = np.asarray(M)
        self.N = np.asarray(N)
        self.Av = [np.asarray(A) for A in Av]
        self.AvLR = [np.asarray(A) for A in AvLR]
        self.Bv = [np.asarray(B) for B in Bv]
        self.BvLR = [np.asarray(B) for B in BvLR]
        self.Z = np.asarray(Z)


def low_rank_compress(cp_org: CORKPencil, dtilde: int, rk: int):
    """Take the terms beyond ``dtilde`` to have rank ``rk`` and factor them
    through ``Z``."""
    d = len(cp_org.Av)
    Z = np.linalg.svd(cp_org.Bv[dtilde])[2].conj().T[:, :rk]
    if (np.linalg.norm(cp_org.M[: dtilde - 1, dtilde:]) > 0
            or np.linalg.norm(cp_org.N[: dtilde - 1, dtilde:]) > 0):
        raise ValueError("The M-matrix does not have the required structure. "
                         "Try increasing dtilde.")
    Bvtilde = [cp_org.Bv[i] @ Z for i in range(dtilde, d)]
    Avtilde = [cp_org.Av[i] @ Z for i in range(dtilde, d)]
    return CORKPencilLR(cp_org.M, cp_org.N, cp_org.Av[:dtilde], Avtilde,
                        cp_org.Bv[:dtilde], Bvtilde, Z)


def _build_pencil_lr(cp: CORKPencilLR, device):
    n = cp.Av[0].shape[0]
    dtilde = len(cp.Av)
    d = dtilde + len(cp.AvLR)
    rk = cp.Z.shape[1]
    In = np.eye(n)
    Irk = np.eye(rk)
    M11 = cp.M[: dtilde - 1, :dtilde]
    M21 = cp.M[dtilde - 1:, :dtilde]
    M22 = cp.M[dtilde - 1:, dtilde:]
    N11 = cp.N[: dtilde - 1, :dtilde]
    N21 = cp.N[dtilde - 1:, :dtilde]
    N22 = cp.N[dtilde - 1:, dtilde:]
    Bt1 = np.hstack(list(cp.Bv) + list(cp.BvLR))
    Bt2 = np.hstack([np.kron(N11, In),
                     np.zeros(((dtilde - 1) * n, (d - dtilde) * rk))])
    Bt3 = np.hstack([np.kron(N21, cp.Z.conj().T), np.kron(N22, Irk)])
    B = np.vstack([Bt1, Bt2, Bt3])
    At1 = np.hstack(list(cp.Av) + list(cp.AvLR))
    At2 = np.hstack([np.kron(M11, In),
                     np.zeros(((dtilde - 1) * n, (d - dtilde) * rk))])
    At3 = np.hstack([np.kron(M21, cp.Z.conj().T), np.kron(M22, Irk)])
    A = np.vstack([At1, At2, At3])
    return _out(A, B, device)
