"""The three-function compute protocol — the core contract of the framework.

Every solver is written against three operations plus ``size``:

1. ``compute_Mder(nep, lam, der)``            -> the matrix M^(der)(lam)
2. ``compute_Mlincomb(nep, lam, V, a, sd)``   -> sum_j a_j M^(j+sd)(lam) V[:, j]
   (the hot operation — structured types lower it to the fused DIA SpMV)
3. ``compute_MM(nep, S, V)``                  -> sum_i A_i V f_i(S)

Any one of them suffices: the conversions below re-derive the others through
matrix-function identities.
"""
from __future__ import annotations

import torch

from ..ops import matfun

__all__ = [
    "NEP",
    "compute_Mder",
    "compute_Mlincomb",
    "compute_MM",
    "compute_resnorm",
    "mlincomb_from_mder",
    "mlincomb_from_mm",
    "mder_from_mm",
]


def _as_colmat(V):
    return V[:, None] if V.ndim == 1 else V


class NEP:
    """Abstract nonlinear eigenproblem M(lam) v = 0.

    Subclasses set ``self.n`` and implement at least one compute function;
    the others fall back to the conversions when possible."""

    n: int = 0

    @property
    def size(self):
        return self.n

    @property
    def issparse(self):
        return False

    def Mder(self, lam, der: int = 0):
        return mder_from_mm(self, lam, der)

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        try:
            return mlincomb_from_mm(self, lam, V, a, startder)
        except NotImplementedError:
            return mlincomb_from_mder(self, lam, V, a, startder)

    def MM(self, S, V):
        raise NotImplementedError(
            f"No procedure to compute MM for {type(self).__name__}")


def compute_Mder(nep: NEP, lam, der: int = 0):
    return nep.Mder(lam, der)


def compute_Mlincomb(nep: NEP, lam, V, a=None, startder: int = 0):
    return nep.Mlincomb(lam, V, a=a, startder=startder)


def compute_MM(nep: NEP, S, V):
    return nep.MM(S, V)


def compute_resnorm(nep: NEP, lam, v):
    """``||M(lam) v||``."""
    return torch.linalg.vector_norm(compute_Mlincomb(nep, lam, v))


def _dense(M):
    return M if isinstance(M, torch.Tensor) else M.to_dense()


def mlincomb_from_mder(nep: NEP, lam, V, a=None, startder: int = 0):
    """Slow fallback: ``sum_j a_j M^(j+startder)(lam) V[:, j]`` by assembling
    each derivative matrix."""
    V = _as_colmat(V)
    k = V.shape[1]
    if a is None:
        a = torch.ones(k, dtype=torch.float64)
    z = None
    for j in range(k):
        Mj = _dense(compute_Mder(nep, lam, j + startder))
        col = V[:, j] * a[j]
        dt = torch.promote_types(Mj.dtype, col.dtype)
        term = Mj.to(dt) @ col.to(dt)
        z = term if z is None else z + term
    return z


def mlincomb_from_mm(nep: NEP, lam, V, a=None, startder: int = 0):
    """Mlincomb via ONE compute_MM call on a scaled bidiagonal matrix: ``S``
    carries ``lam`` on the diagonal and ``j * a_j/a_{j-1}`` below it, so
    ``f(S)[:, 0] = [a_j f^{(j)}(lam)/a_0]`` for each term function; zeros in
    ``a`` zero the matching columns of V."""
    V = _as_colmat(V)
    k = V.shape[1]
    if a is None:
        a = torch.ones(k, dtype=torch.float64)
    a = torch.as_tensor(a)
    dt = torch.promote_types(torch.promote_types(V.dtype, a.dtype),
                             torch.complex128)
    a = a.to(dt)
    nonzero = a != 0
    a_eff = torch.where(nonzero, a, torch.ones_like(a))
    Vz = torch.where(nonzero.to(V.device)[None, :], V.to(dt),
                     torch.zeros((), dtype=dt, device=V.device))
    m = k + startder
    a_ext = torch.cat([torch.ones(startder, dtype=dt), a_eff])
    S = complex(lam) * torch.eye(m, dtype=dt)
    if m > 1:
        S = S + torch.diag(matfun.ramp(m, dt) * a_ext[1:] / a_ext[:-1], -1)
    if startder > 0:
        Vz = torch.cat([torch.zeros((V.shape[0], startder), dtype=dt,
                                    device=V.device), Vz], dim=1)
    Z = compute_MM(nep, S, Vz)
    return a_ext[0].to(Z.device) * Z[:, 0]


def mder_from_mm(nep: NEP, lam, der: int = 0):
    """``M^(der)(lam)`` via compute_MM with a Jordan-block Kronecker
    structure: with ``S = kron(J, I_n)`` and ``V = kron(e_der^T, I_n)`` the
    first block column of ``compute_MM(S, V)`` is ``M^(der)(lam)``."""
    n = nep.n
    J = matfun.jordan_matrix(lam, der + 1)
    S = torch.kron(J, torch.eye(n, dtype=J.dtype))
    row = torch.zeros((1, der + 1), dtype=J.dtype)
    row[0, der] = 1.0
    V = torch.kron(row, torch.eye(n, dtype=J.dtype))
    return compute_MM(nep, S, V)[:, :n]
