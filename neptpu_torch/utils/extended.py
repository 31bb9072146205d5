"""Extended-precision path via mpmath.

PyTorch has no arbitrary-precision dtype, so small dense NEPs are mirrored
into mpmath matrices at a chosen binary precision on the host and the
Newton-family iteration runs entirely in that precision.  This is off the
hot path by construction: its role is *oracle generation* — eigenvalues to
far beyond float64, against which the device paths are validated.

API:
    MPNEP(As, fv)              SPMF in mpmath arithmetic
    mp_from_nep(nep, prec)     mirror a PEP/DEP/SPMF-like NEP
    newton_mp / augnewton_mp   bordered Newton at precision `prec`
    resnorm_mp                 ||M(lam) v|| in mp arithmetic
"""
from __future__ import annotations

import numpy as np

__all__ = ["MPNEP", "mp_from_nep", "newton_mp", "augnewton_mp", "resnorm_mp"]


def _mp():
    import mpmath

    return mpmath


def _host(A):
    """A tensor (on any device), a term that densifies, or an array as a
    numpy array."""
    import torch

    if hasattr(A, "to_dense") and not isinstance(A, torch.Tensor):
        A = A.to_dense()
    if isinstance(A, torch.Tensor):
        return A.detach().cpu().numpy()
    if hasattr(A, "toarray"):
        return A.toarray()
    return np.asarray(A)


def _to_mpmatrix(A):
    mp = _mp()
    A = _host(A)
    M = mp.matrix(A.shape[0], A.shape[1])
    for i in range(A.shape[0]):
        for j in range(A.shape[1]):
            v = complex(A[i, j])
            M[i, j] = mp.mpc(v) if v.imag != 0 else mp.mpf(v.real)
    return M


class MPNEP:
    """SPMF ``M(lam) = sum_i A_i f_i(lam)`` in mpmath arithmetic.

    ``As``: list of numpy arrays (converted to exact mp matrices);
    ``fv``: list of callables on mpmath scalars (analytic; derivatives are
    taken with ``mpmath.diff``).
    """

    def __init__(self, As, fv):
        if len(As) != len(fv):
            raise ValueError("one function per matrix required")
        self.As = [_to_mpmatrix(A) for A in As]
        self.fv = list(fv)
        self.n = self.As[0].rows

    def mder(self, lam, der: int = 0):
        mp = _mp()
        M = mp.matrix(self.n, self.n)
        for A, f in zip(self.As, self.fv):
            w = f(lam) if der == 0 else mp.diff(f, lam, der)
            M += w * A
        return M

    def mlincomb(self, lam, vecs):
        """sum_j M^(j)(lam) vecs[j] (vecs: list of mp column matrices)."""
        mp = _mp()
        y = mp.matrix(self.n, 1)
        for j, v in enumerate(vecs):
            y += self.mder(lam, j) * v
        return y


def mp_from_nep(nep, prec: int = 256):
    """Mirror a PEP/DEP/SPMF of this package into an :class:`MPNEP` at
    ``prec`` bits.

    The coefficient matrices are read off ``get_Av`` (densified); the scalar
    functions become their exact mp counterparts (monomials for PEP, ``-lam``
    and ``exp(-tau*lam)`` for DEP, user functions assumed mp-safe for SPMF).
    """
    mp = _mp()
    mp.mp.prec = prec
    from ..models.dep import DEP
    from ..models.pep import PEP

    def dense_terms(x):
        return [_host(A) for A in x]

    if isinstance(nep, PEP):
        As = dense_terms(nep.get_Av())

        def mono(d):
            return lambda lam: lam ** d

        return MPNEP(As, [mono(d) for d in range(len(As))])
    if isinstance(nep, DEP):
        As = dense_terms(nep.get_Av())  # [-I term (identity), A_1, ...]
        taus = [float(t) for t in np.asarray(nep.tauv)]
        fv = [lambda lam: -lam]
        for t in taus:
            fv.append(lambda lam, t=t: mp.exp(-t * lam))
        return MPNEP(As, fv)
    # generic SPMF: trust the user's functions to be mp-evaluable
    if hasattr(nep, "get_Av") and hasattr(nep, "get_fv"):
        return MPNEP(dense_terms(nep.get_Av()), nep.get_fv())
    raise TypeError(f"cannot mirror {type(nep).__name__} into mpmath")


def resnorm_mp(mpnep: MPNEP, lam, v):
    mp = _mp()
    return mp.norm(mpnep.mder(lam, 0) * v) / mp.norm(v)


def newton_mp(mpnep: MPNEP, lam0=0.0, v0=None, tol=None, maxit=50, prec=None):
    """Bordered Newton-Raphson on ``[M(lam) v; c^H v - 1] = 0`` in mpmath
    arithmetic.

    Returns ``(lam, v)`` as mpmath scalar / column matrix.  ``tol`` defaults
    to ``100 * eps(prec)``.
    """
    mp = _mp()
    if prec is not None:
        mp.mp.prec = prec
    n = mpnep.n
    eps = mp.mpf(2) ** (1 - mp.mp.prec)
    if tol is None:
        tol = 100 * eps
    lam = mp.mpmathify(lam0)
    if v0 is None:
        v = mp.matrix([mp.mpf(1)] * n)
    else:
        v = mp.matrix([mp.mpmathify(complex(x)) for x in _host(v0).ravel()])
    c = +v  # normalization vector: the default c = v0
    cs = mp.fsum(mp.conj(c[i]) * c[i] for i in range(n))
    v = v / mp.sqrt(cs)
    c = +v

    for _ in range(maxit):
        M = mpnep.mder(lam, 0)
        r = M * v
        if mp.norm(r) / mp.norm(v) < tol:
            return lam, v
        Md = mpnep.mder(lam, 1)
        # bordered Jacobian [[M, Md v], [c^H, 0]]
        J = mp.matrix(n + 1, n + 1)
        for i in range(n):
            for j in range(n):
                J[i, j] = M[i, j]
        mdv = Md * v
        for i in range(n):
            J[i, n] = mdv[i]
            J[n, i] = mp.conj(c[i])
        rhs = mp.matrix(n + 1, 1)
        for i in range(n):
            rhs[i] = -r[i]
        chv = mp.fsum(mp.conj(c[i]) * v[i] for i in range(n))
        rhs[n] = 1 - chv
        try:
            d = mp.lu_solve(J, rhs)
        except ZeroDivisionError:
            break
        for i in range(n):
            v[i] += d[i]
        lam += d[n]

    from ..core.exceptions import NoConvergenceException

    raise NoConvergenceException(
        lam=complex(lam), v=np.array([complex(x) for x in v]),
        msg="newton_mp did not converge",
    )


def augnewton_mp(*args, **kwargs):
    """``augnewton`` is the same Newton sequence realized with n-vector
    operations; in the mp backend both share the bordered-solve
    implementation."""
    return newton_mp(*args, **kwargs)
