"""Rayleigh-functional solves ``y^H M(lam) x = 0``.

* scalar Newton iteration (the default)
* PEP closed form via the roots of the scalar polynomial
* any InnerSolver on the 1 x 1 projected problem (``inner_solve_rf``)
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import to_torch_dtype
from ..core.exceptions import NoConvergenceException
from ..core.nep import compute_Mlincomb
from ..models.pep import PEP

__all__ = ["compute_rf", "ScalarNewtonRF", "PolyRF"]


class ScalarNewtonRF:
    def __init__(self, tol=None, maxit: int = 80, bad_solution_allowed=True):
        self.tol = tol if tol is not None else 100 * np.finfo(float).eps
        self.maxit = maxit
        self.bad_solution_allowed = bad_solution_allowed


class PolyRF:
    pass


def _is_real(dtype):
    return not to_torch_dtype(dtype).is_complex


def _rf_scalar_newton(nep, x, solver, y, lam0, dtype):
    lam = complex(lam0)
    dlam = np.inf
    count = 0
    one = np.ones(1)
    # np.abs on complex128 returns inf on hypot overflow where Python's
    # abs() raises OverflowError (seen when y^H M'(lam) x degenerates and a
    # step explodes through exp-dominated terms, e.g. resinv on DEPs)
    while np.abs(np.complex128(dlam)) > solver.tol and count < solver.maxit:
        count += 1
        z1 = compute_Mlincomb(nep, lam, x[:, None], one)
        z2 = compute_Mlincomb(nep, lam, x[:, None], one, startder=1)
        with np.errstate(all="ignore"):
            dlam = complex(-np.complex128(complex(torch.vdot(y.to(z1.dtype),
                                                             z1)))
                           / np.complex128(complex(torch.vdot(
                               y.to(z2.dtype), z2))))
        if not (np.isfinite(dlam.real) and np.isfinite(dlam.imag)):
            count = solver.maxit  # divergence: report non-convergence
            break
        lam = lam + dlam
    if count == solver.maxit and not solver.bad_solution_allowed:
        raise NoConvergenceException(
            msg="compute_rf (scalar Newton) did not converge")
    if _is_real(dtype) and abs(lam.imag) <= solver.tol * max(1.0,
                                                             abs(lam.real)):
        return np.array([lam.real])
    return np.array([lam])


def _rf_poly(nep: PEP, x, y, target):
    """All roots of ``p(lam) = sum_d (y^H A_d x) lam^d``, sorted by distance
    to ``target``."""
    coeffs = []
    for A in nep.get_Av():
        if isinstance(A, torch.Tensor):  # dense term: one dtype for both
            A = A.to(torch.promote_types(A.dtype, x.dtype))
        Ax = A @ x.to(torch.promote_types(A.dtype, x.dtype))
        coeffs.append(complex(torch.vdot(y.to(Ax.dtype), Ax)))
    # np.roots wants the highest degree first
    r = np.roots(np.array(coeffs)[::-1])
    if r.size == 0:
        return np.array([complex(target)])
    return r[np.argsort(np.abs(r - complex(target)))]


def compute_rf(dtype, nep, x, inner_solver=None, y=None, target=0.0,
               lam=None):
    """Returns a vector (numpy) of Rayleigh-functional solutions sorted by
    relevance; callers pick with ``closest_to``.  ``x``, ``y``: tensors on
    the problem's device."""
    if y is None:
        y = x
    if lam is None:
        lam = target
    if inner_solver is None:
        inner_solver = PolyRF() if isinstance(nep, PEP) else ScalarNewtonRF()
    if isinstance(inner_solver, PolyRF) and isinstance(nep, PEP):
        vals = _rf_poly(nep, x, y, target)
        if _is_real(dtype):
            # prefer (nearly) real roots when a real type is requested
            realish = vals[np.abs(vals.imag)
                           < 1e-10 * np.maximum(1.0, np.abs(vals.real))]
            if realish.size:
                return realish.real
        return vals
    if isinstance(inner_solver, ScalarNewtonRF):
        return _rf_scalar_newton(nep, x, inner_solver, y, lam, dtype)
    # an InnerSolver object: solve the 1 x 1 projected NEP
    from .inner import inner_solve_rf

    return inner_solve_rf(dtype, nep, x, inner_solver, y=y, target=target,
                          lam=lam)
