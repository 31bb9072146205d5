"""Linear-solver layer: solvers bound to one ``(nep, lam)`` and the creator
objects that decide when factorizations happen.

* moderate n (the gallery: n <= ~1e4): a dense LU of ``compute_Mder(nep,
  lam)`` in device memory, factored once and reused over the solver's
  iterations; ``batched_lu_factor``/``batched_lu_solve`` do the same over a
  leading shift axis (one stacked LU per node set).
* matrix-free: GMRES over ``compute_Mlincomb`` matvecs (JAX's incremental
  GMRES); :func:`gmres_restarted` is scipy's restarted GMRES, which the
  waveguide's Schur-complement solver runs as the JAX package does.
* ``SparseFactorizeLinSolver``: scipy ``splu`` of the sparse M(lam) on the
  host, for float64 reference runs.

Creators keep the recycling-dict semantics: a factorization is cached keyed
by its shift, up to ``max_factorizations``.  A solver lives on the device of
the problem it was created for.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.nep import compute_Mder, compute_Mlincomb

__all__ = [
    "LinSolver",
    "lin_solve",
    "FactorizeLinSolver",
    "SparseFactorizeLinSolver",
    "SparseFactorizeLinSolverCreator",
    "BackslashLinSolver",
    "GMRESLinSolver",
    "FactorizeLinSolverCreator",
    "BackslashLinSolverCreator",
    "GMRESLinSolverCreator",
    "DeflatedNEPLinSolver",
    "DeflatedNEPLinSolverCreator",
    "LinSolverCreator",
    "DefaultLinSolverCreator",
    "create_linsolver",
    "gmres",
    "gmres_restarted",
    "batched_lu_factor",
    "batched_lu_solve",
]


def _dense_mder(nep, lam):
    M = compute_Mder(nep, lam)
    return M if isinstance(M, torch.Tensor) else M.to_dense()


def _lu_solve(lu, piv, b):
    """``lu_solve`` for a vector or matrix right-hand side."""
    if b.ndim == 1:
        return torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]
    return torch.linalg.lu_solve(lu, piv, b)


def batched_lu_factor(A):
    """LU of a stack ``A (s, n, n)``: returns ``(lu, piv)`` with the leading
    shift axis kept.  The matrices are factored one at a time into the
    stacked result: handed a whole stack on the card, PyTorch takes MAGMA's
    batched getrf, which is built for small matrices and took twice
    cuSOLVER's time per matrix at n = 9956 (PERF.md, the rational
    family)."""
    lu = torch.empty_like(A)
    piv = torch.empty(A.shape[:-1], dtype=torch.int32, device=A.device)
    for i in range(A.shape[0]):
        lu[i], piv[i] = torch.linalg.lu_factor(A[i])
    return lu, piv


def batched_lu_solve(lu_piv, b):
    """Solve with a stacked LU: ``b (s, n)`` or ``(s, n, k)``."""
    lu, piv = lu_piv
    if b.ndim == lu.ndim - 1:
        return torch.linalg.lu_solve(lu, piv, b[..., None])[..., 0]
    return torch.linalg.lu_solve(lu, piv, b)


class LinSolver:
    """A solver bound to one (nep, lam); ``solve`` accepts vector or matrix
    right-hand sides (contour methods need block right-hand sides)."""

    def solve(self, b, tol=None):
        raise NotImplementedError


def lin_solve(solver: LinSolver, b, tol=None):
    return solver.solve(b, tol=tol)


class FactorizeLinSolver(LinSolver):
    """LU once, triangular solves per call."""

    def __init__(self, nep, lam, umfpack_refinements: int = 2):
        A = _dense_mder(nep, lam)
        self.dtype = A.dtype
        self.device = A.device
        # an exactly singular M(lam) (a small projected problem at its
        # eigenvalue) gives inf/nan solutions, as LAPACK's getrf does, for
        # the error measure to judge: no exception
        self.lu, self.piv, _ = torch.linalg.lu_factor_ex(A)

    def solve(self, b, tol=None):
        b = torch.as_tensor(b, device=self.device)
        if b.dtype.is_complex and not self.dtype.is_complex:
            # real factorization, complex right-hand side: solve the parts
            # (exact; avoids a lossy complex -> real cast)
            return torch.complex(
                _lu_solve(self.lu, self.piv, b.real.to(self.dtype)),
                _lu_solve(self.lu, self.piv, b.imag.to(self.dtype)))
        return _lu_solve(self.lu, self.piv, b.to(self.dtype))


class SparseFactorizeLinSolver(LinSolver):
    """scipy ``splu`` of the sparse M(lam) on the host, in complex128, for
    float64 reference runs.  ``solve`` takes and returns numpy arrays or
    tensors (a tensor comes back on its own device)."""

    def __init__(self, nep, lam):
        import scipy.sparse.linalg as spla

        from ..solvers.spmf_real import collect_spmf_terms, spmf_fun_scalars

        mats, fv = collect_spmf_terms(nep)
        w = spmf_fun_scalars(fv, complex(lam))
        M = None
        for wi, A in zip(w, mats):
            T = A.astype(complex) * wi
            M = T if M is None else M + T
        self.lu = spla.splu(M.tocsc())

    def solve(self, b, tol=None):
        if isinstance(b, torch.Tensor):
            x = self.lu.solve(b.detach().cpu().numpy().astype(complex))
            return torch.as_tensor(x, device=b.device)
        return self.lu.solve(np.asarray(b, dtype=complex))


class BackslashLinSolver(LinSolver):
    """Re-solve ``A \\ b`` each call, no cached factorization."""

    def __init__(self, nep, lam):
        self.A = _dense_mder(nep, lam)

    def solve(self, b, tol=None):
        b = torch.as_tensor(b, device=self.A.device)
        dt = torch.promote_types(self.A.dtype, b.dtype)
        return torch.linalg.solve(self.A.to(dt), b.to(dt))


def _safe_normalize(x, thresh=None):
    """``(x / ||x||, ||x||)``, or ``(0, 0)`` where ``||x|| <= thresh``
    (default: the dtype's eps)."""
    norm = float(torch.linalg.vector_norm(x))
    if thresh is None:
        thresh = float(torch.finfo(x.dtype).eps)
    if norm > thresh:
        return x / norm, norm
    return torch.zeros_like(x), 0.0


def _givens(a, b):
    """``(cs, sn)`` of the rotation that zeroes ``b`` under ``a``."""
    if abs(b) == 0:
        return 1.0, 0.0
    if abs(a) < abs(b):
        t = -a / b
        r = 1.0 / np.sqrt(1.0 + abs(t) ** 2)
        return r * t, r
    t = -b / a
    r = 1.0 / np.sqrt(1.0 + abs(t) ** 2)
    return r, r * t


def _rotate(h, i, cs, sn):
    x1, y1 = h[i], h[i + 1]
    h[i] = np.conj(cs) * x1 - np.conj(sn) * y1
    h[i + 1] = sn * x1 + cs * y1


def gmres(matvec, b, x0=None, tol=1e-12, restart=50, maxiter=200, M=None):
    """Matrix-free restarted GMRES on the device of ``b``, the algorithm of
    ``jax.scipy.sparse.linalg.gmres(solve_method="incremental")`` step for
    step: one classical Gram-Schmidt pass per Arnoldi step, the small
    least-squares problem kept in QR form by Givens rotations.

    ``M``: optional preconditioner ``v -> M v`` (left preconditioning).
    The stop rules are JAX's: the restarts end once ``||M (b - A x)|| <=
    tol ||b||`` (or after ``maxiter`` restarts), a restart ends once its
    rotated residual is ``<= tol ||M b||`` - so with a preconditioner far
    from the identity the iterate meets its tolerance in the preconditioned
    norm, not in ``||b - A x||``."""
    pre = (lambda v: v) if M is None else M
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    n = b.shape[0]
    restart = min(int(restart), n)
    bnorm = float(torch.linalg.vector_norm(b))
    atol = tol * bnorm
    ptol = float(torch.linalg.vector_norm(pre(b))) * min(
        1.0, atol / bnorm if bnorm > 0 else np.inf)
    eps = float(torch.finfo(b.dtype).eps)
    hdt = np.complex128 if b.dtype.is_complex else np.float64
    unit, rnorm = _safe_normalize(pre(b - matvec(x)))
    for _ in range(int(maxiter)):
        if not rnorm > atol:
            break
        V = torch.zeros((n, restart + 1), dtype=b.dtype, device=b.device)
        V[:, 0] = unit
        R = np.eye(restart, restart + 1, dtype=hdt)
        givens = np.zeros((restart, 2), dtype=hdt)
        beta = np.zeros(restart + 1, dtype=hdt)
        beta[0] = rnorm
        k, err = 0, rnorm
        while k < restart and err > ptol:
            v = pre(matvec(V[:, k]))
            _, v0 = _safe_normalize(v)
            h = V.conj().T @ v
            v = v - V @ h
            v, v1 = _safe_normalize(v, thresh=eps * v0)
            V[:, k + 1] = v
            row = h.cpu().numpy().astype(hdt)
            row[k + 1] = v1
            for i in range(k):
                _rotate(row, i, *givens[i])
            givens[k] = _givens(row[k], row[k + 1])
            _rotate(row, k, *givens[k])
            R[k] = row
            _rotate(beta, k, *givens[k])
            err = abs(beta[k + 1])
            k += 1
        # the whole restart-size triangle, as JAX solves it: rows past k are
        # identity rows, so y[k] picks up the last rotated residual
        y = _solve_upper(R[:, :-1].T, beta[:-1])
        x = x + V[:, :-1] @ torch.as_tensor(y, dtype=b.dtype, device=b.device)
        unit, rnorm = _safe_normalize(pre(b - matvec(x)))
    return x


def gmres_restarted(matvec, b, rtol=1e-5, atol=0.0, restart=None,
                    maxiter=None, psolve=None):
    """Restarted GMRES with left preconditioning on the device of ``b``,
    the algorithm and stop rule of ``scipy.sparse.linalg.gmres(A, b,
    rtol=rtol, atol=atol, restart=restart, maxiter=maxiter, M=M)``: one
    modified Gram-Schmidt pass per Arnoldi step (on the device), LAPACK
    ``lartg`` Givens rotations on the small Hessenberg matrix (on the host),
    the inner tolerance of scipy's gh-8400 control.  ``maxiter`` counts
    restarts (default ``10 n``), ``restart`` the Arnoldi steps between them
    (default 20).  Returns ``(x, info, iterations)``: ``info`` 0 when
    ``||b - A x|| <= max(atol, rtol ||b||)``, else ``maxiter``; ``iterations``
    the Arnoldi steps taken."""
    psolve = (lambda v: v) if psolve is None else psolve
    n = b.shape[0]
    x = torch.zeros_like(b)
    bnrm2 = float(torch.linalg.vector_norm(b))
    atol = max(float(atol), float(rtol) * bnrm2)
    if bnrm2 == 0:
        return b, 0, 0
    eps = float(torch.finfo(torch.float64).eps)
    if maxiter is None:
        maxiter = n * 10
    restart = min(20 if restart is None else int(restart), n)
    from scipy.linalg import get_lapack_funcs

    lartg = get_lapack_funcs("lartg", dtype=np.complex128)
    Mb_nrm2 = float(torch.linalg.vector_norm(psolve(b)))
    ptol_max_factor = 1.0
    ptol = Mb_nrm2 * min(ptol_max_factor, atol / bnrm2)
    presid = 0.0
    v = torch.empty((restart + 1, n), dtype=b.dtype, device=b.device)
    h = np.zeros((restart, restart + 1), dtype=complex)
    givens = np.zeros((restart, 2), dtype=complex)
    inner_iter = 0
    rnorm = np.inf
    r = b.clone()
    if float(torch.linalg.vector_norm(r)) < atol:
        return x, 0, 0
    for _ in range(int(maxiter)):
        v[0] = psolve(r)
        tmp = float(torch.linalg.vector_norm(v[0]))
        v[0] *= 1 / tmp
        S = np.zeros(restart + 1, dtype=complex)
        S[0] = tmp
        breakdown = False
        for col in range(restart):
            w = psolve(matvec(v[col]))
            h0 = torch.linalg.vector_norm(w)
            hk = []
            for k in range(col + 1):  # modified Gram-Schmidt
                t = torch.vdot(v[k], w)
                hk.append(t)
                w = w - t * v[k]
            h1 = torch.linalg.vector_norm(w)
            host = torch.stack(hk + [h0.to(b.dtype), h1.to(b.dtype)]).cpu()
            host = host.numpy()
            h[col, : col + 1] = host[: col + 1]
            h0, h1 = float(host[col + 1].real), float(host[col + 2].real)
            h[col, col + 1] = h1
            v[col + 1] = w
            if h1 <= eps * h0:
                h[col, col + 1] = 0
                breakdown = True
            else:
                v[col + 1] *= 1 / h1
            for k in range(col):
                c, s = givens[k, 0], givens[k, 1]
                n0, n1 = h[col, [k, k + 1]]
                h[col, [k, k + 1]] = [c * n0 + s * n1,
                                      -s.conj() * n0 + c * n1]
            c, s, mag = lartg(h[col, col], h[col, col + 1])
            givens[col, :] = [c, s]
            h[col, [col, col + 1]] = mag, 0
            tmp = -np.conjugate(s) * S[col]
            S[[col, col + 1]] = [c * S[col], tmp]
            presid = np.abs(tmp)
            inner_iter += 1
            if presid <= ptol or breakdown:
                break
        if h[col, col] == 0:
            S[col] = 0
        y = np.zeros([col + 1], dtype=complex)
        y[:] = S[: col + 1]
        for k in range(col, 0, -1):
            if y[k] != 0:
                y[k] /= h[k, k]
                tmp = y[k]
                y[:k] -= tmp * h[k, :k]
        if y[0] != 0:
            y[0] /= h[0, 0]
        x = x + torch.as_tensor(y, device=b.device) @ v[: col + 1]
        r = b - matvec(x)
        rnorm = float(torch.linalg.vector_norm(r))
        if rnorm <= atol or breakdown:
            break
        if presid <= ptol:
            ptol_max_factor = max(eps, 0.25 * ptol_max_factor)
        else:
            ptol_max_factor = min(1.0, 1.5 * ptol_max_factor)
        ptol = presid * min(ptol_max_factor, atol / rnorm)
    info = 0 if rnorm <= atol else int(maxiter)
    return x, info, inner_iter


def _solve_upper(A, b):
    """Upper-triangular solve on the host."""
    import scipy.linalg as sla

    return sla.solve_triangular(A, b, lower=False)


class GMRESLinSolver(LinSolver):
    """Matrix-free: wraps ``v -> compute_Mlincomb(nep, lam, v)``."""

    def __init__(self, nep, lam, tol=1e-12, restart=50, maxiter=200,
                 preconditioner: Optional[Callable] = None):
        self.nep = nep
        self.lam = lam
        self.tol = tol
        self.restart = restart
        self.maxiter = maxiter
        self.preconditioner = preconditioner
        is_complex = (lam.is_complex() if isinstance(lam, torch.Tensor)
                      else np.iscomplexobj(lam))
        self.dtype = torch.complex128 if is_complex else torch.float64

    def _matvec(self, v):
        return compute_Mlincomb(self.nep, self.lam, v[:, None], np.ones(1))

    def solve(self, b, tol=None):
        b = torch.as_tensor(b)
        if b.ndim == 2:
            cols = [self.solve(b[:, j], tol=tol) for j in range(b.shape[1])]
            return torch.stack(cols, dim=1)
        t = self.tol if tol is None else tol
        # promote rather than truncate: a complex right-hand side on a
        # real-dtype solver must not be cast to real
        dt = torch.promote_types(self.dtype, b.dtype)
        return gmres(self._matvec, b.to(dt), tol=t, restart=self.restart,
                     maxiter=self.maxiter, M=self.preconditioner)


class DeflatedNEPLinSolver(LinSolver):
    """Schur-complement solve of the bordered deflated system
    ``[M U; X^H 0]`` over the original problem's solver (minimality index
    1): ``X = V0``, ``U = U(lam)`` of the deflated problem.

    The first solve sends its right-hand side and the p columns of ``U`` to
    the original solver as one block of p+1 columns; ``Z = M^{-1} U`` and the
    p x p Schur complement ``-X^H Z`` do not depend on the right-hand side and
    are kept, so a later solve is one original solve."""

    def __init__(self, deflated_nep, lam, orglinsolver):
        self.deflated_nep = deflated_nep
        self.lam = lam
        self.orglinsolver = orglinsolver
        self._Z = self._S = None

    def solve(self, b, tol=None):
        from ..models.deflation import deflated_nep_compute_Q

        dnep = self.deflated_nep
        n = dnep.n0
        X = dnep.V0_t
        b = torch.as_tensor(b, device=X.device)
        b = b.to(torch.promote_types(b.dtype, X.dtype))
        b1, b2 = b[:n], b[n:]
        if self._Z is None:
            U = deflated_nep_compute_Q(dnep, self.lam, 0)
            sol = lin_solve(self.orglinsolver,
                            torch.cat([b1[:, None], U], dim=1), tol=tol)
            b1t, self._Z = sol[:, 0], sol[:, 1:]
            self._S = -(X.conj().T @ self._Z)
        else:
            b1t = lin_solve(self.orglinsolver, b1, tol=tol)
        v2 = torch.linalg.solve(self._S, b2 - X.conj().T @ b1t)
        return torch.cat([b1t - self._Z @ v2, v2])


# ---------------------------------------------------------------------------
# Creators: strategy objects deciding when factorizations happen.
# ---------------------------------------------------------------------------


class LinSolverCreator:
    def create(self, nep, lam):
        raise NotImplementedError


class DeflatedNEPLinSolverCreator(LinSolverCreator):
    """Wraps the original problem's creator for the bordered solve of a
    deflated problem."""

    def __init__(self, orglinsolvercreator=None):
        self.orglinsolvercreator = orglinsolvercreator

    def create(self, nep, lam):
        org = create_linsolver(self.orglinsolvercreator, nep.orgnep, lam)
        return DeflatedNEPLinSolver(nep, lam, org)


class _RecyclingCreator(LinSolverCreator):
    """Cache up to ``max_factorizations`` solvers keyed by shift (negative:
    no limit; 0: cache nothing beyond what was precomputed)."""

    def __init__(self, max_factorizations: int = 0, cache=None):
        self.max_factorizations = max_factorizations
        self.cache = dict(cache or {})

    def _make(self, nep, lam):
        raise NotImplementedError

    def create(self, nep, lam):
        key = complex(lam)
        if key in self.cache:
            return self.cache[key]
        solver = self._make(nep, lam)
        if self.max_factorizations != 0 and (
                self.max_factorizations < 0
                or len(self.cache) < self.max_factorizations):
            self.cache[key] = solver
        return solver


class FactorizeLinSolverCreator(_RecyclingCreator):
    """Optionally precompute factorizations at given shifts and recycle up to
    ``max_factorizations``."""

    def __init__(self, umfpack_refinements: int = 2,
                 recycled_factorizations=None, max_factorizations: int = 0,
                 nep=None, precomp_values=()):
        super().__init__(max_factorizations, recycled_factorizations)
        self.umfpack_refinements = umfpack_refinements
        for lam in precomp_values:
            if nep is None:
                raise ValueError("precomp_values requires nep")
            self.cache[complex(lam)] = self._make(nep, lam)

    def _make(self, nep, lam):
        return FactorizeLinSolver(nep, lam, self.umfpack_refinements)


class SparseFactorizeLinSolverCreator(_RecyclingCreator):
    """Creator for :class:`SparseFactorizeLinSolver` with the same recycling
    dict semantics as :class:`FactorizeLinSolverCreator`."""

    def _make(self, nep, lam):
        return SparseFactorizeLinSolver(nep, lam)


class BackslashLinSolverCreator(LinSolverCreator):
    def create(self, nep, lam):
        return BackslashLinSolver(nep, lam)


class GMRESLinSolverCreator(LinSolverCreator):
    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def create(self, nep, lam):
        return GMRESLinSolver(nep, lam, **self.kwargs)


DefaultLinSolverCreator = FactorizeLinSolverCreator


def create_linsolver(creator, nep, lam):
    """A solver for ``(nep, lam)`` from a creator object, a creator class
    (instantiated with its defaults) or ``None`` (the default creator)."""
    if creator is None:
        creator = FactorizeLinSolverCreator()
    if isinstance(creator, type):
        creator = creator()
    return creator.create(nep, lam)
