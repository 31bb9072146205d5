"""Waveguide eigenvalue problem (WEP) — FD discretization of the waveguide
Helmholtz equation with DtN boundary conditions (Jarlebring/Mele/Runborg
SISC 2017, Ringh/Mele/Karlsson/Jarlebring LAA 2018).  Two formats:

* ``neptype="SPMF"``: 3 + 2 nz terms — the Q0/Q1/Q2 polynomial part plus
  rank-one boundary terms with the branch-cut functions
  ``s_j(lam) = i sqrt(lam^2 + b_j lam + c_j) + d0``.  Assembly runs on the
  host in numpy/scipy; the term bank goes to ``device`` once.  The
  branch-cut functions are host functions: they take and return complex128
  CPU tensors and carry exact derivative tables (the Gegenbauer recurrence of
  :func:`sqrt_derivative`).
* ``neptype="WEP"``: the native :class:`WEP_FD`, its own linear algebra on
  ``device``: a Sylvester-form ``Mlincomb`` (``A(lam) X + X B + K .* X``,
  dense (nz x nz)(nz x nx) products) with the FFT boundary transforms
  ``R``/``Rinv`` and the Gegenbauer recurrence run over all 2 nz boundary
  rows at once; the Schur complement of the interior, assembled dense and
  factored by one LU on the device (there is no sparse LU on the card), or
  applied matrix-free under GMRES with the Ringh et al. preconditioner: an
  FFT-diagonalized Sylvester solve corrected by a Sherman-Morrison-Woodbury
  system over N z-domains, whose N^2 + 4N Sylvester solves run as one
  batched FFT pass.

Layout: an interior vector ``v (nx nz)`` is the column-major (Fortran)
flattening of ``X (nz, nx)``, so ``X = v.reshape(nx, nz).T`` and
``v = X.T.reshape(-1)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...config import resolve_device
from ...core.nep import NEP
from ...ops import matfun
from ...ops.linsolve import (LinSolver, LinSolverCreator, _lu_solve,
                              gmres_restarted)
from ..spmf import SPMF_NEP

__all__ = [
    "wep_gallery",
    "wep_generate_preconditioner",
    "WEPPreconditioner",
    "SchurMatVec",
    "construct_WEP_schur_complement",
    "solve_wg_sylvester_fft",
    "generate_smw_matrix",
    "solve_smw",
    "WEP",
    "WEP_FD",
    "WEPFactorizedLinSolver",
    "WEPBackslashLinSolver",
    "WEPGMRESLinSolver",
    "WEPLinSolverCreator",
    "assemble_waveguide_spmf_fd",
    "generate_fd_interior_mat",
    "generate_fd_boundary_mat",
    "sqrt_derivative",
    "sqrt_pos_imag",
    "sqrt_schur_pos_imag",
]


# -- FD discretization ------------------------------------------------------


def generate_fd_interior_mat(nx, nz, hx, hz):
    import scipy.sparse as sp

    Dxx = sp.diags([np.ones(nx - 1), -2 * np.ones(nx), np.ones(nx - 1)],
                   [-1, 0, 1]).tolil()
    Dzz = sp.diags([np.ones(nz - 1), -2 * np.ones(nz), np.ones(nz - 1)],
                   [-1, 0, 1]).tolil()
    Dzz[0, -1] = 1
    Dzz[-1, 0] = 1
    Dxx = (Dxx / hx**2).tocsr()
    Dzz = (Dzz / hz**2).tocsr()
    Dz = sp.diags([-np.ones(nz - 1), np.ones(nz - 1)], [-1, 1]).tolil()
    Dz[0, -1] = -1
    Dz[-1, 0] = 1
    Dz = (Dz / (2 * hz)).tocsr()
    return Dxx, Dzz, Dz


def generate_fd_boundary_mat(nx, nz, hx, hz):
    import scipy.sparse as sp

    e1 = sp.lil_matrix((nx, 1))
    e1[0, 0] = 1
    en = sp.lil_matrix((nx, 1))
    en[-1, 0] = 1
    Iz = sp.eye(nz)
    C1 = sp.hstack([sp.kron(e1, Iz), sp.kron(en, Iz)]).tocsr() / hx**2
    d1 = 2 / hx
    d2 = -1 / (2 * hx)
    vm = sp.lil_matrix((1, nx))
    vm[0, 0] = d1
    vm[0, 1] = d2
    vp = sp.lil_matrix((1, nx))
    vp[0, -1] = d1
    vp[0, -2] = d2
    C2T = sp.vstack([sp.kron(vm, Iz), sp.kron(vp, Iz)]).tocsr()
    return C1, C2T


def _wavenumber(nx, nz, wg, delta):
    if wg == "TAUSCH":
        xm, xp = 0.0 - delta, (2 / np.pi) + 0.4 + delta
        k1, k2, k3 = np.sqrt(2.3) * np.pi, np.sqrt(3) * np.pi, np.pi

        def k(x, z):
            return (
                k1 * (x <= 0)
                + k2 * (x > 0) * (x <= 2 / np.pi)
                + k2 * (x > 2 / np.pi) * (x <= 2 / np.pi + 0.4) * (z > 0.5)
                + k3 * (x > 2 / np.pi) * (z <= 0.5) * (x <= 2 / np.pi + 0.4)
                + k3 * (x > 2 / np.pi + 0.4)
            )

    elif wg == "JARLEBRING":
        xm, xp = -1.0 - delta, 1.0 + delta
        k1 = np.sqrt(2.3) * np.pi
        k2 = 2 * np.sqrt(3) * np.pi
        k3 = 4 * np.sqrt(3) * np.pi
        k4 = np.pi

        def k(x, z):
            return (
                k1 * (x <= -1)
                + k4 * (x > 1)
                + k4 * (x > 0.5) * (x <= 1) * (z <= 0.4)
                + k3 * (x > 0.0) * (x <= 0.5)
                + k3 * (x > 0.5) * (x <= 1) * (z > 0.4)
                + k3 * (x > -1) * (x <= 0.0) * (z > 0.5) * (z - x / 2 <= 1)
                + k2 * (x > -1) * (x <= 0.0) * (z > 0.5) * (z - x / 2 > 1)
                + k3 * (x > -1) * (x <= 0.0) * (z <= 0.5) * (z + x / 2 > 0)
                + k2 * (x > -1) * (x <= 0.0) * (z <= 0.5) * (z + x / 2 <= 0)
            )

    else:
        raise ValueError(f"The given Waveguide '{wg}' is not supported in "
                         "'FD' discretization.")
    zm, zp = 0.0, 1.0
    X = np.linspace(xm, xp, nx + 2)
    hx = X[1] - X[0]
    X = X[1:-1]
    Z = np.linspace(zm, zp, nz + 1)
    hz = Z[1] - Z[0]
    Z = Z[1:]
    K = k(X[None, :], Z[:, None]) ** 2
    Km = float(k(np.array(-np.inf), np.array(0.5)))
    Kp = float(k(np.array(np.inf), np.array(0.5)))
    return K, hx, hz, Km, Kp


# -- branch-cut square roots ------------------------------------------------


def sqrt_pos_imag(a):
    """Scalar sqrt on the branch with positive imaginary part."""
    a = complex(a)
    s = np.sign(a.imag)
    return np.sqrt(a) if s == 0 else s * np.sqrt(a)


def sqrt_schur_pos_imag(A):
    """Matrix square root on the positive-imaginary-part branch via the Schur
    method (Higham Alg. 6.3), host numpy."""
    A = np.asarray(A)
    if A.ndim == 0 or A.size == 1:
        return np.asarray(sqrt_pos_imag(A.reshape(-1)[0])).reshape(A.shape)
    import scipy.linalg as sla

    T, Q = sla.schur(A.astype(complex), output="complex")
    n = A.shape[0]
    U = np.zeros((n, n), dtype=complex)
    for i in range(n):
        U[i, i] = sqrt_pos_imag(T[i, i])
    for j in range(1, n):
        for i in range(j - 1, -1, -1):
            temp = sum(U[i, k] * U[k, j] for k in range(i + 1, j))
            U[i, j] = (T[i, j] - temp) / (U[i, i] + U[j, j])
    return Q @ U @ Q.conj().T


def _sqrt_pos_imag_vec(a):
    """:func:`sqrt_pos_imag` elementwise over a numpy array."""
    s = np.sign(a.imag)
    r = np.sqrt(a)
    return np.where(s == 0, r, s * r)


def sqrt_derivative_rows(b, c, d, x, a=1.0):
    """:func:`sqrt_derivative` for every row of ``b``, ``c`` at once:
    ``(len(b), d + 1)`` derivatives of ``sqrt(a z^2 + b z + c)`` at
    ``z = x``, the Gegenbauer recurrence run over all rows together.  The
    scalar :func:`sqrt_derivative` runs the same recurrence on one row
    (the per-term form the coefficient table calls); the two must stay
    equal (``tests/test_torch_waveguide.py`` holds them so)."""
    if d < 0:
        raise ValueError(f"Cannot take negative derivative. d = {d}")
    aa = a
    b = np.asarray(b, dtype=complex)
    c = np.asarray(c, dtype=complex)
    bb = b + 2 * aa * x
    cc = c + aa * x**2 + b * x
    der = np.zeros((len(b), d + 1), dtype=complex)
    yi = _sqrt_pos_imag_vec(cc)
    der[:, 0] = yi
    if d == 0:
        return der
    yip1 = bb / (2 * _sqrt_pos_imag_vec(cc))
    fact = 1.0
    der[:, 1] = yip1 * fact
    for i in range(2, d + 1):
        m = i - 2
        yip2 = -(2 * aa * (m - 1) * yi + bb * (1 + 2 * m) * yip1) / (
            2 * cc * (2 + m))
        fact *= i
        yi = yip1
        yip1 = yip2
        der[:, i] = yip2 * fact
    return der


def sqrt_derivative(a, b, c, d=0, x=0.0):
    """All d derivatives of sqrt(a z^2 + b z + c) at z = x via the Gegenbauer
    recurrence (Jarlebring App. C), in scalar arithmetic: each boundary term
    of the SPMF form calls it for its derivative table, where a recurrence
    over length-1 arrays costs several times more
    (:func:`sqrt_derivative_rows` runs it over many rows at once)."""
    if d < 0:
        raise ValueError(f"Cannot take negative derivative. d = {d}")
    bb = b + 2 * a * x
    cc = c + a * x**2 + b * x
    der = np.zeros(d + 1, dtype=complex)
    yi = der[0] = sqrt_pos_imag(cc)
    if d == 0:
        return der
    yip1 = der[1] = bb / (2 * yi)
    fact = 1.0
    for i in range(2, d + 1):
        m = i - 2
        yi, yip1 = yip1, -(2 * a * (m - 1) * yi + bb * (1 + 2 * m) * yip1) / (
            2 * cc * (2 + m))
        fact *= i
        der[i] = yip1 * fact
    return der


# -- SPMF format ------------------------------------------------------------


def _R_vec(bb, x):
    return (bb * np.fft.fft(np.asarray(x).ravel()))[::-1]


def _as_c128(x):
    return torch.as_tensor(np.asarray(x, dtype=np.complex128))


def _monomial(d):
    """S -> S^d (d = 0, 1, 2; scalars included) with its derivative rule."""

    def f(S):
        if d == 0:
            return matfun.eye_like(S)
        if d == 1:
            return S
        return S @ S if S.ndim >= 2 else S**2

    def derivs(lam, k):
        out = np.zeros(k, dtype=complex)
        for j in range(min(k, d + 1)):
            out[j] = (math.factorial(d) / math.factorial(d - j)
                      * lam ** (d - j))
        return out

    return matfun.with_derivs(f, derivs)


def assemble_waveguide_spmf_fd(nx, nz, hx, Dxx, Dzz, Dz, C1, C2T, K, Km, Kp,
                               device=None):
    import scipy.sparse as sp

    device = resolve_device(device)
    Ix = sp.eye(nx, dtype=complex)
    Iz = sp.eye(nz, dtype=complex)
    Q0 = (sp.kron(Ix, Dzz) + sp.kron(Dxx, Iz)
          + sp.diags(K.ravel(order="F").astype(complex)))
    Q1 = sp.kron(Ix, 2 * Dz)
    Q2 = sp.kron(Ix, Iz)
    nzz = nx * nz
    Z_small = sp.csr_matrix((2 * nz, 2 * nz), dtype=complex)
    Zc = sp.csr_matrix((nzz, 2 * nz), dtype=complex)
    ZcT = sp.csr_matrix((2 * nz, nzz), dtype=complex)
    A = [
        sp.bmat([[Q0, C1], [C2T, Z_small]]).tocsr(),
        sp.bmat([[Q1, Zc], [ZcT, Z_small]]).tocsr(),
        sp.bmat([[Q2, Zc], [ZcT, Z_small]]).tocsr(),
    ]
    p = (nz - 1) / 2
    d0 = -3 / (2 * hx)
    bvec = 4 * np.pi * 1j * np.arange(-p, p + 1)
    cM = Km**2 - 4 * np.pi**2 * np.arange(-p, p + 1) ** 2
    cP = Kp**2 - 4 * np.pi**2 * np.arange(-p, p + 1) ** 2
    bb = np.exp(-2j * np.pi * (np.arange(1, nz + 1) - 1) * (-p) / nz)

    def make_s(j, c):
        bj = bvec[j]
        cj = c[j]

        def f(S):
            S = np.asarray(S)
            scalar = S.ndim == 0
            Smat = S.reshape(1, 1) if scalar else S
            I = np.eye(Smat.shape[0], dtype=complex)
            beta = Smat @ Smat + bj * Smat + cj * I
            out = 1j * sqrt_schur_pos_imag(beta) + d0 * I
            return _as_c128(out[0, 0] if scalar else out)

        def derivs(lam, k):
            # f = i sqrt(lam^2 + bj lam + cj) + d0: the Gegenbauer recurrence
            # gives all derivatives of the sqrt at lam
            der = 1j * sqrt_derivative(1.0, bj, cj, k - 1, lam)
            der[0] += d0
            return der

        return matfun.with_derivs(f, derivs)

    fv = [_monomial(0), _monomial(1), _monomial(2)]
    for side, c in ((0, cM), (1, cP)):
        for j in range(nz):
            e = np.zeros(nz)
            e[j] = 1.0
            Rj = _R_vec(bb, e)
            zero = np.zeros(nz, dtype=complex)
            Ej = np.concatenate([Rj, zero] if side == 0 else [zero, Rj])
            Ejm = np.outer(Ej, np.conj(Ej) / nz)
            A.append(sp.bmat([[sp.csr_matrix((nzz, nzz), dtype=complex), Zc],
                              [ZcT, sp.csr_matrix(Ejm)]]).tocsr())
            fv.append(make_s(j, c))
    return SPMF_NEP(A, fv, device=device)




# -- native WEP_FD ------------------------------------------------------------

_C128 = torch.complex128


def _along(v, x, dim):
    """``v`` shaped to broadcast along ``dim`` of ``x``."""
    shape = [1] * x.ndim
    shape[dim] = -1
    return v.reshape(shape)


def _R(bb, x, dim=0):
    """Boundary transform ``(bb * fft(x))`` reversed, along ``dim``."""
    return torch.flip(_along(bb, x, dim) * torch.fft.fft(x, dim=dim),
                      dims=(dim,))


def _Rinv(bbinv, x, dim=0):
    """Inverse of :func:`_R`: ``ifft(bbinv * reversed x)`` along ``dim``."""
    return torch.fft.ifft(_along(bbinv, x, dim) * torch.flip(x, dims=(dim,)),
                          dim=dim)


def _rows_block(A):
    """``(rows, block)`` of a sparse or dense matrix: the indices of its
    nonzero rows and those rows densely, so that ``A @ x`` is
    ``block @ x`` scattered into ``rows`` (the waveguide's C1 touches 2 nz
    of its nx nz rows)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    rows = np.flatnonzero(np.diff(A.indptr))
    return rows, A[rows].toarray()


class WEP(NEP):
    """Abstract marker for waveguide eigenvalue problems."""


class WEP_FD(WEP):
    """The waveguide problem in its native form on ``device``: interior
    ``X (nz, nx)`` with ``A(lam) X + X B + K .* X`` and the DtN boundary of
    2 nz unknowns coupled through ``C1``/``C2T``.  ``Mder`` raises: the
    problem is matrix-free; solves go through :class:`WEPLinSolverCreator`."""

    def __init__(self, nx, nz, hx, hz, Dxx, Dzz, Dz, C1, C2T, K, Km, Kp,
                 device=None):
        K = np.asarray(K)
        k_bar = complex(np.mean(K))
        self._setup(nx, nz, hx, hz, Dxx, Dzz, Dz, C1, C2T,
                    K.astype(complex) - k_bar, k_bar, Km, Kp, device)

    @classmethod
    def from_parts(cls, nx, nz, hx, hz, Dxx, Dzz, Dz, C1, C2T, K, k_bar, Km,
                   Kp, device=None):
        """A problem from the stored parts of another: ``K`` already
        shifted by its mean ``k_bar``."""
        obj = cls.__new__(cls)
        obj._setup(nx, nz, hx, hz, Dxx, Dzz, Dz, C1, C2T,
                   np.asarray(K, dtype=complex), complex(k_bar), Km, Kp,
                   device)
        return obj

    def _setup(self, nx, nz, hx, hz, Dxx, Dzz, Dz, C1, C2T, K, k_bar, Km, Kp,
               device):
        import scipy.sparse as sp

        device = resolve_device(device)
        self.device = device

        def dense(A):
            A = A.toarray() if sp.issparse(A) else np.array(A)
            return torch.as_tensor(A, dtype=_C128, device=device)

        self.nx, self.nz = int(nx), int(nz)
        self.hx, self.hz = float(hx), float(hz)
        self.Dxx, self.Dzz, self.Dz = dense(Dxx), dense(Dzz), dense(Dz)
        self.C1 = sp.csr_matrix(C1)
        self.C2T = sp.csr_matrix(C2T)
        rows, blk = _rows_block(self.C1)
        self._c1_rows = torch.as_tensor(rows, device=device)
        self._c1_blk = dense(blk)
        cols, blkT = _rows_block(self.C2T.T)
        self._c2_cols = torch.as_tensor(cols, device=device)
        self._c2_blk = dense(blkT.T)
        self.k_bar = complex(k_bar)
        self.K = dense(K)  # (nz, nx), shifted by k_bar
        p = (nz - 1) / 2
        self.p = p
        self.d0 = -3 / (2 * hx)
        self.d1 = 2 / hx
        self.d2 = -1 / (2 * hx)
        self.b = 4 * np.pi * 1j * np.arange(-p, p + 1)
        self.cM = Km**2 - 4 * np.pi**2 * np.arange(-p, p + 1) ** 2 + 0j
        self.cP = Kp**2 - 4 * np.pi**2 * np.arange(-p, p + 1) ** 2 + 0j
        self.bb = np.exp(-2j * np.pi * (np.arange(1, nz + 1) - 1) * (-p) / nz)
        self.bbinv = 1.0 / self.bb
        self._bb = torch.as_tensor(self.bb, device=device)
        self._bbinv = torch.as_tensor(self.bbinv, device=device)
        self._eye_z = torch.eye(self.nz, dtype=_C128, device=device)
        self.n = self.nx * self.nz + 2 * self.nz

    @property
    def issparse(self):
        return False

    def _vec(self, x):
        return torch.as_tensor(x, device=self.device).to(_C128)

    # boundary transforms (along the first axis: vectors or column blocks)
    def R(self, x):
        return _R(self._bb, self._vec(x))

    def Rinv(self, x):
        return _Rinv(self._bbinv, self._vec(x))

    def C1_apply(self, w):
        """``C1 @ w`` for ``w (2 nz)`` or ``(2 nz, k)``."""
        w = self._vec(w)
        out = torch.zeros((self.nx * self.nz,) + tuple(w.shape[1:]),
                          dtype=_C128, device=self.device)
        out[self._c1_rows] = self._c1_blk @ w
        return out

    def C2T_apply(self, v):
        """``C2T @ v`` for an interior ``v (nx nz)`` or ``(nx nz, k)``."""
        v = self._vec(v)
        return self._c2_blk @ v[self._c2_cols]

    def A_op(self, lam, d=0):
        lam = complex(lam)
        if d == 0:
            return (self.Dzz + 2 * lam * self.Dz
                    + (lam**2 + self.k_bar) * self._eye_z)
        if d == 1:
            return 2 * self.Dz + 2 * lam * self._eye_z
        if d == 2:
            return 2 * self._eye_z
        return torch.zeros_like(self._eye_z)

    def B_op(self, lam, d=0):
        return self.Dxx if d == 0 else torch.zeros_like(self.Dxx)

    def sM(self, lam):
        beta = lam**2 + self.b * lam + self.cM
        return 1j * np.sign(beta.imag) * np.sqrt(beta) + self.d0

    def sP(self, lam):
        beta = lam**2 + self.b * lam + self.cP
        return 1j * np.sign(beta.imag) * np.sqrt(beta) + self.d0

    def _s_pair(self, lam):
        s = np.concatenate([self.sM(lam), self.sP(lam)])
        return torch.as_tensor(s, device=self.device)

    def Pinv(self, lam, x):
        """Inverse of the boundary DtN operator on ``x (2 nz)`` or
        ``(2 nz, k)``."""
        x = self._vec(x)
        nz = self.nz
        s = self._s_pair(complex(lam))
        s = s.reshape((2 * nz,) + (1,) * (x.ndim - 1))
        return torch.cat([self.R(self.Rinv(x[:nz]) / s[:nz]),
                          self.R(self.Rinv(x[nz:]) / s[nz:])])

    def interior(self, v):
        """``X (.., nz, nx)`` of interior vectors ``v (nx nz)`` or
        ``(nx nz, k)`` (then ``X (k, nz, nx)``)."""
        v = self._vec(v)
        if v.ndim == 1:
            return v.reshape(self.nx, self.nz).T
        return v.T.reshape(-1, self.nx, self.nz).transpose(1, 2)

    @staticmethod
    def flatten(X):
        """The inverse of :meth:`interior`: ``X (nz, nx)`` -> ``(nx nz)``,
        ``X (k, nz, nx)`` -> ``(nx nz, k)``."""
        if X.ndim == 2:
            return X.T.reshape(-1)
        return X.transpose(1, 2).reshape(X.shape[0], -1).T

    def sylvester(self, lam, X):
        """``A(lam) X + X B + K .* X`` for ``X (.., nz, nx)``."""
        return self.A_op(lam) @ X + X @ self.Dxx + self.K * X

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        """``sum_j a_j M^(j + startder)(lam) V[:, j]``: the Sylvester-form
        interior (up to the second derivative of A; B and K are constant)
        and the boundary rows from the Gegenbauer derivative table of all
        2 nz branch-cut functions at once."""
        V = self._vec(V)
        if V.ndim == 1:
            V = V[:, None]
        na = V.shape[1]
        a = (np.ones(na, dtype=complex) if a is None else np.asarray(
            a.cpu() if isinstance(a, torch.Tensor) else a, dtype=complex))
        if startder != 0:
            # pad with zero columns/coefficients
            V = torch.cat([torch.zeros((V.shape[0], startder), dtype=_C128,
                                       device=self.device), V], dim=1)
            a = np.concatenate([np.zeros(startder, dtype=complex), a])
            na = V.shape[1]
        lam = complex(np.asarray(lam.cpu() if isinstance(lam, torch.Tensor)
                                 else lam))
        nx, nz = self.nx, self.nz
        max_d = na - 1
        V1, V2 = V[: nx * nz], V[nx * nz:]
        X = self.interior(V1)  # (na, nz, nx)
        y1_mat = self.sylvester(lam, X[0]) * complex(a[0])
        for d in range(1, min(max_d, 2) + 1):
            y1_mat = y1_mat + self.A_op(lam, d) @ X[d] * complex(a[d])
        y1 = self.flatten(y1_mat) + self.C1_apply(V2[:, 0]) * complex(a[0])

        D = sqrt_derivative_rows(np.concatenate([self.b, self.b]),
                                 np.concatenate([self.cM, self.cP]),
                                 max_d, lam)
        D = 1j * D
        D[:, 0] += self.d0
        coef = torch.as_tensor(D * a[None, :], device=self.device)
        RV2 = torch.cat([self.Rinv(V2[:nz]), self.Rinv(V2[nz:])])
        y2t = (coef * RV2).sum(dim=1)
        y2 = torch.cat([self.R(y2t[:nz]), self.R(y2t[nz:])])
        y2 = y2 + self.C2T_apply(V1[:, 0]) * complex(a[0])
        return torch.cat([y1, y2])

    def Mder(self, lam, der: int = 0):
        raise NotImplementedError(
            "WEP_FD exposes no assembled derivative matrices (Mder); its "
            "linear algebra runs matrix-free through the Schur-complement "
            "solvers — build solves via WEPLinSolverCreator instead.")


# -- WEP linear solvers ---------------------------------------------------------


class SchurMatVec:
    """``v -> (A(lam) X + X B + K.*X) - C1 Pinv(C2T v)`` (Ringh (2.13)/(3.3))
    for ``v (nx nz)`` or a block ``(nx nz, k)``."""

    def __init__(self, nep: WEP_FD, lam):
        self.nep = nep
        self.lam = complex(lam)

    def __call__(self, v):
        nep = self.nep
        v = nep._vec(v)
        top = nep.flatten(nep.sylvester(self.lam, nep.interior(v)))
        return top - nep.C1_apply(nep.Pinv(self.lam, nep.C2T_apply(v)))


def _pinv_blocks(nep, lam):
    """The nz x nz matrices of the boundary DtN inverse on each side:
    ``R(Rinv(e_i) / s)`` for every unit vector ``e_i``."""
    eye = nep._eye_z
    sM = torch.as_tensor(nep.sM(lam), device=nep.device)[:, None]
    sP = torch.as_tensor(nep.sP(lam), device=nep.device)[:, None]
    return nep.R(nep.Rinv(eye) / sM), nep.R(nep.Rinv(eye) / sP)


def construct_WEP_schur_complement(nep: WEP_FD, lam):
    """The Schur complement of the interior (Ringh Prop. 3.1),
    ``kron(B^T, I) + kron(I, A) + diag(K) - kron(E, Pinv_-) - kron(E', Pinv_+)``,
    assembled dense on the problem's device: block-tridiagonal in x with
    nz x nz blocks, (nx nz)^2 complex128 (2.1 GB at nx = 109, nz = 105)."""
    nx, nz = nep.nx, nep.nz
    lam = complex(lam)
    Pm, Pp = _pinv_blocks(nep, lam)
    S = torch.zeros((nx, nz, nx, nz), dtype=_C128, device=nep.device)
    # the block (p, q) of kron(B^T, I) is B[q, p] I
    S.diagonal(0, 1, 3).add_(nep.B_op(lam).T[:, :, None])
    idx = torch.arange(nx, device=nep.device)
    S[idx, :, idx, :] += nep.A_op(lam)[None] + torch.diag_embed(nep.K.T)
    e1, e2 = nep.d1 / nep.hx**2, nep.d2 / nep.hx**2
    S[0, :, 0, :] -= e1 * Pm
    S[0, :, 1, :] -= e2 * Pm
    S[nx - 1, :, nx - 1, :] -= e1 * Pp
    S[nx - 1, :, nx - 2, :] -= e2 * Pp
    return S.reshape(nx * nz, nx * nz)


class _WEPSolverBase(LinSolver):
    def __init__(self, nep: WEP_FD, lam):
        self.nep = nep
        self.lam = complex(lam)
        self.device = nep.device

    def _inner(self, rhs, tol):
        raise NotImplementedError

    def solve(self, b, tol=None):
        """Full-system solve through the Schur complement (Ringh Prop. 2.1
        back-substitution); a block right-hand side ``(n, k)`` goes through
        the interior solve as one block."""
        nep = self.nep
        lam = self.lam
        b = nep._vec(b)
        nxz = nep.nx * nep.nz
        x_int, x_ext = b[:nxz], b[nxz:]
        rhs = x_int - nep.C1_apply(nep.Pinv(lam, x_ext))
        q = self._inner(rhs, tol if tol is not None else 1e-12)
        return torch.cat([q, nep.Pinv(lam, -nep.C2T_apply(q) + x_ext)])


class WEPFactorizedLinSolver(_WEPSolverBase):
    """One dense LU of the assembled Schur complement on the device
    (``lu``, ``piv``), triangular solves per call."""

    def __init__(self, nep, lam):
        super().__init__(nep, lam)
        S = construct_WEP_schur_complement(nep, lam)
        self.lu, self.piv = torch.linalg.lu_factor(S)
        del S

    def _inner(self, rhs, tol):
        return _lu_solve(self.lu, self.piv, rhs)


class WEPBackslashLinSolver(_WEPSolverBase):
    """The assembled Schur complement kept; every call solves anew."""

    def __init__(self, nep, lam):
        super().__init__(nep, lam)
        self.S = construct_WEP_schur_complement(nep, lam)

    def _inner(self, rhs, tol):
        return torch.linalg.solve(self.S, rhs)


class WEPGMRESLinSolver(_WEPSolverBase):
    """Matrix-free: :func:`gmres_restarted` over :class:`SchurMatVec` with an
    optional preconditioner (such as :class:`WEPPreconditioner`), at
    relative tolerance ``reltol`` and at most ``maxiter`` restarts of 20
    steps.  ``iterations`` holds the Arnoldi steps of each interior solve,
    ``info`` their scipy-style exit codes."""

    def __init__(self, nep, lam, preconditioner=None, reltol=1e-10,
                 maxiter=500):
        super().__init__(nep, lam)
        self.mv = SchurMatVec(nep, lam)
        self.preconditioner = preconditioner
        self.reltol = reltol
        self.maxiter = maxiter
        self.iterations = []
        self.info = []

    def _inner(self, rhs, tol):
        if rhs.ndim == 2:
            return torch.stack([self._inner(rhs[:, j], tol)
                                for j in range(rhs.shape[1])], dim=1)
        q, info, its = gmres_restarted(self.mv, rhs, rtol=self.reltol,
                                       maxiter=self.maxiter,
                                       psolve=self.preconditioner)
        self.iterations.append(its)
        self.info.append(info)
        return q


class WEPLinSolverCreator(LinSolverCreator):
    """``solver_type`` ``":factorized"`` (default), ``":backslash"`` or
    ``":gmres"`` (keyword arguments go to :class:`WEPGMRESLinSolver`)."""

    def __init__(self, solver_type=":factorized", **kwargs):
        self.solver_type = solver_type
        self.kwargs = kwargs

    def create(self, nep, lam):
        if not isinstance(nep, WEP_FD):
            raise ValueError("WEPLinSolver can only be used in combination "
                             f"with WEPs: type(nep)={type(nep)}")
        if self.solver_type == ":backslash":
            return WEPBackslashLinSolver(nep, lam)
        if self.solver_type == ":gmres":
            return WEPGMRESLinSolver(nep, lam, **self.kwargs)
        if self.solver_type == ":factorized":
            return WEPFactorizedLinSolver(nep, lam)
        raise ValueError("Unknown type of solver_type in "
                         f"linsolvercreator:{self.solver_type}")


def wep_gallery(nx=3 * 5 * 7, nz=3 * 5 * 7, benchmark_problem="TAUSCH",
                neptype="WEP", delta=0.1, device=None):
    """``nep_gallery("waveguide", ...)``: the native :class:`WEP_FD`
    (``neptype="WEP"``) or the SPMF format (``"SPMF"``/``"SPMF_PRE"``) on
    ``device`` (default: the card)."""
    if nz % 2 == 0:
        raise ValueError(f"Variable nz must be odd! You have used nz = {nz}.")
    wg = benchmark_problem.upper()
    neptype = neptype.upper()
    if neptype not in ("SPMF", "SPMF_PRE", "WEP"):
        raise ValueError(f"The NEP-type '{neptype}' is not supported.")
    device = resolve_device(device)
    K, hx, hz, Km, Kp = _wavenumber(nx, nz, wg, delta)
    Dxx, Dzz, Dz = generate_fd_interior_mat(nx, nz, hx, hz)
    C1, C2T = generate_fd_boundary_mat(nx, nz, hx, hz)
    if neptype == "WEP":
        return WEP_FD(nx, nz, hx, hz, Dxx, Dzz, Dz, C1, C2T, K, Km, Kp,
                      device=device)
    return assemble_waveguide_spmf_fd(nx, nz, hx, Dxx, Dzz, Dz, C1, C2T, K,
                                      Km, Kp, device=device)


# -- Sylvester-SMW preconditioner (Ringh et al. Sections 4-5) -----------------


def _dst_pad(v, inverse):
    """Odd extension of ``v (.., nrow, m)`` along its rows, FFT'd
    (``inverse``: the unnormalized inverse FFT), rows 1..nrow kept."""
    nrow = v.shape[-2]
    n = nrow + 1
    pad = torch.zeros(v.shape[:-2] + (2 * n, v.shape[-1]), dtype=_C128,
                      device=v.device)
    pad[..., 1:n, :] = v
    if inverse:
        return torch.fft.ifft(pad, dim=-2)[..., 1:n, :] * (2 * n)
    return torch.fft.fft(pad, dim=-2)[..., 1:n, :]


def _F_dst(v):
    return _dst_pad(v, False)


def _Fh_dst(v):
    return _dst_pad(v, True)


def _W_dst(X):
    """Eigenvector action of Dxx along the rows of ``X (.., nrow, m)`` (a
    DST through an FFT)."""
    nz1 = X.shape[-2]
    return (_F_dst(X) - _Fh_dst(X)) * (1j / 2.0) / np.sqrt((nz1 + 1) / 2.0)


def _ct(X):
    return X.conj().transpose(-1, -2)


def solve_wg_sylvester_fft(C, lam, k_bar, hx, hz):
    """FFT-diagonalized Sylvester solve ``A X + X B + alpha X = C`` of the
    waveguide (Ringh Sec. 5.3) for ``C (.., nz, nx)``: every leading index
    is an independent right-hand side, all solved by the same FFT calls."""
    C = torch.as_tensor(C).to(_C128)
    nz, nx = C.shape[-2:]
    lam = complex(lam)
    alpha = lam**2 + k_bar
    v = np.zeros(nz, dtype=complex)
    v[0] = -2
    v[1] = 1
    v[nz - 1] = 1
    v = v / hz**2
    w = np.zeros(nz, dtype=complex)
    w[1] = 1
    w[nz - 1] = -1
    w = w * (lam / hz)
    D = np.fft.fft(v + w) + alpha
    S = -(4.0 / hx**2) * np.sin(np.pi * np.arange(1, nx + 1)
                                / (2 * (nx + 1))) ** 2
    denom = torch.as_tensor(D[:, None] + S[None, :], device=C.device)
    # change variables: C = Vh( Wh(C')' )
    C = _ct(_W_dst(_ct(C)))
    C = torch.fft.ifft(C, dim=-2) * np.sqrt(nx)
    # solve the diagonal matrix equation
    Z = C / denom
    # change back: C = V( W(Z')' )
    C = _ct(_W_dst(_ct(Z)))
    return torch.fft.fft(C, dim=-2) / np.sqrt(nx)


def _smw_check(nep, N):
    if nep.nz + 4 != nep.nx:
        raise ValueError("This implementation requires nx = nz + 4. Provided "
                         f"NEP has nz = {nep.nz} and nx = {nep.nx}")
    if nep.nz % N != 0:
        raise ValueError(f"Requires nz/N integer; nz = {nep.nz}, N = {N}.")


def _smw_ops(nep, sigma):
    """``(Linv, dd1, dd2, Pm, Pp, K)`` of the SMW construction at
    ``sigma``; ``Pm``/``Pp`` act along the last axis."""
    sigma = complex(sigma)
    dd1 = nep.d1 / nep.hx**2
    dd2 = nep.d2 / nep.hx**2
    sMv = torch.as_tensor(nep.sM(sigma), device=nep.device)
    sPv = torch.as_tensor(nep.sP(sigma), device=nep.device)

    def Linv(rhs):
        return solve_wg_sylvester_fft(rhs, sigma, nep.k_bar, nep.hx, nep.hz)

    def Pm(v):
        return -_R(nep._bb, _Rinv(nep._bbinv, v, -1) / sMv, -1)

    def Pp(v):
        return -_R(nep._bb, _Rinv(nep._bbinv, v, -1) / sPv, -1)

    return Linv, dd1, dd2, Pm, Pp, nep.K


def _smw_indexing(n, N):
    """The SMW index maps on the nz x (nz + 4) grid: L = n / N rows (and
    interior columns) a block; the unknown k = (i - 1)(N + 4) + j of
    row block i and column group j (1: column 0, 2: column 1, 3..N+2: the
    interior column blocks, N+3: column nx-2, N+4: column nx-1) is
    ``(i - 1, j - 1)`` of an ``(N, N + 4)`` array.  Returns ``(L, rowb,
    colb)``: each row's block and each column's group, 0-based."""
    L = n // N
    nx = n + 4
    rowb = np.arange(n) // L
    colb = np.empty(nx, dtype=np.int64)
    colb[0], colb[1] = 0, 1
    colb[2:nx - 2] = (np.arange(nx - 4) // L) + 2
    colb[nx - 2], colb[nx - 1] = N + 2, N + 3
    return L, rowb, colb


def _smw_sums(F, N, L):
    """The SMW functionals of ``F (.., nz, nx)``: block means over each
    (row block, column group), ``(.., N (N + 4))`` in the unknowns'
    order — interior blocks summed over L x L and divided by L^2, boundary
    columns summed over L rows and divided by L."""
    nz, nx = F.shape[-2:]
    lead = F.shape[:-2]

    def col(c):
        return F[..., :, c].reshape(lead + (N, L)).sum(-1)[..., None] / L

    mid = F[..., :, 2:nx - 2].reshape(lead + (N, L, N, L)).sum((-3, -1))
    G = torch.cat([col(0), col(1), mid / (L * L), col(nx - 2), col(nx - 1)],
                  dim=-1)
    return G.reshape(lead + (N * (N + 4),))


def _smw_expand(coef, N, dd1, dd2, Pm, Pp, K):
    """``sum_k coef[.., k] E_k``, the SMW basis matrices ``E_k (nz, nx)``
    (K restricted to the unknown's block, and for the boundary groups the
    DtN term ``Pm``/``Pp`` of ``dd1``/``dd2`` on its rows) weighted by
    ``coef (.., N (N + 4))``, as one gather and two boundary applies."""
    nz, nx = K.shape
    L, rowb, colb = _smw_indexing(nz, N)
    A = coef.reshape(coef.shape[:-1] + (N, N + 4))
    dev = K.device
    rb = torch.as_tensor(rowb, device=dev)
    cb = torch.as_tensor(colb, device=dev)
    Y = K * A[..., rb[:, None], cb[None, :]]
    em = (dd1 * A[..., :, 0] + dd2 * A[..., :, 1]).repeat_interleave(L, -1)
    ep = (dd1 * A[..., :, N + 3] + dd2 * A[..., :, N + 2]).repeat_interleave(
        L, -1)
    Y[..., :, 0] += Pm(em)
    Y[..., :, nx - 1] += Pp(ep)
    return Y


def smw_system_matrix(nep: WEP_FD, N, sigma):
    """The dense SMW system matrix ``M (N^2 + 4N, N^2 + 4N)`` for N
    z-domains at ``sigma``, unfactored (:func:`generate_smw_matrix`
    factors it)."""
    _smw_check(nep, N)
    return _smw_matrix(nep.nz, N, *_smw_ops(nep, sigma))


def _smw_matrix(n, N, Linv, dd1, dd2, Pm, Pp, K):
    mm = N * N + 4 * N
    L = n // N
    eye = torch.eye(mm, dtype=_C128, device=K.device)
    # the mm basis matrices as one stack, all Sylvester solves in one pass
    F = Linv(_smw_expand(eye, N, dd1, dd2, Pm, Pp, K))
    return _smw_sums(F, N, L).T + eye


def _generate_smw_matrix(n, N, Linv, dd1, dd2, Pm, Pp, K):
    return torch.linalg.lu_factor(_smw_matrix(n, N, Linv, dd1, dd2, Pm, Pp,
                                              K))


def generate_smw_matrix(nep: WEP_FD, N, sigma):
    """LU factors ``(lu, piv)`` of the SMW system matrix for N z-domains at
    shift ``sigma``, on the problem's device."""
    _smw_check(nep, N)
    return _generate_smw_matrix(nep.nz, N, *_smw_ops(nep, sigma))


def solve_smw(nep: WEP_FD, M, C, sigma):
    """Solve the SMW-corrected Sylvester system for ``C (nz, nx)``."""
    return _solve_smw(M, nep._vec(C), *_smw_ops(nep, sigma))


def _solve_smw(M, C, Linv, dd1, dd2, Pm, Pp, K):
    lu, piv = M
    mm = lu.shape[0]
    N = int(round(np.sqrt(mm + 4) - 2))
    nz = C.shape[-2]
    LinvC = Linv(C)
    b = _smw_sums(LinvC, N, nz // N)
    alpha = _lu_solve(lu, piv, b)
    return LinvC - Linv(_smw_expand(alpha, N, dd1, dd2, Pm, Pp, K))


class WEPPreconditioner:
    """Preconditioner for the WEP Schur complement: ``v -> `` the SMW
    solve of the interior vector ``v``, factored once at ``sigma``."""

    def __init__(self, nep: WEP_FD, N, sigma):
        self.nep = nep
        self.sigma = complex(sigma)
        self.M = generate_smw_matrix(nep, N, sigma)
        self._ops = _smw_ops(nep, sigma)

    def __call__(self, v):
        nep = self.nep
        C = nep.interior(v)
        return nep.flatten(_solve_smw(self.M, C, *self._ops))


def wep_generate_preconditioner(nep: WEP_FD, N, sigma):
    return WEPPreconditioner(nep, N, sigma)
