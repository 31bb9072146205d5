"""Waveguide eigenvalue problem (WEP) — FD discretization of the waveguide
Helmholtz equation with DtN boundary conditions (Jarlebring/Mele/Runborg
SISC 2017, Ringh/Mele/Karlsson/Jarlebring LAA 2018), in its SPMF format:
3 + 2 nz terms — the Q0/Q1/Q2 polynomial part plus rank-one boundary terms
with the branch-cut functions

    s_j(lam) = i sqrt(lam^2 + b_j lam + c_j) + d0.

Assembly runs on the host in numpy/scipy; the term bank goes to ``device``
once.  The branch-cut functions are host functions: they take and return
complex128 CPU tensors and carry exact derivative tables (the Gegenbauer
recurrence of :func:`sqrt_derivative`).  The native ``WEP_FD`` format is not
ported yet (ROADMAP A.15): ``neptype="WEP"`` raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...config import resolve_device
from ...ops import matfun
from ..spmf import SPMF_NEP

__all__ = [
    "wep_gallery",
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


def sqrt_derivative(a, b, c, d=0, x=0.0):
    """All d derivatives of sqrt(a z^2 + b z + c) at z = x via the Gegenbauer
    recurrence (Jarlebring App. C)."""
    if d < 0:
        raise ValueError(f"Cannot take negative derivative. d = {d}")
    aa = a
    bb = b + 2 * a * x
    cc = c + a * x**2 + b * x
    der = np.zeros(d + 1, dtype=complex)
    yi = sqrt_pos_imag(cc)
    der[0] = yi
    if d == 0:
        return der
    yip1 = bb / (2 * sqrt_pos_imag(cc))
    fact = 1.0
    der[1] = yip1 * fact
    if d == 1:
        return der
    for i in range(2, d + 1):
        m = i - 2
        yip2 = -(2 * aa * (m - 1) * yi + bb * (1 + 2 * m) * yip1) / (
            2 * cc * (2 + m))
        fact *= i
        yi = yip1
        yip1 = yip2
        der[i] = yip2 * fact
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


def wep_gallery(nx=3 * 5 * 7, nz=3 * 5 * 7, benchmark_problem="TAUSCH",
                neptype="WEP", delta=0.1, device=None):
    """``nep_gallery("waveguide", ...)``: the SPMF format
    (``neptype="SPMF"``/``"SPMF_PRE"``) on ``device`` (default: the card)."""
    if nz % 2 == 0:
        raise ValueError(f"Variable nz must be odd! You have used nz = {nz}.")
    wg = benchmark_problem.upper()
    neptype = neptype.upper()
    if neptype == "WEP":
        raise NotImplementedError(
            "the native WEP_FD format is not ported to neptpu_torch yet "
            "(ROADMAP A.15); use neptype='SPMF'")
    if neptype not in ("SPMF", "SPMF_PRE"):
        raise ValueError(f"The NEP-type '{neptype}' is not supported.")
    device = resolve_device(device)
    K, hx, hz, Km, Kp = _wavenumber(nx, nz, wg, delta)
    Dxx, Dzz, Dz = generate_fd_interior_mat(nx, nz, hx, hz)
    C1, C2T = generate_fd_boundary_mat(nx, nz, hx, hz)
    return assemble_waveguide_spmf_fd(nx, nz, hx, Dxx, Dzz, Dz, C1, C2T, K,
                                      Km, Kp, device=device)
