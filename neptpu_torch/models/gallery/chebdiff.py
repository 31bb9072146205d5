"""Chebyshev spectral differentiation matrices (Weideman & Reddy, "A MATLAB
Differentiation Matrix Suite", ACM TOMS 26(4), 2000 — the ``chebdif`` and
``cheb4c`` algorithms) and the Orr-Sommerfeld/Squire problem built on them.

Both routines use the suite's accuracy devices: Chebyshev points computed
through ``sin`` (exact symmetry), the trigonometric-identity off-diagonal
differences with the flipping trick, and the negative-sum / cumsum tricks
for the diagonals.  The matrices are built on the host in float64; the
problem's operands go to ``device``.
"""
from __future__ import annotations

import numpy as np

from ...config import resolve_device

__all__ = ["chebdif", "cheb4c", "orr_sommerfeld"]


def _cheb_dx(th, n1, n2, npts):
    """Pairwise x_k - x_j via 2 sin((t+t')/2) sin((t-t')/2), upper half
    computed and the lower half obtained by (anti)symmetry (flipping
    trick), ones on the diagonal."""
    T = th[:, None] / 2.0
    DX = 2.0 * np.sin(T.T + T) * np.sin(T.T - T)
    DX = np.vstack([DX[:n1, :], -DX[:n2, ::-1][::-1, :]])
    np.fill_diagonal(DX, 1.0)
    return DX


def chebdif(npts: int, m: int):
    """Differentiation matrices of orders 1..m on ``npts`` Chebyshev
    points (Gauss-Lobatto, descending from +1 to -1).

    Returns ``(x, [D1, ..., Dm])``.
    """
    if not 0 < m <= npts - 1:
        raise ValueError("need 0 < m <= npts-1")
    N = npts
    n1, n2 = N // 2, (N + 1) // 2
    k = np.arange(N)
    th = k * np.pi / (N - 1)
    x = np.sin(np.pi * np.arange(N - 1, -N, -2) / (2.0 * (N - 1)))

    DX = _cheb_dx(th, n1, n2, N)

    # c_k/c_j with c = (-1)^k, doubled at the two boundary rows/cols
    c = (-1.0) ** k
    c[0] *= 2.0
    c[-1] *= 2.0
    C = c[:, None] / c[None, :]

    Z = 1.0 / DX
    np.fill_diagonal(Z, 0.0)

    D = np.eye(N)
    out = []
    for ell in range(1, m + 1):
        D = ell * Z * (C * np.diag(D)[:, None] - D)
        np.fill_diagonal(D, 0.0)
        np.fill_diagonal(D, -D.sum(axis=1))  # negative-sum trick
        out.append(D.copy())
    return x, out


def cheb4c(npts: int):
    """Fourth-derivative matrix on the ``npts - 2`` INTERIOR Chebyshev
    points with clamped boundary conditions u(+-1) = u'(+-1) = 0.

    Returns ``(x_interior, D4)``.
    """
    N = npts
    ni = N - 2
    n1, n2 = ni // 2, (ni + 1) // 2
    k = np.arange(1, N - 1)
    th = k * np.pi / (N - 1)
    x = np.sin(np.pi * np.arange(N - 3, -N + 1, -2) / (2.0 * (N - 1)))

    # s = sin(theta), symmetrized by the flipping trick
    s = np.concatenate([np.sin(th[:n1]), np.sin(th[:n2])[::-1]])

    # boundary-condition weight functions (clamped: weight (1-x^2)^2)
    a = s ** 4
    B = np.vstack([
        -4.0 * s ** 2 * x / a,
        4.0 * (3.0 * x ** 2 - 1.0) / a,
        24.0 * x / a,
        24.0 / a,
    ])

    DX = _cheb_dx(th, n1, n2, ni)

    ss = s ** 2 * (-1.0) ** k
    C = ss[:, None] / ss[None, :]

    Z = 1.0 / DX
    np.fill_diagonal(Z, 0.0)

    # X: columns of Z^T with the diagonal zeros removed (ni-1 x ni);
    # column j must enumerate Z^T[:, j] = row j of Z in increasing index
    # order (Z is antisymmetric, so orientation carries a sign)
    X = Z[~np.eye(ni, dtype=bool)].reshape(ni, ni - 1).T

    Y = np.ones((ni - 1, ni))
    D = np.eye(ni)
    for ell in range(1, 5):
        Y = np.cumsum(np.vstack([B[ell - 1], ell * Y[: ni - 1] * X]), axis=0)
        D = ell * Z * (C * np.diag(D)[:, None] - D)
        np.fill_diagonal(D, Y[ni - 1])
    return x, D


def orr_sommerfeld(n: int = 256, Re: float = 2000.0, omega: float = 0.3,
                   beta: float = 0.0, device=None):
    """Orr-Sommerfeld/Squire spatial-stability PEP for plane Poiseuille
    flow: degree-4 polynomial in the streamwise wavenumber alpha (Schmid &
    Henningson, *Stability and Transition in Shear Flows*, Table 7.1).

    ``n`` interior Chebyshev points; size 2n (v and eta stacked).
    Returns a :class:`~neptpu_torch.models.pep.PEP` on ``device``.
    """
    device = resolve_device(device)
    from ..pep import PEP

    yF, DM = chebdif(n + 2, 2)
    D2 = DM[1][1:n + 1, 1:n + 1]
    yF4, D4 = cheb4c(n + 2)
    y = yF[1:n + 1]

    U = np.diag(1.0 - y ** 2)   # base flow
    Up = np.diag(-2.0 * y)
    Upp = -2.0
    I = np.eye(n)
    Zb = np.zeros((n, n))
    b2 = beta ** 2

    def blk(a, b, c, d):
        return np.block([[a, b], [c, d]])

    A4 = blk(-I / Re, Zb, Zb, Zb).astype(complex)
    A3 = blk(-1j * U, Zb, Zb, Zb)
    A2 = blk((1j * omega - 2 * b2 / Re) * I + 2 * D2 / Re, Zb, Zb, I / Re)
    A1 = blk(1j * (U @ (D2 - b2 * I) - Upp * I), Zb, Zb, 1j * U)
    A0 = blk(2 * b2 * D2 / Re - D4 / Re - b2 ** 2 * I / Re
             + 1j * omega * (b2 * I - D2), Zb,
             1j * beta * Up, (-1j * omega + b2 / Re) * I - D2 / Re)
    return PEP([A0, A1, A2, A3, A4], device=device)
