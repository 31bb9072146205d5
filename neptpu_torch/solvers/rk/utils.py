"""Leja-Bagby nodes and rational divided differences.

The nodes, poles and scalings are host numpy.  The divided differences of a
matrix-valued function (``ratnewtoncoeffs`` over ``compute_Mder``) are
tensors on the device the function returns them on; those of the scalar
term functions (``scgendivdiffs``) are a host table, each row the first
column of ``f`` applied to a small bidiagonal pencil through the port's
matrix functions (``ops/matfun.py``).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["lejabagby", "scgendivdiffs", "ratnewtoncoeffs", "ratnewtoncoeffsm",
           "evalrat"]


def lejabagby(A, B, C, m, keepA=False, forceInf=0):
    """Leja-Bagby points ``(a, b)`` on ``(A, B)`` with sup-norm scaling
    ``beta`` on ``C``."""
    A = np.asarray(A, dtype=complex)
    B = np.asarray(B, dtype=complex)
    C = np.asarray(C, dtype=complex)
    if np.min(np.abs(B)) < 1e-9:
        warnings.warn(
            "There is at least one pole candidate in B being nearby zero. "
            "Consider shifting your problem for stability.")
    a = [A[0]]
    b = [np.inf if forceInf > 0 else B[0]]
    beta = [1.0]
    sA = np.ones(A.shape, dtype=complex)
    sB = np.ones(B.shape, dtype=complex)
    sC = np.ones(C.shape, dtype=complex)
    for j in range(m - 1):
        binv = 0.0 if np.isinf(b[j]) else 1.0 / b[j]
        betainv = 1.0 / beta[j]
        with np.errstate(all="ignore"):
            # an infinite pole candidate gives NaNs here; the argmin/argmax
            # below read them as -inf/+inf
            sA *= betainv * (A - a[j]) / (1 - A * binv)
            sB *= betainv * (B - a[j]) / (1 - B * binv)
            sC *= betainv * (C - a[j]) / (1 - C * binv)
        if keepA:
            a.append(A[j + 1])
        else:
            vals = np.where(np.isnan(sA), -np.inf, np.abs(sA))
            a.append(A[int(np.argmax(vals))])
        if forceInf > j + 1:
            b.append(np.inf)
        else:
            vals = np.where(np.isnan(sB), np.inf, np.abs(sB))
            b.append(B[int(np.argmin(vals))])
        bj = float(np.max(np.abs(sC)))
        beta.append(1.0 if bj < np.finfo(float).eps else bj)
    return np.asarray(a), np.asarray(b), np.asarray(beta)


def evalrat(sigma, xi, beta, z):
    """The nodal rational function at the points ``z``."""
    z = np.asarray(z, dtype=complex)
    r = np.ones_like(z) / beta[0]
    for j in range(len(sigma)):
        xij = xi[j]
        denom = np.ones_like(z) if np.isinf(xij) else (1 - z / xij)
        r = r * (z - sigma[j]) / denom / beta[j + 1]
    return r


def _unit_matrix(x):
    return torch.tensor([[complex(x)]], dtype=torch.complex128)


def ratnewtoncoeffs(fun, sigma, xi, beta):
    """Rational divided differences by differencing.  ``fun`` takes a 1 x 1
    complex128 matrix holding the node and may return a matrix of any size
    (a tensor on any device, or an array): the differences are of its
    kind."""
    sigma = np.asarray(sigma, dtype=complex)
    m = len(sigma)
    D = [fun(_unit_matrix(sigma[0])) * beta[0]]
    for j in range(1, m):
        Qj = D[0] * 0
        for k in range(j):
            Qj = Qj + D[k] * complex(
                evalrat(sigma[:k], xi[:k], beta[: k + 1], [sigma[j]])[0])
        denom = complex(evalrat(sigma[:j], xi[:j], beta[: j + 1],
                                [sigma[j]])[0])
        D.append((fun(_unit_matrix(sigma[j])) - Qj) / denom)
    return D


def ratnewtoncoeffsm(fm, sigma, xi, beta):
    """Rational divided differences of a scalar function as the first column
    of ``fm`` applied to the bidiagonal Hessenberg pencil ``H K^{-1}``
    (host numpy in and out; ``fm`` sees a complex128 CPU tensor)."""
    sigma = np.asarray(sigma, dtype=complex)
    xi = np.asarray(xi, dtype=complex)
    beta = np.asarray(beta, dtype=float)
    m = len(sigma) - 1
    K = np.eye(m + 1, dtype=complex)
    sub = beta[1: m + 1] / np.where(np.isinf(xi[:m]), np.inf, xi[:m])
    sub = np.where(np.isinf(xi[:m]), 0.0, sub)
    K[np.arange(1, m + 1), np.arange(m)] = sub
    H = np.diag(sigma[: m + 1]).astype(complex)
    H[np.arange(1, m + 1), np.arange(m)] = beta[1: m + 1]
    # column balancing
    P = np.diag(1.0 / np.max(np.abs(K), axis=0))
    K = K @ P
    H = H @ P
    HK = H @ np.linalg.inv(K)
    F = fm(torch.from_numpy(HK))
    return _host(F)[:, 0] * beta[0]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scgendivdiffs(sigma, xi, beta, maxdgr, isfunm, pff):
    """Divided-difference table of the scalar functions ``pff``:
    ``sgdd[i, :]`` over ``maxdgr + 2`` nodes (host complex128)."""
    sgdd = np.zeros((len(pff), maxdgr + 2), dtype=complex)
    for i, f in enumerate(pff):
        if isfunm:
            sgdd[i, :] = ratnewtoncoeffsm(f, sigma[: maxdgr + 2], xi, beta)
        else:
            D = ratnewtoncoeffs(f, sigma[: maxdgr + 2], xi, beta)
            sgdd[i, :] = np.array([complex(_host(d).ravel()[0]) for d in D])
    return sgdd
