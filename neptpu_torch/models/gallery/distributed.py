"""Distributed-delay DEP (Jarlebring, Michiels, Meerbergen 2012): an SPMF
with a Gauss-Legendre quadrature *inside* a matrix function,
``f2(S) = int_{-1}^0 e^{xS} k(x) dx``, by accumulated matrix exponentials.
Ten published eigenvalues are its oracle."""
from __future__ import annotations

import numpy as np
import torch

from ...ops import matfun
from ..spmf import SPMF_NEP

__all__ = ["dep_distributed", "DEP_DISTRIBUTED_EIGENVALUES",
           "gauss_legendre_weights", "distributed_kernel_gauss_legendre",
           "distributed_kernel_trapezoidal"]

DEP_DISTRIBUTED_EIGENVALUES = np.array(
    [
        -0.400236388049641 + 0.970633098237807j,
        -0.400236388049641 - 0.970633098237807j,
        2.726146249832675 + 0.0j,
        -1.955643591177653 + 3.364550574688863j,
        -1.955643591177653 - 3.364550574688863j,
        4.493937056300693 + 0.0j,
        -1.631513006819252 + 4.555484848248613j,
        -1.631513006819252 - 4.555484848248613j,
        -1.677320660400946 + 7.496870451838560j,
        -1.677320660400946 - 7.496870451838560j,
    ]
)


def gauss_legendre_weights(N, a, b):
    """Gauss-Legendre nodes and weights on [a, b]."""
    y, w = np.polynomial.legendre.leggauss(N)
    x = (a * (1 - y) + b * (1 + y)) / 2
    w = (b - a) / 2 * w
    return x, w


def _as_matrix(S):
    S = torch.as_tensor(S)
    scalar = S.ndim == 0
    return (S.reshape(1, 1) if scalar else S), scalar


def distributed_kernel_gauss_legendre(S, N=10):
    """``f2(S) = int_{-1}^{0} e^{xS} (e^{(x+1/2)^2} - e^{1/4}) dx`` by
    N-point Gauss-Legendre with accumulated matrix exponentials."""
    S, scalar = _as_matrix(S)
    xv, wv = gauss_legendre_weights(N, -1.0, 0.0)
    fvals = np.exp((xv + 0.5) ** 2) - np.exp(0.25)
    F = torch.zeros_like(S)
    E = None
    for i in range(len(xv)):
        # exp(x_i S) = exp(x_{i-1} S) exp((x_i - x_{i-1}) S)
        if i == 0:
            E = matfun.expm(float(xv[0]) * S)
        else:
            E = E @ matfun.expm(float(xv[i] - xv[i - 1]) * S)
        F = F + E * float(fvals[i] * wv[i])
    return F[0, 0] if scalar else F


def distributed_kernel_trapezoidal(S, N=1000):
    """The trapezoidal-rule form of the distributed kernel, kept to
    cross-check the Gauss-Legendre one."""
    S, scalar = _as_matrix(S)
    h = 1.0 / N
    xv = np.arange(N + 1) * h - 1.0
    wv = np.full(N + 1, h)
    wv[0] *= 0.5
    wv[-1] *= 0.5
    fvals = np.exp((xv + 0.5) ** 2) - np.exp(0.25)
    Eh = matfun.expm(h * S)  # exp(x_{i+1} S) = exp(x_i S) exp(h S)
    E = matfun.expm(float(xv[0]) * S)
    F = torch.zeros_like(S)
    for i in range(N + 1):
        if i > 0:
            E = E @ Eh
        F = F + E * float(fvals[i] * wv[i])
    return F[0, 0] if scalar else F


def dep_distributed(device=None):
    A0 = -np.eye(3)
    A1 = np.array([[2.5, 2.8, -0.5], [1.8, 0.3, 0.3], [-2.3, -1.4, 3.5]])
    A2 = np.array([[1.7, 0.7, -0.3], [-2.4, -2.1, -0.2], [2.0, 0.7, 0.4]])
    A3 = np.array([[1.4, -1.3, 0.4], [1.4, 0.7, 1.0], [0.6, 1.6, 1.7]])

    def f1(S):
        return matfun.expm(-S)

    def f2(S):
        return distributed_kernel_gauss_legendre(S, 10)

    return SPMF_NEP([A0, A1, A2, A3], [lambda S: S, matfun.eye_like, f1, f2],
                    device=device)
