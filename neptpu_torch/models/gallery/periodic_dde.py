"""Time-periodic DDE monodromy problems (Bueler SINUM 2007): ``compute_MM``
by time-stepping an ODE over one period — RK4 for the ODE form, backward
Euler for the DAE form — so the problem's matrix action is a monodromy map.

The time-stepping runs on the host in complex128 numpy (a sequence of small
dense steps, two unknowns in the gallery's problems); the results are
tensors on the problem's ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...config import resolve_device
from ...core.nep import NEP, mlincomb_from_mm

__all__ = ["PeriodicDDE_NEP", "PeriodicDDE_NEP_ODE", "PeriodicDDE_NEP_DAE",
           "periodic_dde_gallery", "MATHIEU_EIGENVALUES"]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _ode_rk4(f, a, b, N, y0):
    h = (b - a) / N
    t = a
    y = np.array(y0, dtype=complex)
    for _ in range(N):
        s1 = h * f(t, y)
        s2 = h * f(t + h / 2, y + s1 / 2)
        s3 = h * f(t + h / 2, y + s2 / 2)
        s4 = h * f(t + h, y + s3)
        y = y + (s1 + 2 * s2 + 2 * s3 + s4) / 6
        t = t + h
    return y


def _ode_be_dae(Af, E, a, b, N, y0):
    h = (b - a) / N
    y = np.array(y0, dtype=complex)
    t = a + h
    for _ in range(N):
        y = np.linalg.solve(h * Af(t) - E, E @ y)
        t = t + h
    return y


class PeriodicDDE_NEP(NEP):
    """x'(t) = A(t) x(t) + B(t) x(t - tau) with tau-periodic A, B."""

    def _out(self, Y):
        return torch.as_tensor(np.ascontiguousarray(Y), dtype=torch.complex128,
                               device=self.device)

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        return mlincomb_from_mm(self, lam, V, a, startder)

    def Mder(self, lam, der: int = 0):
        n = self.n
        if der == 0:
            Z = torch.zeros((n, n), dtype=torch.complex128, device=self.device)
            for k in range(n):
                ek = torch.zeros((n, 1), dtype=torch.float64,
                                 device=self.device)
                ek[k] = 1.0
                Z[:, k] = self.Mlincomb(lam, ek, np.ones(1))
            return Z
        if der == 1:
            ee = np.sqrt(np.finfo(float).eps) / 10
            return (self.Mder(lam + ee, 0) - self.Mder(lam - ee, 0)) / (2 * ee)
        raise NotImplementedError("Higher derivatives not implemented")

    Mder_dense = Mder


class PeriodicDDE_NEP_ODE(PeriodicDDE_NEP):
    def __init__(self, A, B, tau, N=1000, device=None):
        self.A = A
        self.B = B
        self.tau = tau
        self.N = N
        self.n = np.asarray(A(0.0)).shape[0]
        self.device = resolve_device(device)

    def MM(self, S, V):
        from scipy.linalg import expm

        S = _host(S)
        V = _host(V).astype(complex)
        tau = self.tau
        if S.shape[0] == 1:
            s = complex(S[0, 0])

            def F(t, Y):
                return (np.asarray(self.A(t)) @ Y
                        + np.asarray(self.B(t)) @ Y * np.exp(-tau * s)
                        - Y * s)
        else:
            eS = expm(-tau * S)

            def F(t, Y):
                return (np.asarray(self.A(t)) @ Y
                        + np.asarray(self.B(t)) @ Y @ eS - Y @ S)
        YY = _ode_rk4(F, 0.0, float(np.real(tau)), self.N, V)
        return self._out(YY - V)


class PeriodicDDE_NEP_DAE(PeriodicDDE_NEP):
    def __init__(self, A, B, E, tau, N=1000, device=None):
        self.A = A
        self.B = B
        self.E = np.asarray(E, dtype=complex)
        self.tau = tau
        self.N = N
        self.n = np.asarray(A(0.0)).shape[0]
        self.device = resolve_device(device)

    def MM(self, S, V):
        S = _host(S)
        V = _host(V).astype(complex)
        if V.shape[1] > 1:
            raise NotImplementedError(
                "DAE compute_MM implemented for single vectors")
        s = complex(S[0, 0])

        def Af(t):
            return (np.asarray(self.A(t))
                    + np.asarray(self.B(t)) * np.exp(-self.tau * s)
                    - s * self.E)

        YY = _ode_be_dae(Af, self.E, 0.0, float(np.real(self.tau)), self.N,
                         V)
        return self._out(YY - V)


MATHIEU_EIGENVALUES = np.array([
    -0.24470143590830754,
    -0.561610418452567 - 1.511169478595549j,
    -0.561610418452567 + 1.511169478595549j,
    -1.859617846506182 - 1.261010754174415j,
    -1.859617846506182 + 1.261010754174415j,
])


def _milling_h(t):
    phi = 2 * np.pi * t
    return (t < 0.5) * (np.sin(phi) ** 2 + np.cos(phi) * np.sin(phi))


def periodic_dde_gallery(name="mathieu", n=200, N=1000, device=None):
    """The periodic delay problems ``mathieu``, ``rand0`` (MSWS-random,
    size n), ``discont``, ``milling1_be`` (DAE) and ``milling1_rk4``."""
    if name == "mathieu":
        delta, b, a, tau = 1.0, 0.5, 0.1, 2.0
        return PeriodicDDE_NEP_ODE(
            lambda t: np.array([[0.0, 1.0],
                                [-(delta + a * np.cos(np.pi * t)), -1.0]]),
            lambda t: np.array([[0.0, 0.0], [b, 0.0]]), tau, N=N,
            device=device)
    if name == "rand0":
        from .msws import MSWS_RNG

        rng = MSWS_RNG()
        I = np.eye(n)
        A0 = rng.gen_spmat(n, n, 0.3).toarray() - I
        A1 = rng.gen_spmat(n, n, 0.3).toarray() - I
        B0 = rng.gen_spmat(n, n, 0.3).toarray() - I
        B1 = rng.gen_spmat(n, n, 0.3).toarray() - I
        return PeriodicDDE_NEP_ODE(
            lambda t: A0 + np.cos(np.pi * t) * A1,
            lambda t: B0 + np.exp(0.01 * np.sin(np.pi * t)) * B1, 2.0, N=N,
            device=device)
    if name == "discont":
        delta, b, a, tau = 1.0, 0.5, 0.1, 2.0
        return PeriodicDDE_NEP_ODE(
            lambda t: (np.array([[0.0, 1.0],
                                 [-(delta + a * np.cos(np.pi * t)), -1.0]])
                       + np.eye(2) * ((t - 0.3) ** 2) * (t > 0.3)),
            lambda t: np.array([[0.0, 0.0], [b, 0.0]]), tau, N=N,
            device=device)
    A0 = np.array([[0.0, 1.0], [-1.0, -2.0]])
    E21 = np.zeros((2, 2))
    E21[1, 0] = 1.0
    if name == "milling1_be":
        return PeriodicDDE_NEP_DAE(lambda t: A0 - E21 * _milling_h(t),
                                   lambda t: E21 * _milling_h(t), np.eye(2),
                                   1.0, N=50, device=device)
    if name == "milling1_rk4":
        return PeriodicDDE_NEP_ODE(lambda t: A0 - E21 * _milling_h(t),
                                   lambda t: E21 * _milling_h(t), 1.0, N=50,
                                   device=device)
    raise ValueError(f"Unknown PeriodicDDE_NEP type: {name}")
