"""Broyden's method with deflation (Jarlebring 2019), written against the
compute protocol: rank-1 updates of an inverse-Jacobian approximation of
the bordered deflated system, step-length thresholding, conjugate-pair
auto-add, and an eig or inverse-power restart eigensolver.  Returns an
invariant pair (S, X).

The n x n inverse approximation ``T``, the bordered restart matrix and every
n-vector live on the solver's device; the restart's dense ``eig`` of the
(n + k)^2 bordered matrix runs in numpy on the host, as in the JAX package
(LAPACK either way); the invariant pair's S and the eigenvalue iterate are
host numpy."""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.logger import parse_logger
from ..core.nep import compute_Mder, compute_Mlincomb
from .common import solver_device

__all__ = ["broyden"]

_C = torch.complex128


def broyden_default_errmeasure(lam, v, r):
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(v))


def _mlin(nep, lam, v):
    return compute_Mlincomb(nep, complex(lam), v).to(_C)


def _broyden_T(nep, v1, u1, lam1, CH, T1, W1, S, X, maxit, check_error_every,
               threshold, tol, errmeasure, lg):
    """The inner Broyden iteration ("version T" of the paper)."""
    v, u, lam = v1, u1, complex(lam1)
    p = S.shape[0]
    II = np.eye(p, dtype=complex)
    dev = v.device

    def vv_of(v, u, lam):
        if p == 0:
            return v
        w = np.linalg.solve(lam * II - S, u.cpu().numpy())
        return v + X @ torch.as_tensor(w, device=dev)

    rk = _mlin(nep, lam, vv_of(v, u, lam))
    T, W = T1, W1
    errhist = []
    Z = T @ W
    for j in range(1, maxit + 1):
        Trk = T @ rk
        dulam = -torch.linalg.solve(CH @ Z, CH @ Trk)
        du = dulam[:p]
        dlam = complex(dulam[-1])
        dv = -Z @ dulam - Trk
        gamma = 1.0
        ndv = float(torch.linalg.vector_norm(dv))
        tt = float(np.sqrt(abs(dlam) ** 2 + ndv ** 2))
        if tt > threshold:
            gamma = threshold / tt
        v = v + gamma * dv
        u = u + gamma * du
        lam = lam + gamma * dlam
        rkp = _mlin(nep, lam, vv_of(v, u, lam))
        ztilde = (rkp - (1 - gamma) * rk) / gamma
        Tztilde = T @ ztilde
        denom = (ndv ** 2 + float(torch.linalg.vector_norm(du)) ** 2
                 + abs(dlam) ** 2)
        bH = torch.cat([du.conj(), torch.tensor([np.conj(dlam)], dtype=_C,
                                                device=dev)])[None, :] / denom
        beta = denom + dv.conj() @ Tztilde
        aH = -(dv.conj() @ T)[None, :] / beta
        Z = Z + Tztilde[:, None] @ (aH @ W + (1 + (aH @ ztilde)[0]) * bH)
        W = W + ztilde[:, None] @ bH
        T = T + Tztilde[:, None] @ aH
        rk = rkp
        if j % check_error_every == 0:
            err = errmeasure(lam, vv_of(v, u, lam), rk)
            errhist.append(err)
            lg.iteration(j, errs=err, lams=lam)
            if err < tol:
                return lam, v, u, T, W, j, errhist
    lg.info("Too many iterations")
    return lam, v, u, T, W, maxit, errhist


def _eigs_invpow(MM, maxit=10, sigma=0.0):
    """The inverse power method as restart eigensolver: ``(lam[1],
    z (N, 1))``."""
    A = MM - sigma * torch.eye(MM.shape[0], dtype=MM.dtype, device=MM.device)
    lu, piv = torch.linalg.lu_factor(A)
    z = torch.ones((MM.shape[0], 1), dtype=MM.dtype, device=MM.device)
    for _ in range(maxit):
        z = torch.linalg.lu_solve(lu, piv, z)
        z = z / torch.linalg.vector_norm(z)
    lam = (z[:, 0].conj() @ (MM @ z[:, 0]))
    return lam.reshape(1), z


def broyden(nep, dtype=None, approxnep=":eye", sigma=0.0, pmax=3, c=None,
            maxit=1000, addconj=False, check_error_every=10,
            print_error_every=1, threshold=0.2, tol=1e-12, errmeasure=None,
            eigmethod=":eig", logger=0, recompute_U=False, inner_logger=0,
            device=None):
    """Returns the invariant pair ``(S, X)``: ``S (p, p)`` host numpy, ``X
    (n, p)`` a tensor on the device.  ``approxnep``: the start of the
    inverse-Jacobian approximation - ``":eye"``, an array, or a problem whose
    ``M(sigma)`` is taken; ``eigmethod``: ``":eig"`` (dense eig of the
    bordered matrix) or ``":invpow"``.  ``device=None`` is the card."""
    device = solver_device(nep, device)
    lg = parse_logger(logger)
    ilg = parse_logger(inner_logger)
    if errmeasure is None:
        errmeasure = broyden_default_errmeasure
    n = nep.n
    if pmax > n:
        warnings.warn("Too many eigenvalues requested. Reducing")
        pmax = n
    sigma = complex(sigma)
    c = np.ones(n, dtype=complex) if c is None else np.asarray(c, complex)
    c = torch.as_tensor(c, device=device)

    if isinstance(approxnep, (np.ndarray, torch.Tensor)):
        M1 = torch.as_tensor(approxnep, device=device).to(_C)
    elif isinstance(approxnep, str) and approxnep == ":eye":
        M1 = torch.eye(n, dtype=_C, device=device)
    else:
        M = compute_Mder(approxnep, sigma)
        M1 = (M if isinstance(M, torch.Tensor) else M.to_dense()).to(
            device=device, dtype=_C)
    T1 = torch.linalg.inv(M1)

    X = torch.zeros((n, 0), dtype=_C, device=device)
    S = np.zeros((0, 0), dtype=complex)
    UU = torch.eye(n, pmax + 1, dtype=_C, device=device)
    k = 1
    all_errhist = []
    while k <= pmax:
        km1 = k - 1
        U1 = UU[:, :km1].clone()
        for i in range(km1):
            ei = np.zeros(km1)
            ei[i] = 1.0
            f = np.linalg.solve(sigma * np.eye(km1) - S, ei)
            U1[:, i] = _mlin(nep, sigma, X @ torch.as_tensor(f, device=device))

        MM = torch.cat([torch.cat([M1, U1], dim=1),
                        torch.cat([X.conj().T, torch.zeros(
                            (km1, km1), dtype=_C, device=device)], dim=1)])
        lg.info("running eigval comp for deflation")
        if eigmethod == ":eig":
            # numpy's LAPACK, as the reference calls it: a conjugate pair of
            # the bordered matrix ties in |d|, and the pick must be the same
            d, V = (torch.from_numpy(a).to(device)
                    for a in np.linalg.eig(MM.cpu().numpy()))
        elif eigmethod == ":invpow":
            d, V = _eigs_invpow(MM, maxit=4000, sigma=0.0)
        else:
            raise ValueError(f"Unknown eig method {eigmethod}")
        x = V[:, int(torch.argmin(torch.abs(d)))].to(_C)

        v0 = x[:n]
        u0 = x[n:]
        h = X.conj().T @ v0
        v0 = v0 - X @ h
        u0 = u0 + torch.as_tensor(sigma * np.eye(km1) - S,
                                  device=device) @ h
        CH = torch.cat([X.conj().T, c.conj()[None, :]])
        scale = c.conj() @ v0
        u0 = u0 / scale
        v0 = v0 / scale

        d_fd = np.sqrt(np.finfo(float).eps)
        lg.info("Computing initial matrix")
        f1 = (_mlin(nep, sigma + d_fd, v0)
              - _mlin(nep, sigma - d_fd, v0)) / (2 * d_fd)
        if km1:
            f1 = f1 - U1 @ torch.as_tensor(np.linalg.solve(
                sigma * np.eye(km1) - S, u0.cpu().numpy()), device=device)
        W1 = torch.cat([U1, f1[:, None]], dim=1)

        lg.info(f"Starting broyden n={n}")
        lam_m, vm, um, Tm, Wm, itr, errhist = _broyden_T(
            nep, v0, u0, sigma, CH, T1, W1, S, X, maxit, check_error_every,
            threshold, tol, errmeasure, ilg)
        all_errhist += list(errhist)
        nv = torch.linalg.vector_norm(vm)
        um = um / nv
        vm = vm / nv
        lg.info(f"Found an eigval {k}:{lam_m}")
        X = torch.cat([X, vm[:, None]], dim=1)
        Snew = np.zeros((k, k), dtype=complex)
        Snew[:km1, :km1] = S
        Snew[:km1, km1] = um.cpu().numpy()
        Snew[km1, km1] = lam_m
        S = Snew

        if abs(lam_m.imag) > tol * 10 and addconj:
            if km1:
                w = np.linalg.solve(lam_m * np.eye(km1) - S[:km1, :km1],
                                    um.cpu().numpy())
                v1 = torch.conj(vm + X[:, :km1] @ torch.as_tensor(
                    w, device=device))
            else:
                v1 = torch.conj(vm)
            lam1c = np.conj(lam_m)
            rnorm = float(torch.linalg.vector_norm(_mlin(nep, lam1c, v1)))
            lg.info(f"Adding conjugate {k}")
            if rnorm > tol * 10:
                warnings.warn("Trying to add a conjugate pair which does not "
                              "have a very small residual.")
            h = X.conj().T @ v1
            v1t = v1 - X @ h
            beta = torch.linalg.vector_norm(v1t)
            X = torch.cat([X, (v1t / beta)[:, None]], dim=1)
            k += 1
            S1 = np.zeros((k, k), dtype=complex)
            S1[: k - 1, : k - 1] = S
            S1[k - 1, k - 1] = lam1c
            R = np.eye(k, dtype=complex)
            R[: k - 1, -1] = h.cpu().numpy()
            R[k - 1, k - 1] = complex(beta)
            S = (R @ S1) @ np.linalg.inv(R)
        k += 1
    return S, X
