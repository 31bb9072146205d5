"""Contour-integral solvers: Beyn's method and the Asakura-Sakurai block-SS
method.

The quadrature loop is a **batched shifted solve**: for a chunk of nodes the
dense ``M(sigma + g(t_i))`` are assembled into one stacked tensor on the
problem's device, LU-factored as a stack (``batched_lu_factor``) and solved
against the block right-hand side; the moments
``A_j = h/(2 pi i) sum_i Y_i g'(t_i) g(t_i)^j`` are one ``torch.einsum``
over the node axis.  A problem without a dense ``Mder`` (or a caller that
asks for an ``integrator``) takes the per-node loop through the
linear-solver layer instead; nothing else falls back, so a device error in
the batched path reaches the caller.  ``contour_beyn(mesh=...)`` splits the
nodes over the ranks of a mesh (``parallel/quadrature.py``).

The pluggable ``MatrixIntegrator`` protocol is kept
(``integrate_interval(integrator, dtype, f, gv, a, b, N, logger)``).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.errmeasure import estimate_error
from ..models.spmf import AbstractSPMF
from ..ops import lapack
from ..ops.linsolve import (BackslashLinSolverCreator, batched_lu_factor,
                            batched_lu_solve, create_linsolver, lin_solve)
from .common import setup_solver, solver_device

__all__ = [
    "MatrixIntegrator",
    "MatrixTrapezoidal",
    "MatrixGaussLegendre",
    "integrate_interval",
    "batched_shifted_solves",
    "contour_moment_weights",
    "contour_beyn",
    "contour_block_SS",
    "BATCHED_LU",
]

# stacked LUs of the batched shifted solves since the last reset: chunks
# factored and the nodes in them
BATCHED_LU = {"chunks": 0, "nodes": 0}


class MatrixIntegrator:
    pass


class MatrixTrapezoidal(MatrixIntegrator):
    """Trapezoidal rule, generic-callback form."""


class MatrixGaussLegendre(MatrixIntegrator):
    """Gauss-Legendre quadrature on [a, b]."""


def integrate_interval(integrator, dtype, f, gv, a, b, N, logger=None):
    """``I[..., j] ~ int_a^b f(x) g_j(x) dx`` with N nodes; ``f`` returns a
    numpy array or a tensor, and ``I`` is of the same kind."""
    if (integrator is None or integrator is MatrixTrapezoidal
            or isinstance(integrator, MatrixTrapezoidal)):
        h = (b - a) / N
        t = a + h * np.arange(N)
        w = np.full(N, h)
    elif (integrator is MatrixGaussLegendre
          or isinstance(integrator, MatrixGaussLegendre)):
        x, wq = np.polynomial.legendre.leggauss(N)
        t = (b - a) / 2 * x + (a + b) / 2
        w = (b - a) / 2 * wq
    else:
        raise ValueError(f"unknown integrator {integrator}")
    m = len(gv)
    G = np.zeros((N, m), dtype=complex)
    for j, g in enumerate(gv):
        G[:, j] = np.array([complex(g(ti)) for ti in t])
    S = None
    for i in range(N):
        temp = f(t[i])
        if S is None:
            if isinstance(temp, torch.Tensor):
                S = torch.zeros(tuple(temp.shape) + (m,),
                                dtype=torch.complex128, device=temp.device)
            else:
                temp = np.asarray(temp)
                S = np.zeros(temp.shape + (m,), dtype=complex)
        for j in range(m):
            S[..., j] += temp * complex(G[i, j] * w[i])
    return S


def _dense(M):
    return M if isinstance(M, torch.Tensor) else M.to_dense()


def batched_shifted_solves(nep, shifts, Vh, chunk: int = 32):
    """``Y[i] = M(shifts[i])^{-1} Vh`` for a batch of shifts, as a tensor
    ``(len(shifts), n, k)`` on the device of ``Vh``.

    Per chunk of ``chunk`` nodes: the dense ``M(shift)`` assembled into one
    stacked tensor, one stacked LU, one stacked solve.  Device memory peaks
    near ``2 * chunk`` dense n x n matrices (the stack and its LU) plus one
    node's assembly."""
    shifts = np.asarray(shifts, dtype=complex).ravel()
    cdt = torch.complex128
    Vh = torch.as_tensor(Vh).to(cdt)
    n, k = Vh.shape
    Y = torch.empty((len(shifts), n, k), dtype=cdt, device=Vh.device)
    for s in range(0, len(shifts), chunk):
        lams = shifts[s: s + chunk]
        Ms = torch.empty((len(lams), n, n), dtype=cdt, device=Vh.device)
        for i, lam in enumerate(lams):
            Ms[i] = _dense(nep.Mder_dense(complex(lam)))
        lu_piv = batched_lu_factor(Ms)
        del Ms
        Y[s: s + len(lams)] = batched_lu_solve(
            lu_piv, Vh.expand(len(lams), n, k))
        del lu_piv
        BATCHED_LU["chunks"] += 1
        BATCHED_LU["nodes"] += len(lams)
    return Y


def contour_moment_weights(radius, N, n_moments):
    """The ellipse's nodes ``g(t_i)`` and the moment weights
    ``w[j, i] = h/(2 pi i) g'(t_i) g(t_i)^j`` of the trapezoid rule."""
    r1, r2 = radius
    h = 2 * np.pi / N
    t = h * np.arange(N)
    gs = r1 * np.cos(t) + 1j * r2 * np.sin(t)
    gps = -r1 * np.sin(t) + 1j * r2 * np.cos(t)
    gj = np.stack([gs**j for j in range(n_moments)])
    return gs, gj * gps[None, :] * (h / (2j * np.pi))


def _contour_moments(nep, sigma, radius, Vh, N, n_moments, linsolvercreator,
                     integrator, logger, chunk=32):
    """Moments ``A_j = 1/(2 pi i) int T(g(t)) g'(t) g(t)^j dt``,
    j = 0..n_moments-1, as tensors on the device of ``Vh``."""
    r1, r2 = radius
    if (integrator is None and isinstance(nep, AbstractSPMF)
            and hasattr(nep, "Mder_dense")):
        gs, wts = contour_moment_weights(radius, N, n_moments)
        Y = batched_shifted_solves(nep, sigma + gs, Vh, chunk)
        A = torch.einsum("mN,Nnk->mnk",
                         torch.as_tensor(wts, device=Y.device), Y)
        return [A[j] for j in range(n_moments)]

    def f(tt):
        lam = complex(r1 * np.cos(tt) + 1j * r2 * np.sin(tt))
        solver = create_linsolver(linsolvercreator, nep, lam + sigma)
        return lin_solve(solver, Vh).to(torch.complex128) * complex(
            -r1 * np.sin(tt) + 1j * r2 * np.cos(tt))

    gv = [(lambda s, j=j: (complex(r1 * np.cos(s) + 1j * r2 * np.sin(s)))
           ** j) for j in range(n_moments)]
    S = integrate_interval(integrator, complex, f, gv, 0, 2 * np.pi, N,
                           logger)
    return [S[..., j] / (2j * np.pi) for j in range(n_moments)]


def contour_beyn(nep, dtype=None, integrator=None, tol=None, sigma=0.0,
                 logger=0, linsolvercreator=None, neigs=2, k=None, radius=1.0,
                 N=1000, errmeasure=None, sanity_check=True,
                 rank_drop_tol=None, chunk=32, mesh=None, mesh_axis="nodes",
                 device=None):
    """Beyn's contour integral method.  Returns ``(lam, V)``: eigenvalues
    (numpy) and eigenvectors (a tensor on the device).  ``chunk``: nodes
    per stacked LU (each node a dense n x n matrix on the device).

    ``mesh``: a :class:`neptpu_torch.parallel.Mesh` - the quadrature nodes
    are then split over its ``mesh_axis`` (every rank solves its own nodes,
    the moments are reduced with one psum); every rank calls this with the
    same arguments and gets the same result, on ``mesh.device``."""
    if mesh is not None:
        device = mesh.device
    device = solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    if tol is None:
        tol = float(np.sqrt(np.finfo(np.float64).eps))
    if rank_drop_tol is None:
        rank_drop_tol = tol
    if k is None:
        if neigs == np.inf:
            raise ValueError("k must be set when neigs=inf")
        k = int(neigs) + 1
    n = nep.n
    if k > n:
        raise ValueError(f"cannot compute more eigenvalues than size of NEP: "
                         f"k={k} n={n}")
    if k <= 0:
        raise ValueError(f"k must be positive, k={k}")
    radius = (radius, radius) if np.isscalar(radius) else tuple(radius)
    sigma = complex(sigma)
    if linsolvercreator is None:
        linsolvercreator = BackslashLinSolverCreator()

    rng = np.random.default_rng(10)
    Vh = torch.as_tensor(rng.standard_normal((n, k)),
                         device=device).to(torch.complex128)

    lg.info("Computing integrals")
    if mesh is not None:
        from ..parallel.quadrature import sharded_contour_moments

        A0, A1 = sharded_contour_moments(nep, sigma, radius, Vh, N, 2, mesh,
                                         axis=mesh_axis, chunk=chunk)
    else:
        A0, A1 = _contour_moments(nep, sigma, radius, Vh, N, 2,
                                  linsolvercreator, integrator, lg, chunk)

    lg.info("Computing SVD prepare for eigenvalue extraction")
    V, S, Wh = torch.linalg.svd(A0, full_matrices=False)
    S = S.cpu().numpy()
    p = int(np.sum(S / S[0] > rank_drop_tol))
    lg.info(f" p={p}")
    V0 = V[:, :p]
    W0 = Wh.conj().T[:, :p]
    B = (V0.conj().T @ A1 @ W0) * torch.as_tensor(
        1.0 / S[:p], device=A0.device)[None, :]

    lg.info("Computing eigenvalues")
    lam, VB = lapack.eig(B.cpu())
    lam = lam.numpy() + sigma
    V = V0 @ VB.to(V0.device)
    V = V / torch.linalg.vector_norm(V, dim=0, keepdim=True)

    def inside(l):
        return ((np.real(l - sigma) / radius[0]) ** 2
                + (np.imag(l - sigma) / radius[1]) ** 2 <= 1)

    def take(idx):
        return lam[idx], V[:, torch.as_tensor(idx, device=V.device)]

    if not sanity_check:
        order = np.argsort(np.abs(sigma - lam))
        ins = inside(lam[order])
        return take(order[np.argsort(~ins, kind="stable")])

    errs = np.array([float(estimate_error(em, lam[i], V[:, i]))
                     for i in range(p)])
    good = np.flatnonzero(errs < tol)
    good = good[np.argsort(np.abs(sigma - lam[good]))]
    ins = inside(lam[good])
    if np.any(~ins):
        warnings.warn(
            f"found {int(np.sum(~ins))} evals outside contour, {p} inside. "
            "try increasing N, decreasing tol, or changing radius")
    good = good[np.argsort(~ins, kind="stable")]
    if len(good) > neigs:
        lg.info(f"Removing unwanted eigvals: neigs={neigs}<{len(good)}="
                "found_eigvals")
        good = good[: int(neigs)]
    if p == k:
        warnings.warn(
            "Rank-drop not detected, your eigvals may be correct, but the "
            "algorithm cannot verify. Try to increase k.")
    if len(good) < neigs and neigs != np.inf:
        warnings.warn("We found fewer eigvals than requested. Try increasing "
                      "domain, or decreasing tol.")
    return take(good)


def contour_block_SS(nep, dtype=None, integrator=None, tol=None, sigma=0.0,
                     logger=0, linsolvercreator=None, neigs=np.inf, k=3,
                     radius=1.0, N=1000, K=3, errmeasure=None,
                     sanity_check=True, Shat_mode=":native",
                     rank_drop_tol=None, chunk=32, device=None):
    """Asakura-Sakurai block-SS with 2K moments and the block-Hankel pencil.
    Returns ``(lam, V)``: eigenvalues (numpy) and eigenvectors (a tensor on
    the device)."""
    device = solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    if tol is None:
        tol = float(np.sqrt(np.finfo(np.float64).eps))
    if rank_drop_tol is None:
        rank_drop_tol = tol
    n = nep.n
    L = k
    sigma = complex(sigma)
    radius = (radius, radius) if np.isscalar(radius) else tuple(radius)
    if linsolvercreator is None:
        linsolvercreator = BackslashLinSolverCreator()
    rng = np.random.default_rng(10)
    U = torch.as_tensor(rng.random((n, L)) + 0j, device=device)
    Vblk = torch.as_tensor(rng.random((n, L)), device=device).to(
        torch.complex128)

    lg.info("Computing integrals; forming Mhat and Shat")
    if Shat_mode == ":JSIAM":
        if radius[0] != radius[1]:
            raise ValueError("JSIAM Shat_mode does not support ellipses")
        r = radius[0]
        omega = r * np.exp(2j * np.pi * (0.5 + np.arange(N)) / N)
        Y = batched_shifted_solves(nep, sigma + omega, Vblk, chunk)
        d = torch.as_tensor(np.stack([(omega / r) ** (kk + 1) / N
                                      for kk in range(2 * K)]),
                            device=Y.device)
        Shat = list(torch.einsum("mN,Nnk->mnk", d, Y))
        factor = r
    else:
        Shat = _contour_moments(nep, sigma, radius, Vblk, N, 2 * K,
                                linsolvercreator, integrator, lg, chunk)
        factor = 1.0
    Mhat = [(U.conj().T @ S).cpu().numpy() for S in Shat]

    lg.info("Computing Hhat and Hhat^<")
    m = K * L
    Hhat = np.zeros((m, m), dtype=complex)
    Hhat2 = np.zeros((m, m), dtype=complex)
    for i in range(K):
        for j in range(K):
            Hhat[i * L: (i + 1) * L, j * L: (j + 1) * L] = Mhat[i + j]
            Hhat2[i * L: (i + 1) * L, j * L: (j + 1) * L] = Mhat[i + j + 1]

    UU, SS, VVh = np.linalg.svd(Hhat)
    VV = VVh.conj().T
    mprime = int(np.sum(SS / SS[0] > rank_drop_tol))
    lg.info(f" mprime={mprime}")
    UU1 = UU[:, :mprime]
    VV1 = VV[:, :mprime]
    H1 = UU1.conj().T @ Hhat @ VV1
    H2 = UU1.conj().T @ Hhat2 @ VV1
    xi, X = lapack.geig(H2, H1)
    xi = xi.numpy()
    Smat = torch.cat(list(Shat[:K]), dim=1)
    V = Smat @ torch.as_tensor(VV1 @ X.numpy(), device=Smat.device)
    lam = sigma + factor * xi
    return lam, V
