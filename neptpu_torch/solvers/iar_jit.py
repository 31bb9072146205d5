"""Infinite Arnoldi over padded fixed-``maxit`` buffers, in complex dtype.

The basis lives in a preallocated ``V (m+1 cols, m+1 blocks, n)`` with block
masks, so every step has the same shapes: the Mlincomb over all m+1 blocks
with zero coefficients beyond the live prefix, the shifted solve against one
LU of M(sigma), and a two-pass classical Gram-Schmidt against the whole
stacked basis (dead columns are zero).  The JAX package compiles the m steps
into one ``lax.scan``; here they are an eager loop on the device writing
into the buffers in place.  Ritz extraction happens once at the end.

``iar_jitted`` matches ``iar``'s results contract; ``iar_scan_kernel`` is
the raw (basis, Hessenberg) builder.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import real_of
from ..core.errmeasure import estimate_error
from ..core.nep import compute_Mlincomb
from .common import init_vec, setup_solver, solver_device

__all__ = ["iar_scan_kernel", "iar_jitted"]

_C = torch.complex128


def iar_scan_kernel(nep, m, sigma, gamma, v0, lu_piv):
    """Run m IAR steps; returns ``(V, H)``.

    ``V``: ``(m+1 cols, m+1 blocks, n)`` padded basis — column k holds k+1
    live n-blocks; ``H``: ``(m+1, m)`` Hessenberg, both on the device of
    ``v0``.  ``lu_piv``: the ``(lu, piv)`` of M(sigma) (``torch.linalg``
    pivots)."""
    n = v0.shape[0]
    dev = v0.device
    cdt = _C
    lu, piv = lu_piv
    lu = lu.to(cdt)
    sigma, gamma = complex(sigma), complex(gamma)
    alpha_full = np.array([gamma**j for j in range(m + 1)], dtype=complex)
    jblk = torch.arange(m + 1, device=dev)
    scale_all = 1.0 / (jblk + 1.0).to(torch.float64)

    V = torch.zeros((m + 1, m + 1, n), dtype=cdt, device=dev)
    v0 = v0.to(cdt)
    V[0, 0] = v0 / torch.linalg.vector_norm(v0)
    H = torch.zeros((m + 1, m), dtype=cdt, device=dev)
    Vmat = V.reshape(m + 1, -1)  # columns as rows: (m+1, n(m+1))
    for k in range(1, m + 1):
        # y blocks: y[j+1] = V[k-1 col][j] / (j+1) for j < k
        prev = V[k - 1]
        scale = torch.where(jblk < k, scale_all,
                            torch.zeros((), dtype=torch.float64,
                                        device=dev)).to(cdt)
        y = torch.roll(prev * scale[:, None], 1, dims=0)  # blocks 1..k live
        # masked Mlincomb coefficients: alpha[j] for 1 <= j <= k, else 0
        a = np.where((np.arange(m + 1) >= 1) & (np.arange(m + 1) <= k),
                     alpha_full, 0.0)
        z = compute_Mlincomb(nep, sigma, y.T, a).to(cdt)
        y[0] = -torch.linalg.lu_solve(lu, piv, z[:, None])[:, 0]

        # DGKS (two-pass CGS) against the stacked basis
        w = y.reshape(-1)
        h1 = Vmat.conj() @ w
        w = w - Vmat.T @ h1
        h2 = Vmat.conj() @ w
        w = w - Vmat.T @ h2
        h = h1 + h2
        beta = torch.linalg.vector_norm(w)
        V[k] = (w / beta).reshape(m + 1, n)
        H[:, k - 1] = torch.where(jblk == k, beta.to(cdt), h)
    return V, H


def iar_jitted(nep, dtype=None, maxit=30, linsolvercreator=None, tol=None,
               neigs=6, errmeasure=None, sigma=0.0, gamma=1.0, v=None,
               logger=0, device=None):
    """IAR with the padded-buffer step loop + Ritz extraction at the end.
    Same contract as ``iar`` (without projected extraction): returns
    ``(lams, Q, V)`` — the converged eigenvalues (numpy), their vectors and
    the padded basis (tensors on the device)."""
    from ..ops.linsolve import create_linsolver

    device = solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    if tol is None:
        tol = 10000 * float(torch.finfo(
            torch.promote_types(real_of(dtype), torch.float32)).eps)
    n = nep.n
    m = maxit
    sigma_c = complex(sigma)
    # one cached factorization of M(sigma) drives all steps
    solver = create_linsolver(linsolvercreator, nep, sigma_c)
    lu_piv = (solver.lu, solver.piv)
    v0 = init_vec(v, n, dtype, device=device).to(_C)

    V, H = iar_scan_kernel(nep, m, sigma_c, complex(gamma), v0, lu_piv)
    Hh = H.cpu().numpy()
    D, Z = np.linalg.eig(Hh[:m, :m])
    lams = sigma_c + complex(gamma) / D
    Q = V[:, 0, :].T[:, :m] @ torch.as_tensor(Z, device=device)
    errs = np.array([float(estimate_error(em, lams[s], Q[:, s]))
                     for s in range(len(lams))])
    idx = np.argsort(errs)
    nconv = int(np.sum(errs < tol))
    take = idx[: min(neigs, max(nconv, 0))]
    return (lams[take], Q[:, torch.as_tensor(take, device=device)], V)
