"""Standalone Leja-Bagby + divided-difference expansion, used by
``NleigsCorkLinearization`` (and the setup phase of ``nleigs``).  The
divided differences come back as tensors: dense n x n on the problem's
device (the compact n x r matrix for a low-rank tail)."""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ...core.nep import compute_Mder
from .polygon import discretizepolygon
from .rknep import get_rk_nep
from .utils import lejabagby, ratnewtoncoeffs, scgendivdiffs

__all__ = ["nleigs_coefficients"]


def dense_mder(nep, L):
    """The dense ``M(lam)`` at the node ``lam`` held by the 1 x 1 ``L``."""
    M = compute_Mder(nep, complex(L.reshape(-1)[0]))
    return M if isinstance(M, torch.Tensor) else M.to_dense()


def leja_setup(Sigma, Xi, nodes, leja, maxdgr, max_count, forceInf,
               tile_count):
    """``(sigma, xi, beta, nodes)``: the interpolation nodes, poles and
    scalings of the Leja-Bagby expansion for ``leja`` 0 (the given nodes,
    repeated), 1 (Leja points on the boundary of ``Sigma``, the given or
    interior nodes kept for the shifts) or 2 (Leja points on the
    boundary); ``max_count`` nodes for modes 0 and 2, ``tile_count`` shift
    nodes for mode 1."""
    nodes = list(nodes)
    if leja == 0:
        if not nodes:
            raise ValueError("Interpolation nodes must be provided via "
                             "'nodes' when leja == 0")
        gamma, _ = discretizepolygon(Sigma)
        reps = int(np.ceil(max_count / len(nodes)))
        sigma = np.tile(np.asarray(nodes, dtype=complex), reps)
        _, xi, beta = lejabagby(sigma[: maxdgr + 2], Xi, gamma, maxdgr + 2,
                                True, forceInf)
    elif leja == 1:
        if not nodes:
            gamma, nodes = discretizepolygon(Sigma, True)
            nodes = list(nodes)
        else:
            gamma, _ = discretizepolygon(Sigma)
        reps = int(np.ceil(tile_count / len(nodes)))
        nodes = np.tile(np.asarray(nodes, dtype=complex), reps)
        sigma, xi, beta = lejabagby(gamma, Xi, gamma, maxdgr + 2, False,
                                    forceInf)
    else:
        gamma, _ = discretizepolygon(Sigma)
        sigma, xi, beta = lejabagby(gamma, Xi, gamma, max_count, False,
                                    forceInf)
    sigma = np.asarray(sigma, dtype=complex)
    xi = np.asarray(xi, dtype=complex)
    beta = np.asarray(beta, dtype=float)
    if len(xi) > maxdgr + 1:
        xi[maxdgr + 1] = np.nan
    return sigma, xi, beta, nodes


def _fro(D):
    return float(torch.linalg.norm(D)) if isinstance(D, torch.Tensor) \
        else float(np.linalg.norm(D))


def nleigs_coefficients(nep, Sigma, Xi=(np.inf,), maxdgr=100, maxit=200,
                        tollin=None, isfunm=True, leja=1, nodes=(),
                        logger=None):
    if tollin is None:
        tollin = 100 * np.finfo(float).eps
    P = get_rk_nep(nep)
    n = nep.n
    if n == 1:
        maxdgr = maxit + 1
    Xi = np.asarray(Xi, dtype=float)
    forceInf = max(P.p, 0)
    sigma, xi, beta, _ = leja_setup(Sigma, Xi, nodes, leja, maxdgr,
                                    max(maxit, maxdgr) + 2, forceInf,
                                    maxit + 1)

    rng = slice(0, maxdgr + 2)
    if not P.spmf:
        D = ratnewtoncoeffs(lambda L: dense_mder(nep, L), sigma[rng],
                            xi[rng], beta[rng])
        nrmD = [_fro(D[0])]
        sgdd = None
    else:
        sgdd = scgendivdiffs(sigma[rng], xi[rng], beta[rng], maxdgr, isfunm,
                             nep.get_fv())
        D = [P.construct_D(0, sgdd)]
        nrmD = [float(np.max(np.abs(sgdd[:, 0])))]
    if not np.isfinite(nrmD[0]):
        raise ValueError("The generalized divided differences must be finite.")

    expand = True
    N = 0
    k = 1
    while k <= maxit and expand:
        if P.spmf:
            D.append(P.construct_D(k, sgdd))
            nrmD.append(float(np.max(np.abs(sgdd[:, k]))))
        else:
            if k >= len(D):
                break
            nrmD.append(_fro(D[k]))
        if not np.isfinite(nrmD[k]):
            raise ValueError(
                "The generalized divided differences must be finite.")
        N += 1
        if n > 1 and k >= 5:
            # freeze once five consecutive divided-difference norms are tiny
            if sum(nrmD[k - 4: k + 1]) < 5 * tollin:
                expand = False
                D = D[:k]
                xi = xi[:k]
                beta = beta[:k]
                nrmD = nrmD[:k]
            elif k == maxdgr + 1:
                expand = False
                warnings.warn(f"NLEIGS: Linearization not converged after "
                              f"{maxdgr} iterations")
        k += 1

    return D, beta, xi, sigma
