"""NLEIGS: fully rational Krylov with dynamic Leja-Bagby interpolation
(Guettel, Van Beeumen, Meerbergen, Michiels 2014).

Phase 1 expands the rational-Newton linearization degree, monitoring the
divided-difference norms and freezing once they fall below ``tollin``.  The
Krylov iteration applies the shifted linearization inverse through
structured block recurrences: ONE solve per iteration at the current shift
(a dense LU on the device by default, kept per shift by ``LinSolverCache``)
and, for an SPMF above n = 400, the divided differences applied
matrix-free: each ``D_j x`` is one fused apply per term bank
(``RKNEP.apply_weighted``; the DIA SpMV kernel on the card).

The Krylov basis ``V`` (blocks of the linearization, complex128) and its
recurrences live on the problem's device; the pencil ``(K, H)``, the
divided-difference table and the Ritz extraction's small eigenproblem live on
the host.  Low-rank tails (``SPMFSumNEP(PEP, LowRankFactorizedNEP)``) shrink
the tail blocks from n to r in both the basis and the structured solves.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.errmeasure import (ResidualErrmeasure, estimate_error,
                               make_errmeasure)
from ..ops import lapack
from ..ops.orth import DGKS, orthogonalize_and_normalize
from .common import setup_solver, solver_device
from .rk.cache import LinSolverCache
from .rk.nleigs_coefficients import dense_mder, leja_setup
from .rk.polygon import inpolygon
from .rk.rknep import get_rk_nep
from .rk.utils import ratnewtoncoeffs, scgendivdiffs

__all__ = ["nleigs", "NleigsSolutionDetails", "in_Sigma"]


class NleigsSolutionDetails:
    def __init__(self, Lam=None, Res=None, sigma=None, xi=None, beta=None,
                 nrmD=None, kconv=0):
        self.Lam = Lam
        self.Res = Res
        self.sigma = sigma
        self.xi = xi
        self.beta = beta
        self.nrmD = nrmD
        self.kconv = kconv


def in_Sigma(z, Sigma, tol):
    Sigma = np.asarray(Sigma, dtype=complex)
    if len(Sigma) == 2 and np.isreal(Sigma).all():
        realS = np.array([Sigma[0].real, Sigma[0].real, Sigma[1].real,
                          Sigma[1].real])
        imagS = np.array([-tol, tol, tol, -tol])
    else:
        realS = Sigma.real
        imagS = Sigma.imag
    return np.array([inpolygon(p.real, p.imag, realS, imagS)
                     for p in np.atleast_1d(z)])


def _resize(A, rows, cols):
    if isinstance(A, torch.Tensor):
        out = torch.zeros((rows, cols), dtype=A.dtype, device=A.device)
    else:
        out = np.zeros((rows, cols), dtype=A.dtype)
    r, c = min(rows, A.shape[0]), min(cols, A.shape[1])
    out[:r, :c] = A[:r, :c]
    return out


def nleigs(nep, Sigma=(-1.0 - 1j, -1.0 + 1j, 1.0 + 1j, 1.0 - 1j), dtype=None,
           Xi=(np.inf,), logger=0, maxdgr=100, minit=20, maxit=200,
           linsolvercreator=None, tol=1e-10, tollin=None, v=None,
           errmeasure=None, isfunm=True, static=False, leja=1, nodes=(),
           reusefact=1, blksize=20, return_details=False, check_error_every=5,
           computeD=None, stats=None, device=None):
    """Returns ``(lam, X, res, details)``: the converged eigenvalues and
    their errors (numpy), the eigenvectors (a tensor on the device) and a
    :class:`NleigsSolutionDetails` (filled when ``return_details``).

    ``stats``: an optional dict that receives the run's counts
    (``iterations``, ``kconv``, ``degree``, ``factorizations``,
    ``D_applies``).  The
    default ``errmeasure`` is the absolute residual ``||M(lam) x||`` of a
    unit x; ``StandardSPMFErrmeasure`` is the backward error."""
    device = solver_device(nep, device)
    _, _, lg = setup_solver(nep, dtype, None, logger)
    if errmeasure is None:
        em = ResidualErrmeasure(nep)
    else:
        em = make_errmeasure(errmeasure, nep)
    if tollin is None:
        tollin = max(tol / 10, 100 * np.finfo(float).eps)
    Sigma = list(Sigma)
    Xi = np.asarray(Xi, dtype=float)
    P = get_rk_nep(nep)
    n = nep.n
    cdt = torch.complex128
    if n == 1:
        maxdgr = maxit + 1
    # explicit D matrices for small problems, matrix-free above; a low-rank
    # tail is applied through the compacted LL and scalar weights
    if computeD is None:
        computeD = n <= 400
    lr = P.is_low_rank
    p_lr = P.p if lr else None
    r_lr = P.r if lr else None
    UUc = P.UU.conj().T.to(cdt) if lr else None
    b = blksize
    cache = LinSolverCache(nep, linsolvercreator)
    rng0 = np.random.default_rng(0)
    if v is None:
        v = rng0.standard_normal(n)
    if isinstance(v, torch.Tensor):
        v = v.to(device=device, dtype=cdt)
    else:
        v = torch.as_tensor(np.asarray(v, dtype=complex), device=device)

    if static:
        V = torch.zeros((n, 1), dtype=cdt, device=device)
    else:
        V = torch.zeros(((b + 1) * n, b + 1), dtype=cdt, device=device)
    H = np.zeros((b + 1, b), dtype=complex)
    K = np.zeros((b + 1, b), dtype=complex)
    Lam = np.zeros((b, b), dtype=complex)
    Res = np.zeros((b, b), dtype=float)

    forceInf = max(P.p, 0)
    max_count = maxit + maxdgr + 2 if static else max(maxit, maxdgr) + 2
    sigma, xi, beta, nodes = leja_setup(Sigma, Xi, nodes, leja, maxdgr,
                                        max_count, forceInf, maxit + 1)

    rng = slice(0, maxdgr + 2)
    D = []
    if not P.spmf:
        D = ratnewtoncoeffs(lambda L: dense_mder(nep, L).to(cdt),
                            sigma[rng], xi[rng], beta[rng])
        nrmD = [float(torch.linalg.norm(D[0]))]
        sgdd = None
    else:
        sgdd = scgendivdiffs(sigma[rng], xi[rng], beta[rng], maxdgr, isfunm,
                             nep.get_fv())
        if computeD:
            D = [P.construct_D(0, sgdd).to(cdt)]
        nrmD = [float(np.max(np.abs(sgdd[:, 0])))]
    if not np.isfinite(nrmD[0]):
        raise ValueError("The generalized divided differences must be finite.")

    n_D = [0]

    # -- structured application of the shifted linearization inverse --------
    def blk(j):
        """Block j: blocks 0..p-1 are n long; the low-rank tail blocks
        (j >= p) are r long."""
        if not lr or j < p_lr:
            return slice(j * n, (j + 1) * n)
        start = p_lr * n + (j - p_lr) * r_lr
        return slice(start, start + r_lr)

    def apply_D(ii, x):
        """``D_ii @ x``: explicit when computeD, else matrix-free - the
        weighted term sum for a full block, the compacted LL for an r-sized
        tail block."""
        n_D[0] += 1
        if (not P.spmf) or computeD:
            return D[ii] @ x
        if lr and ii > p_lr:
            return P.apply_tail(sgdd, ii, x)
        return P.apply_weighted(sgdd[:, ii], x)

    def backslash(wc, k, N):
        shift = sigma[k]
        Bw = torch.zeros_like(wc)
        if lr and N >= p_lr and len(nrmD) > p_lr:
            # the low-rank head term of the first block, once the tail
            # blocks exist (N >= p)
            Bw[blk(0)] = -apply_D(p_lr, wc[blk(p_lr - 1)]) / beta[p_lr]
        for ii in range(1, N + 1):
            fac = 0.0 if np.isinf(xi[ii - 1]) else beta[ii] / xi[ii - 1]
            if lr and ii == p_lr:
                Bw[blk(ii)] = UUc @ wc[blk(ii - 1)] + fac * wc[blk(ii)]
            else:
                Bw[blk(ii)] = wc[blk(ii - 1)] + fac * wc[blk(ii)]
        z = Bw.clone()
        nu = beta[1] * (1 - shift / xi[0]) if not np.isinf(xi[0]) else beta[1]
        z[blk(1)] = z[blk(1)] / nu
        for ii in range(1, N + 1):
            if not (lr and ii == p_lr):
                z[blk(0)] -= apply_D(ii, z[blk(ii)])
            if ii < N:
                mu = shift - sigma[ii]
                nu = (beta[ii + 1] * (1 - shift / xi[ii])
                      if not np.isinf(xi[ii]) else beta[ii + 1])
                if lr and ii == p_lr - 1:
                    z[blk(ii + 1)] = (z[blk(ii + 1)] / nu
                                      + (mu / nu) * (UUc @ z[blk(ii)]))
                else:
                    z[blk(ii + 1)] = (z[blk(ii + 1)] / nu
                                      + (mu / nu) * z[blk(ii)])
        w = torch.zeros_like(wc)
        add = ((not expand or k > kconv) and reusefact == 1) or reusefact == 2
        w[blk(0)] = cache.solve(shift, z[blk(0)] / beta[0], add).to(cdt)
        for ii in range(1, N + 1):
            mu = shift - sigma[ii - 1]
            nu = (beta[ii] * (1 - shift / xi[ii - 1])
                  if not np.isinf(xi[ii - 1]) else beta[ii])
            if lr and ii == p_lr:
                w[blk(ii)] = ((mu / nu) * (UUc @ w[blk(ii - 1)])
                              + Bw[blk(ii)] / nu)
            else:
                w[blk(ii)] = (mu / nu) * w[blk(ii - 1)] + Bw[blk(ii)] / nu
        return w

    # -- rational Krylov ----------------------------------------------------
    v0 = cache.solve(sigma[0], v / torch.linalg.vector_norm(v),
                     reusefact == 2).to(cdt)
    V[:n, 0] = v0 / torch.linalg.vector_norm(v0)
    expand = True
    kconv = 10**9
    kn = n
    l = 0
    N = 0
    nbconv = 0
    nblamin = 0
    lam = np.zeros(0, dtype=complex)
    X = torch.zeros((n, 0), dtype=cdt, device=device)
    res = np.zeros(0)
    conv = np.zeros(0, dtype=bool)
    kmax = maxit + maxdgr if static else maxit
    k = 1
    while k <= kmax:
        if l > 0 and (b == 1 or (l + 1) % b == 1):
            nb = round(1 + l / b)
            Vrows = V.shape[0]
            if expand or not P.spmf:
                Vrows = kn + b * n
            V = _resize(V, Vrows, nb * b + 1)
            H = _resize(H, H.shape[0] + b, H.shape[1] + b)
            K = _resize(K, K.shape[0] + b, K.shape[1] + b)
            if return_details:
                Lam = _resize(Lam, Lam.shape[0] + b, Lam.shape[1] + b)
                Res = _resize(Res, Res.shape[0] + b, Res.shape[1] + b).real

        if expand:
            kn += n if (not lr or k < p_lr) else r_lr
            if P.spmf and computeD:
                D.append(P.construct_D(k, sgdd).to(cdt))
            N += 1
            if not P.spmf:
                nrmD.append(float(torch.linalg.norm(D[k])))
            else:
                nrmD.append(float(np.max(np.abs(sgdd[:, k]))))
            if not np.isfinite(nrmD[k]):
                raise ValueError(
                    "The generalized divided differences must be finite.")
            if n > 1 and k >= 5 and k < kconv:
                if sum(nrmD[k - 4: k + 1]) < 5 * tollin:
                    kconv = k - 1
                    if static:
                        kmax = maxit + kconv
                    expand = False
                    if leja == 1:
                        if len(sigma) < kmax + 1:
                            sigma = np.concatenate([sigma, np.zeros(
                                kmax + 1 - len(sigma), dtype=complex)])
                        sigma[k: kmax + 1] = nodes[: kmax - k + 1]
                    if (not P.spmf) or computeD:
                        D = D[:k]
                    xi = xi[:k]
                    beta = beta[:k]
                    nrmD = nrmD[:k]
                    if static:
                        kn -= n
                        V = _resize(V, kn, b + 1)
                    N -= 1
                    lg.info(f"Linearization converged after {kconv} "
                            "iterations")
                    lg.info("--> freeze linearization")
                elif k == maxdgr + 1:
                    kconv = k
                    expand = False
                    if leja == 1:
                        if len(sigma) < kmax + 1:
                            sigma = np.concatenate([sigma, np.zeros(
                                kmax + 1 - len(sigma), dtype=complex)])
                        sigma[k: kmax + 1] = nodes[: kmax - k + 1]
                    if static:
                        V = _resize(V, kn, b + 1)
                    N -= 1
                    warnings.warn(f"NLEIGS: Linearization not converged "
                                  f"after {maxdgr} iterations")
                    lg.info("--> freeze linearization")

        l = k - N if static else k

        if (not static) or (static and not expand):
            t = np.zeros(l, dtype=complex)
            t[l - 1] = 1.0
            wc = V[:kn, l - 1]
            w = backslash(wc, k, N)
            wj, h, bta = orthogonalize_and_normalize(V[:kn, :l], w, DGKS())
            h = h.cpu().numpy()
            bta = complex(bta)
            H[:l, l - 1] = h
            H[l, l - 1] = bta
            K[:l, l - 1] = h * sigma[k] + t
            K[l, l - 1] = bta * sigma[k]
            V[:kn, l] = wj

        def check_convergence(allmode):
            nonlocal lam, X, res, conv, nbconv, nblamin
            lambda_, S = lapack.geig(K[:l, :l], H[:l, :l])
            lambda_ = lambda_.numpy()
            S = S.numpy().copy()
            if not allmode:
                lamin = in_Sigma(lambda_, Sigma, tol)
                ilam = np.flatnonzero(lamin)
                lam = lambda_[ilam]
                nblamin = int(lamin.sum())
            else:
                ilam = np.flatnonzero(np.isfinite(lambda_))
                lam = lambda_[ilam]
                lamin = in_Sigma(lam, Sigma, tol)
                nblamin = int(lamin.sum())
            for i in ilam:
                S[:, i] /= np.linalg.norm(H[: l + 1, :l] @ S[:, i])
            X = V[:n, : l + 1] @ torch.as_tensor(
                H[: l + 1, :l] @ S[:, ilam], device=device)
            nx = torch.linalg.vector_norm(X, dim=0)
            X = X / torch.where(nx > 0, nx, torch.ones_like(nx))
            res = np.array([float(estimate_error(em, lam[i], X[:, i]))
                            for i in range(len(lam))])
            conv = np.abs(res) < tol
            if allmode:
                conv = conv & lamin
            nbconv = int(conv.sum())
            it = k - N if static else k
            lg.info(f"  iteration {it}: {nbconv} of {nblamin} < {tol}")

        if (not return_details) and (
            (not expand and k >= N + minit
             and (k - (N + minit)) % check_error_every == 0)
            or (k >= kconv + minit
                and (k - (kconv + minit)) % check_error_every == 0)
            or k == kmax
        ):
            check_convergence(False)
        elif return_details and ((not static) or (static and not expand)):
            check_convergence(True)

        if ((not expand and k >= N + minit) or k >= kconv + minit) \
                and nblamin == nbconv:
            break
        k += 1

    if stats is not None:
        stats.update(iterations=min(k, kmax),
                     kconv=kconv if kconv < 10**9 else None,
                     factorizations=cache.factorizations, D_applies=n_D[0],
                     degree=N)
    details = NleigsSolutionDetails()
    if return_details:
        details = NleigsSolutionDetails(
            Lam[:l, :l], Res[:l, :l], sigma[:k], xi, beta, np.asarray(nrmD),
            kconv if kconv < 10**9 else 0)
    sel = np.flatnonzero(conv) if len(conv) else np.zeros(0, dtype=int)
    return (lam[sel], X[:, torch.as_tensor(sel, device=X.device)],
            res[sel] if len(res) else np.zeros(0), details)
