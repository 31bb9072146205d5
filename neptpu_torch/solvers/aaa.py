"""AAAeigs (Lietaert, Perez, Vandereycken, Meerbergen): set-valued or
weighted AAA rational approximation of the problem's scalar functions
(``svAAA``), a compact CORK pencil from the barycentric representation, and
a CORK rational Krylov iteration with two-level Q/U basis compression and
per-shift factorization caching.

The approximation, the compact pencil and its small LUs, the level-2 basis
``U`` and the Hessenberg pair are host numpy.  The level-1 basis ``Q`` and
every n-sized operation live on the problem's device: the operator apply
``sum_i P_i (Q u_c[:, i])`` is ONE fused apply per term bank of the form
``y = sum_i A_i W[:, i]`` with ``W = Q u_c`` (the DIA SpMV kernel on the
card), and the shifted solve is the linear-solver layer's (a dense LU on the
device by default).

The svAAA keeps an incremental QR of the growing Loewner matrix: per step
one Gram-Schmidt append plus a Cholesky correction for the zeroed support
row, with the weight vector read off the small triangular factor's SVD; a
full tall-matrix SVD remains as the fallback when orthogonality is lost.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.errmeasure import (ResidualErrmeasure, _term_norm, estimate_error,
                               make_errmeasure)
from ..core.exceptions import NoConvergenceException
from ..core.logger import parse_logger
from ..models.pep import PEP
from ..models.spmf import fun_scalar
from ..models.sumnep import SPMFSumNEP
from ..ops.linsolve import (FactorizeLinSolverCreator, create_linsolver,
                            lin_solve)
from .common import solver_device
from .rk.rknep import apply_one, apply_terms, term_banks

__all__ = ["AAAeigs", "svAAA", "get_prz", "reval"]


def _f_scalar_vals(fv, Z):
    """``F[i, j] = f_j(Z_i)`` (scalar evaluations through 1 x 1 matrices)."""
    F = np.empty((len(Z), len(fv)), dtype=complex)
    for j, f in enumerate(fv):
        F[:, j] = np.array([complex(fun_scalar(f, z)) for z in Z])
    return F


def reval(lam, z, fz, w):
    """The barycentric interpolant(s) at the points ``lam``."""
    lam = np.asarray(lam, dtype=complex)
    with np.errstate(all="ignore"):
        C = 1.0 / (lam[:, None] - z[None, :])
        r = (C @ (w[:, None] * fz)) / (C @ w)[:, None]
    iinf = np.isinf(lam)
    if np.any(iinf):
        r[iinf, :] = (np.sum(w[:, None] * fz, axis=0) / np.sum(w))[None, :]
    bad = np.argwhere(np.isnan(r))
    for i1, i2 in bad:
        if not np.isnan(lam[i1]) and np.any(lam[i1] == z):
            r[i1, i2] = fz[np.argmax(lam[i1] == z), i2]
    return r


def get_prz(z, fz, w):
    """Poles, residues and zeros of the barycentric interpolant."""
    import scipy.linalg as sla

    m, s = fz.shape
    B = np.eye(m + 1, dtype=complex)
    B[0, 0] = 0
    E = np.zeros((m + 1, m + 1), dtype=complex)
    E[0, 1:] = w
    E[1:, 0] = 1.0
    E[1:, 1:] = np.diag(z)
    pol = sla.eig(E, B, right=False)
    pol = pol[np.isfinite(pol)]
    dz = 1e-5 * np.array([1j, -1.0, -1j, 1.0])
    pp = (pol[:, None] + dz[None, :]).reshape(-1)
    rvals = reval(pp, z, fz, w)
    rsd = np.empty((len(pol), s), dtype=complex)
    for i in range(s):
        rsd[:, i] = rvals[:, i].reshape(len(pol), 4) @ dz / 4
    zer = np.empty((m + 1, s), dtype=complex)
    for i in range(s):
        E[0, 1:] = w * fz[:, i]
        zer[:, i] = sla.eig(E, B, right=False)
    return pol, rsd, zer


def svAAA(nep, Z, mmax=100, tol=None, cleanup=True, tol_cln=None,
          return_details=False, logger=0, weighted=False, u0_weight=None):
    """Set-valued (or weighted) AAA on the problem's term functions.
    Returns ``(z, fz, w, err, pol, rsd, zer)`` (host numpy)."""
    from scipy.linalg import solve_triangular

    lg = parse_logger(logger)
    if tol is None:
        tol = np.finfo(float).eps * 1e3
    if tol_cln is None:
        tol_cln = min(np.finfo(float).eps, tol)
    fv = nep.get_fv()
    Z = np.asarray(Z, dtype=complex).ravel()
    Z = Z[np.isfinite(Z)]
    M = len(Z)
    s = len(fv)
    F = _f_scalar_vals(fv, Z)

    if weighted:
        Av = nep.get_Av()
        n = nep.n
        u = np.ones(n) if u0_weight is None else np.asarray(u0_weight)
        u = u / np.linalg.norm(u)
        like = next((A for A in Av if isinstance(A, torch.Tensor)), None)
        dev = like.device if like is not None else getattr(
            getattr(nep, "bank", None), "device", None)
        ut = torch.as_tensor(u, device=dev)
        uj = np.stack([apply_one(A, ut).cpu().numpy() for A in Av], axis=1)
        beta = max(np.linalg.norm(uj @ F[i, :]) for i in range(M))
        scaleF = np.array([_term_norm(A) for A in Av])
        F = F * scaleF[None, :]
        scaleF = 1.0 / scaleF
        maxF = np.max(np.abs(F), axis=0, keepdims=True)
    else:
        beta = None
        scaleF = np.max(np.abs(F), axis=0, keepdims=True)
        F = F / scaleF
    err = []
    z = []
    ind = []
    fzl = []
    w = np.zeros(0, dtype=complex)
    R = np.tile(np.mean(F, axis=0, keepdims=True), (M, 1))

    def loewner_cols(zl):
        with np.errstate(all="ignore"):
            C = 1.0 / (Z[:, None] - np.asarray(zl)[None, :])
        C[ind, :] = 0.0
        C[np.isinf(C)] = 0.0
        return np.nan_to_num(C)

    def full_svd_weights(C, fzarr):
        Lmat = np.vstack([C * (F[:, j][:, None] - fzarr[:, j][None, :])
                          for j in range(s)])
        _, _, Vh = np.linalg.svd(Lmat[np.all(np.isfinite(Lmat), axis=1)],
                                 full_matrices=False)
        return Vh.conj().T[:, -1]

    def error_of(res):
        return (float(np.sum(np.max(res, axis=0)) / beta) if weighted
                else float(np.max(res)))

    pol = rsd = zer = np.zeros(0, dtype=complex)
    # L = (Q Su) Hu: Q the stored basis, Su an upper-triangular correction
    # absorbing the orthogonality lost by zeroing each new support row, Hu
    # the small triangular factor whose m x m SVD gives the weights
    Qm = np.zeros((M * s, mmax), dtype=complex)
    Hu = np.zeros((mmax, mmax), dtype=complex)
    Su = np.zeros((mmax, mmax), dtype=complex)
    qr_ok = True
    for m in range(1, mmax + 1):
        res = np.abs(F - R)
        locz, locf = np.unravel_index(np.argmax(res), res.shape)
        err.append(float(np.sum(np.max(res, axis=0)) / beta) if weighted
                   else float(res[locz, locf]))
        lg.info(f"svAAA iteration {m-1}: Error = {err[-1]}", level=2)
        if err[-1] <= tol:
            break
        z.append(Z[locz])
        ind.append(locz)
        fzl.append(F[locz, :].copy())

        zarr = np.asarray(z)
        fzarr = np.asarray(fzl)
        C = loewner_cols(zarr)

        if qr_ok:
            p = m - 1
            rows = locz + M * np.arange(s)
            try:
                if p > 0:
                    # the new support point's rows are zeroed across the
                    # existing columns: restore orthonormality through the
                    # Cholesky correction ee = I - q^H q
                    q = Qm[rows, :p] @ Su[:p, :p]
                    ee = np.eye(p) - q.conj().T @ q
                    Lc = np.linalg.cholesky(ee)
                    Si = Lc.conj().T
                    Hu[:p, :p] = Si @ Hu[:p, :p]
                    Su[:p, :p] = solve_triangular(
                        Si.conj().T, Su[:p, :p].conj().T, lower=True
                    ).conj().T
                    Qm[rows, :p] = 0.0
                # the new Loewner column, Gram-Schmidt appended
                v = np.concatenate([C[:, p] * (F[:, j] - fzarr[p, j])
                                    for j in range(s)])
                v = np.nan_to_num(v)
                nv = np.linalg.norm(v)
                if p > 0:
                    h = Su[:p, :p].conj().T @ (Qm[:, :p].conj().T @ v)
                    Hu[:p, p] = h
                    v = v - Qm[:, :p] @ (Su[:p, :p] @ h)
                Hu[p, p] = np.linalg.norm(v)
                ii = 0
                while ii < 3 and p > 0 and Hu[p, p].real < nv / np.sqrt(2):
                    hh = Su[:p, :p].conj().T @ (Qm[:, :p].conj().T @ v)
                    Hu[:p, p] += hh
                    v = v - Qm[:, :p] @ (Su[:p, :p] @ hh)
                    nv = Hu[p, p].real
                    Hu[p, p] = np.linalg.norm(v)
                    ii += 1
                Qm[:, p] = v / Hu[p, p]
                Su[p, :p] = 0.0
                Su[:p, p] = 0.0
                Su[p, p] = 1.0
                _, _, Vh = np.linalg.svd(Hu[:m, :m])
                w = Vh.conj().T[:, -1]
            except np.linalg.LinAlgError:
                qr_ok = False  # orthogonality lost: the full SVD from now on
        if not qr_ok:
            w = full_svd_weights(C, fzarr)

        with np.errstate(all="ignore"):
            R = (C @ (w[:, None] * fzarr)) / (C @ w)[:, None]
        R[ind, :] = F[ind, :]

        # spurious-pole cleanup
        if cleanup and m > 1:
            pol_c, rsd_c, _ = get_prz(zarr, fzarr, w)
            maxRsd = np.max(np.abs(rsd_c / (maxF if weighted else 1.0)),
                            axis=1)
            sp = np.flatnonzero(maxRsd < tol_cln)
            if len(sp) > 0:
                for j in sp:
                    locj = int(np.argmin(np.abs(np.asarray(z) - pol_c[j])))
                    z.pop(locj)
                    ind.pop(locj)
                    fzl.pop(locj)
                zarr = np.asarray(z)
                fzarr = (np.asarray(fzl) if fzl
                         else np.zeros((0, s), dtype=complex))
                C = loewner_cols(zarr)
                w = full_svd_weights(C, fzarr)
                with np.errstate(all="ignore"):
                    R = (C @ (w[:, None] * fzarr)) / (C @ w)[:, None]
                R[ind, :] = F[ind, :]
                err.append(error_of(np.abs(F - R)))
                lg.info(f"svAAA: {len(sp)} Froissart doublet(s) detected "
                        f"(and removed). Final error = {err[-1]}")
                break
        if m == mmax:
            err.append(error_of(np.abs(F - R)))
            if err[-1] > tol:
                lg.info(f"svAAA: Rational approximation not converged after "
                        f"{mmax} iterations. Final error = {err[-1]}")

    zarr = np.asarray(z)
    fzarr = (np.asarray(fzl) if fzl
             else np.zeros((0, s), dtype=complex)) * scaleF
    # drop zero-weight support points
    nz = np.flatnonzero(w != 0) if len(w) else np.zeros(0, dtype=int)
    if len(nz) < len(w):
        zarr = zarr[nz]
        fzarr = fzarr[nz, :]
        w = w[nz]
    if return_details and len(zarr):
        pol, rsd, zer = get_prz(zarr, fzarr, w)
    return zarr, fzarr, w, np.asarray(err), pol, rsd, zer


def _get_compact_pencil(d, s, m, z, fz, w, NNZ):
    """The compact ``[P_A^T M^T]``, ``[P_B^T N^T]``."""
    dt = len(NNZ)

    def spdiag_rect(rows, cols, main, sub):
        A = np.zeros((rows, cols), dtype=complex)
        for i, v in enumerate(main):
            if i < rows and i < cols:
                A[i, i] = v
        for i, v in enumerate(sub):
            if i + 1 < rows and i < cols:
                A[i + 1, i] = v
        return A

    if dt == 0:
        A1 = spdiag_rect(m, m - 1, -w[1:] * z[:-1], w[:-1] * z[1:])
        compactA = np.hstack([fz, A1])
        B1 = spdiag_rect(m, m - 1, -w[1:], w[:-1])
        compactB = np.hstack([np.zeros((m, s), dtype=complex), B1])
    elif d == 0:
        compactA = np.zeros((1 + m, 1 + s + m), dtype=complex)
        compactA[0, 0] = 1
        compactA[0, -1] = -1
        compactA[1:, 1: 1 + s] = fz
        compactA[1:, 1 + s: s + m] = spdiag_rect(m, m - 1, -w[1:] * z[:-1],
                                                 w[:-1] * z[1:])
        compactA[1:, -1] = 1.0
        compactB = np.zeros((1 + m, 1 + s + m), dtype=complex)
        compactB[1:, 1 + s: s + m] = spdiag_rect(m, m - 1, -w[1:], w[:-1])
    else:
        k = d + m
        ncols = dt + s + d + m - 1
        compactA = np.zeros((k, ncols), dtype=complex)
        # the polynomial selection block (d x dt-1): rows NNZ[:-1]
        for j in range(dt - 1):
            compactA[NNZ[j], j] = 1.0
        compactA[:d, dt + s: dt + s + d - 1] = spdiag_rect(
            d, d - 1, [], np.ones(d - 1))
        compactA[d:, dt: dt + s] = fz
        compactA[d:, dt + s + d - 1: dt + s + d - 1 + m - 1] = spdiag_rect(
            m, m - 1, -w[1:] * z[:-1], w[:-1] * z[1:])
        compactA[d:, -1] = 1.0
        compactA[0, -1] = -1.0
        compactB = np.zeros((k, ncols), dtype=complex)
        compactB[:d, dt + s: dt + s + d - 1] = spdiag_rect(
            d, d - 1, np.ones(d - 1), [])
        compactB[d - 1, dt - 1] = -1.0
        compactB[d:, dt + s + d - 1: dt + s + d - 1 + m - 1] = spdiag_rect(
            m, m - 1, -w[1:], w[:-1])
    return compactA, compactB


def _is_zero(A):
    data = A if isinstance(A, torch.Tensor) else A.data
    return bool(torch.all(data == 0))


def _operator_apply(nep, nep_pep, nep_nep, NNZ):
    """``apply(W) = sum_i P_i W[:, i]`` over the pencil's operators ``P``
    (the polynomial part's nonzero terms ``NNZ``, then the nonlinear part's
    terms): one fused apply per term bank, the polynomial bank's operand
    holding zero rows for its dropped terms; a loop over the terms where a
    part keeps terms outside a bank."""
    if nep_pep is None:
        banks = term_banks(nep)
        Av = nep.get_Av()
        return lambda W: apply_terms(nep, W.T.contiguous(), banks, Av)
    pep_banks, rest = term_banks(nep_pep), term_banks(nep_nep)
    Av_p, Av_n = nep_pep.get_Av(), nep_nep.get_Av()
    dt = len(NNZ)
    if pep_banks is None or rest is None:
        PPCC = [Av_p[i] for i in NNZ] + list(Av_n)
        return lambda W: sum(apply_one(A, W[:, i])
                             for i, A in enumerate(PPCC))
    rows = torch.as_tensor(NNZ, dtype=torch.int64)

    def apply(W):
        WT = W.T.contiguous()
        WTp = torch.zeros((len(Av_p), W.shape[0]), dtype=W.dtype,
                          device=W.device)
        WTp[rows.to(W.device)] = WT[:dt]
        return (apply_terms(nep_pep, WTp, pep_banks)
                + apply_terms(nep_nep, WT[dt:], rest))

    return apply


def AAAeigs(nep, Z, dtype=None, logger=0, mmax=100, neigs=6, maxit=None,
            shifts=(), linsolvercreator=None, tol=None, tol_appr=None,
            v0=None, errmeasure=None, weighted=False, cleanup_appr=True,
            tol_cln=None, return_details=False, check_error_every=10,
            inner_logger=0, stats=None, device=None):
    """Returns ``(lam, X, res, details)``: eigenvalues and errors (numpy),
    eigenvectors (a tensor on the device), and the approximation's details
    (a dict, when ``return_details``).  ``stats``: an optional dict that
    receives the run's counts (``iterations``; ``m``, the number of
    support points)."""
    device = solver_device(nep, device)
    lg = parse_logger(logger)
    ilg = parse_logger(inner_logger)
    if tol is None:
        tol = np.finfo(float).eps * 1e6
    if tol_appr is None:
        tol_appr = np.finfo(float).eps * 1e3
    if tol_cln is None:
        tol_cln = min(np.finfo(float).eps, tol_appr)
    if maxit is None:
        maxit = int(min(max(10 * neigs, 30), 100))
    em = (ResidualErrmeasure(nep) if errmeasure is None
          else make_errmeasure(errmeasure, nep))
    n = nep.n
    cdt = torch.complex128
    shifts = list(shifts) if len(list(shifts)) else [0.0 + 0j]
    if linsolvercreator is None:
        linsolvercreator = FactorizeLinSolverCreator(
            max_factorizations=min(len(set(map(complex, shifts))), 10))
    sig = np.array([shifts[i % len(shifts)] for i in range(maxit)],
                   dtype=complex)

    # AAA + pencil
    nep_pep = nep_nep = None
    if isinstance(nep, SPMFSumNEP) and (isinstance(nep.nep1, PEP)
                                        or isinstance(nep.nep2, PEP)):
        nep_pep, nep_nep = ((nep.nep1, nep.nep2) if isinstance(nep.nep1, PEP)
                            else (nep.nep2, nep.nep1))
        Av_p = nep_pep.get_Av()
        d = len(Av_p) - 1
        NNZ = [i for i, A in enumerate(Av_p) if not _is_zero(A)]
        while NNZ and NNZ[-1] != d:
            NNZ.pop()
            d -= 1
        s = len(nep_nep.get_Av())
        approx = nep_nep
    else:
        NNZ = []
        d = 0
        s = len(nep.get_Av())
        approx = nep
    z, fz, w, err_appr, pol, rsd, zer = svAAA(
        approx, Z, mmax=mmax, tol=tol_appr, cleanup=cleanup_appr,
        tol_cln=tol_cln, return_details=return_details, logger=ilg,
        weighted=weighted)
    apply_P = _operator_apply(nep, nep_pep, nep_nep, NNZ)
    m = len(z)
    compactA, compactB = _get_compact_pencil(d, s, m, z, fz, w, NNZ)
    dt = len(NNZ)
    k = d + m
    if d == 0 and dt != 0:
        k += 1
    l = dt + s
    lg.info(f"AAAPencil: Pencil is built with d={d}, s={s} and m={m}.")

    import scipy.linalg as sla

    rmax = jmax = maxit
    fact_cache = {}
    max_f = min(len(set(map(complex, shifts))), 10)
    rng = np.random.default_rng(3)
    if v0 is None or len(np.atleast_1d(v0)) != n:
        v0 = rng.standard_normal(n)
    v0 = (v0.to(device=device, dtype=cdt) if isinstance(v0, torch.Tensor)
          else torch.as_tensor(np.asarray(v0, dtype=complex), device=device))
    Q = torch.zeros((n, rmax + 1), dtype=cdt, device=device)
    Q[:, 0] = v0 / torch.linalg.vector_norm(v0)
    U = np.zeros((rmax + 1, k, jmax + 1), dtype=complex)
    U[0, 0, 0] = 1.0
    H = np.zeros((jmax + 1, jmax), dtype=complex)
    K = np.zeros((jmax + 1, jmax), dtype=complex)

    def norm(x):
        return float(torch.linalg.vector_norm(x))

    def to_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    r = 1
    j = 1
    it = 1
    nconv = 0
    Lam = np.zeros(0, dtype=complex)
    X = torch.zeros((n, 0), dtype=cdt, device=device)
    res = np.zeros(0)

    while it <= maxit and nconv < neigs:
        key = complex(sig[it - 1])
        if key in fact_cache:
            lu_piv, MlN = fact_cache[key]
        else:
            MlN = np.hstack([np.eye(k, 1, dtype=complex),
                             compactA[:, l:] - key * compactB[:, l:]])
            lu_piv = sla.lu_factor(MlN)
            if len(fact_cache) < max_f:
                fact_cache[key] = (lu_piv, MlN)
        Y = sla.lu_solve(lu_piv, key * compactB[:, :l] - compactA[:, :l])
        u_c = U[:r, :k, j - 1] @ (compactB @ np.vstack(
            [np.eye(l, dtype=complex), Y[1:, :]]))
        # sum_i P_i (Q u_c[:, i]): the fused operator apply
        v1_hat = apply_P(Q[:, :r] @ to_dev(u_c)).to(cdt)
        solver = create_linsolver(linsolvercreator, nep, key)
        v1_hat = lin_solve(solver, v1_hat).to(cdt)
        if dt == 0:
            phi0 = w / (key - z)
            v1_hat = complex(phi0[0] / np.sum(phi0)) * v1_hat
        # level 1: Gram-Schmidt against Q
        Qr = Q[:, :r]
        nv = norm(v1_hat)
        u1 = Qr.conj().T @ v1_hat
        v1_hat = v1_hat - Qr @ u1
        ii = 0
        while ii < 3 and norm(v1_hat) < nv / np.sqrt(2):
            nv = norm(v1_hat)
            u1n = Qr.conj().T @ v1_hat
            v1_hat = v1_hat - Qr @ u1n
            u1 = u1 + u1n
            ii += 1
        u1_hat = u1.cpu().numpy()
        nv = norm(v1_hat)
        if nv > np.finfo(float).eps:
            rnew = r + 1
            Q[:, rnew - 1] = v1_hat / nv
            U[rnew - 1, :k, :j] = 0
            u1_hat = np.concatenate([u1_hat, [nv]])
        else:
            rnew = r
        # level 2
        W = np.tile(u1_hat[:, None], (1, k))
        W[:, 1:] = U[:rnew, :k, j - 1] @ compactB[:, l:]
        Uhat = sla.lu_solve(lu_piv, W.T, trans=1).T  # W / MlN
        U_rs = U[:rnew, :, :j].reshape(rnew * k, j, order="F")
        uhat_rs = Uhat.reshape(rnew * k, order="F")
        nu = np.linalg.norm(uhat_rs)
        H[:j, j - 1] = U_rs.conj().T @ uhat_rs
        uhat_rs = uhat_rs - U_rs @ H[:j, j - 1]
        H[j, j - 1] = np.linalg.norm(uhat_rs)
        ii = 0
        while ii < 3 and np.real(H[j, j - 1]) < nu / np.sqrt(2):
            hn = U_rs.conj().T @ uhat_rs
            uhat_rs = uhat_rs - U_rs @ hn
            H[:j, j - 1] += hn
            nu = np.real(H[j, j - 1])
            H[j, j - 1] = np.linalg.norm(uhat_rs)
            ii += 1
        U[:rnew, :, j] = uhat_rs.reshape(rnew, k, order="F") / H[j, j - 1]
        K[:j, j - 1] = key * H[:j, j - 1]
        K[j - 1, j - 1] += 1.0
        K[j, j - 1] = H[j, j - 1] * key

        if return_details or (it % check_error_every == 0) or it == maxit:
            Lam_, S = sla.eig(K[:j, :j], H[:j, :j])
            X = Q[:, :rnew] @ to_dev(U[:rnew, 0, : j + 1]
                                     @ (H[: j + 1, :j] @ S))
            res = np.array([float(estimate_error(em, Lam_[i], X[:, i]))
                            for i in range(len(Lam_))])
            conv = np.abs(res) < tol
            nconv = int(conv.sum())
            lg.info(f"AAAeigs iteration {it}: {nconv} of {it} < {tol}")
            idx = np.argsort(res)
            Lam = Lam_
            if it == maxit or nconv >= neigs:
                nb = int(min(len(Lam_), neigs))
                Lam = Lam_[idx[:nb]]
                X = X[:, torch.as_tensor(idx[:nb], device=device)]
                res = res[idx[:nb]]
        r = rnew
        j += 1
        it += 1

    if stats is not None:
        stats.update(iterations=it - 1, m=m)
    if nconv < neigs and neigs != np.inf:
        msg = f"AAAeigs: Number of iterations exceeded. maxit={maxit}."
        raise NoConvergenceException(Lam, X, res, msg)
    details = dict(m_appr=m, z=z, fz=fz, w=w, err_appr=err_appr,
                   pol=pol, rsd=rsd, zer=zer) if return_details else None
    return Lam, X, res, details
