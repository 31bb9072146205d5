"""Complex-as-real tensor infinite Arnoldi (TIAR) — the gun-scale Krylov
layout.

The IAR basis ``V (n(m+1) x m)`` is factorized as ``Z (n x (m+1))`` times a
coefficient tensor ``a (m+1)^3``, so memory is O(nm + m^3) instead of IAR's
O(nm^2) — at n ~ 1e4, m ~ 100 that is 8 MB instead of 800 MB.  The recurrence
runs in split re/im channels, in the JAX package's operation order so the
carry can be held against it step by step:

* the length-n work of a step is two GEMM pairs (``Z @ a``-slice
  expansions), the fused term-bank Mlincomb (on the card ONE launch of the
  DIA SpMV pair kernel), the real 2n x 2n block-LU solve, and one DGKS pair
  against Z — everything else is (m+1)^2 tensor bookkeeping expressed as
  padded einsum pairs;
* the same host-side coefficient tables and block LU as
  :mod:`neptpu_torch.solvers.iar_real` / ``spmf_real`` feed it;
* ``check_error_every`` chunks the steps with host Ritz peeks for a true
  time-to-tolerance early exit.

A step has the JAX package's static-shape form (its ``_tiar_step_fn``): the
step index ``k`` is a 0-dim int64 tensor on the device, read and written by
index ops IN PLACE in the preallocated carry ``(Zre, Zim, are, aim, Hre,
Him)``.  Where the JAX package compiles the steps into one ``lax.scan``, the
port replays one captured CUDA graph a step on the card
(:mod:`neptpu_torch.solvers.scan_graph`) and loops the same step eagerly on
the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, to_numpy_dtype, to_torch_dtype
from ..core import trace
from .common import solver_device
from ..ops.mixed import make_mixed_bank
from .iar_real import (_dep_host_resnorm, _hessenberg, as_pair_solver,
                       dep_coeff_table, dep_shift_block_lu)
from .scan_graph import StepGraph
from .spmf_real import (_spmf_host_resnorm, _sync, collect_spmf_terms,
                        spmf_coeff_table, spmf_shift_block_lu)

__all__ = ["tiar_real_scan", "run_tiar_real", "tiar_real", "tiar_real_spmf"]


def _tiar_step_fn(bank, m, Cre, Cim, gre, gim, solver, dt):
    """One split re/im TIAR step as ``step(carry, k)`` (the JAX package's
    ``_tiar_step_fn``): ``k`` is the 1-based step index, a 0-dim int64
    tensor on the carry's device; the step updates the carry in place and
    returns beta.  Every shape is static and ``k`` is read on the device
    only, so one captured CUDA graph serves every ``k``.

    carry: (Zre, Zim (n, m+1), are, aim (m+1, m+1, m+1) [i=deriv, j=iter,
    l=Z-col], Hre, Him (m+1, m)).  Padding invariant: column j of ``a`` and
    ``Z`` is zero for j > steps done, so padded GEMMs equal growing-slice
    GEMMs."""
    dev = Cre.device
    jblk = torch.arange(m + 1, device=dev)
    # 1/i in float64, then the scan's dtype (as the JAX step rounds it)
    invj = 1.0 / torch.clamp(jblk, min=1).to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    zero_dt = torch.zeros((), dtype=dt, device=dev)
    lo = jblk >= 1

    def step(carry, k):
        Zre, Zim, are, aim, Hre, Him = carry
        km1 = (k - 1).view(1)
        kk = k.view(1)
        inv = torch.where(lo & (jblk <= k), invj, zero).to(dt)

        # ---- expand: y[:, 1+i] = (Z @ a[:, k-1, :].T)[:, i] / (i+1) -------
        Are = are.index_select(1, km1)[:, 0, :]  # (i, l)
        Aim = aim.index_select(1, km1)[:, 0, :]
        Ytre = Zre @ Are.T - Zim @ Aim.T  # (n, m+1), col i
        Ytim = Zre @ Aim.T + Zim @ Are.T
        yre = torch.roll(Ytre, 1, dims=1) * inv[None, :]  # y[:, 1:] filled
        yim = torch.roll(Ytim, 1, dims=1) * inv[None, :]

        # ---- Mlincomb via coefficient table + fused bank apply ------------
        WreT = Cre @ yre.T - Cim @ yim.T  # (terms, n)
        WimT = Cre @ yim.T + Cim @ yre.T
        if hasattr(bank, "lincomb_apply_split_t"):
            zre, zim = bank.lincomb_apply_split_t(WreT, WimT)  # as held
        else:
            zre = bank.lincomb_apply(WreT.T)
            zim = bank.lincomb_apply(WimT.T)
        zre, zim = zre.to(dt), zim.to(dt)
        zre = zre - gre * yre[:, 1] + gim * yim[:, 1]
        zim = zim - gre * yim[:, 1] - gim * yre[:, 1]

        # ---- shifted solve: y0 = -M(sigma)^{-1} z -------------------------
        xre, xim = solver.solve_pair(zre, zim)
        y0re, y0im = -xre, -xim

        # ---- DGKS of y0 against Z (columns not yet filled are zero) -------
        def cgs(wre, wim):
            tre = Zre.T @ wre + Zim.T @ wim  # Re(Z^H w)
            tim = Zre.T @ wim - Zim.T @ wre  # Im(Z^H w)
            wre = wre - (Zre @ tre - Zim @ tim)
            wim = wim - (Zre @ tim + Zim @ tre)
            return wre, wim, tre, tim

        wre, wim, t1re, t1im = cgs(y0re, y0im)
        wre, wim, t2re, t2im = cgs(wre, wim)
        tre, tim = t1re + t2re, t1im + t2im
        beta = torch.sqrt(torch.sum(wre**2) + torch.sum(wim**2))
        Zre.index_copy_(1, kk, (wre / beta)[:, None])
        Zim.index_copy_(1, kk, (wim / beta)[:, None])
        top = jblk == k
        tre = torch.where(top, beta, tre)  # t[k] = beta (real)

        # ---- tensor-level DGKS, padded einsums ----------------------------
        # g[1+i, l] = a[i, k-1, l]/(i+1);  g[0, l] = t[l]
        gre_t = torch.roll(Are, 1, dims=0) * inv[:, None]
        gim_t = torch.roll(Aim, 1, dims=0) * inv[:, None]
        gre_t[0, :] = tre
        gim_t[0, :] = tim

        def tcgs(gre_t, gim_t):
            # h_j = sum_{i,l} conj(a[i,j,l]) g[i,l]
            hre = (torch.einsum("ijl,il->j", are, gre_t)
                   + torch.einsum("ijl,il->j", aim, gim_t))
            him = (torch.einsum("ijl,il->j", are, gim_t)
                   - torch.einsum("ijl,il->j", aim, gre_t))
            # f[i, l] = g[i, l] - sum_j a[i, j, l] h[j]
            fre = gre_t - (torch.einsum("ijl,j->il", are, hre)
                           - torch.einsum("ijl,j->il", aim, him))
            fim = gim_t - (torch.einsum("ijl,j->il", are, him)
                           + torch.einsum("ijl,j->il", aim, hre))
            return fre, fim, hre, him

        fre, fim, h1re, h1im = tcgs(gre_t, gim_t)
        fre, fim, h2re, h2im = tcgs(fre, fim)
        hre, him = h1re + h2re, h1im + h2im
        beta2 = torch.sqrt(torch.sum(fre**2) + torch.sum(fim**2))

        Hre.index_copy_(1, km1, torch.where(top, beta2, hre)[:, None])
        Him.index_copy_(1, km1, torch.where(top, zero_dt, him)[:, None])
        are.index_copy_(1, kk, (fre / beta2)[:, None, :])
        aim.index_copy_(1, kk, (fim / beta2)[:, None, :])
        return beta2

    return step


def _tiar_init(m, v0re, v0im, dt):
    """Zero carry with the unit start vector in column 0 of Z and
    ``a[0, 0, 0] = 1``."""
    n, dev = v0re.shape[0], v0re.device
    nrm0 = torch.sqrt(torch.sum(v0re**2) + torch.sum(v0im**2))
    Zre = torch.zeros((n, m + 1), dtype=dt, device=dev)
    Zim = torch.zeros_like(Zre)
    Zre[:, 0] = v0re / nrm0
    Zim[:, 0] = v0im / nrm0
    are = torch.zeros((m + 1, m + 1, m + 1), dtype=dt, device=dev)
    are[0, 0, 0] = 1.0
    Hre = torch.zeros((m + 1, m), dtype=dt, device=dev)
    return (Zre, Zim, are, torch.zeros_like(are), Hre, torch.zeros_like(Hre))


def _tiar_chunk(bank, m, nsteps, k0, carry, Cre, Cim, gre, gim, solver):
    """Advance ``nsteps`` TIAR steps starting at (1-based) step ``k0``; the
    carry is updated in place and returned.  On the card the steps after
    the first are replays of one captured graph."""
    step = _tiar_step_fn(bank, m, Cre, Cim, gre, gim, solver, carry[0].dtype)
    k = torch.full((), int(k0), dtype=torch.int64, device=carry[0].device)
    with StepGraph(step, carry, k) as run:
        run.advance(nsteps)
    return carry


def tiar_real_scan(bank, m, Cre, Cim, gre, gim, v0re, v0im, lu, piv=None):
    """Run m complex-as-real TIAR steps from the start vector pair (tensors
    on the bank's device); ``lu``: a ``solve_pair`` solver, or with ``piv``
    the dense block LU.  Returns the final carry
    ``(Zre, Zim, are, aim, Hre, Him)``."""
    dt = torch.promote_types(v0re.dtype, torch.as_tensor(Cre).dtype)
    dev = v0re.device
    solver = as_pair_solver(lu if piv is None else (lu, piv))
    carry = _tiar_init(m, v0re.to(dt), v0im.to(dt), dt)
    return _tiar_chunk(bank, m, m, 1, carry,
                       torch.as_tensor(Cre, dtype=dt, device=dev),
                       torch.as_tensor(Cim, dtype=dt, device=dev),
                       float(gre), float(gim), solver)


def _tiar_extract(carry, k_done, n, sigma, gamma):
    """Ritz pairs from the tensor basis on the host:
    ``VV = Z[:, :k] @ a[0, :k, :k].T``, ``Q = VV @ eigvecs(H[:k, :k])``."""
    Zre, Zim, are, aim, Hre, Him = carry

    def host(x):
        return x.cpu().numpy().astype(np.float64)

    H = (host(Hre) + 1j * host(Him))[:k_done, :k_done]
    D, W = np.linalg.eig(H)
    lams = complex(sigma) + complex(gamma) / D
    Z = (host(Zre) + 1j * host(Zim))[:n]
    a0 = host(are[0]) + 1j * host(aim[0])
    VV = Z[:, :k_done] @ a0[:k_done, :k_done].T
    Q = VV @ W
    Q = Q / np.linalg.norm(Q, axis=0, keepdims=True)
    return lams, Q


def run_tiar_real(bank, m, Cre, Cim, id_coeff, v, lu_piv, dt, *, sigma, gamma,
                  neigs, tol, resnorm, n=None, check_error_every=None,
                  device=None):
    """Shared complex-as-real TIAR loop (same contract as
    :func:`neptpu_torch.solvers.iar_real.run_iar_real`)."""
    dt = to_torch_dtype(dt)
    solver = as_pair_solver(lu_piv)
    if hasattr(solver, "astype"):
        solver = solver.astype(dt)
    if n is None:
        n = int(solver.n)
    if device is None:
        device = bank.device
    v = np.asarray(v, dtype=complex)
    id_coeff = complex(id_coeff)
    step = _tiar_step_fn(
        bank, m, torch.as_tensor(np.asarray(Cre), dtype=dt, device=device),
        torch.as_tensor(np.asarray(Cim), dtype=dt, device=device),
        id_coeff.real, id_coeff.imag, solver, dt)
    carry = _tiar_init(m, torch.as_tensor(v.real, dtype=dt, device=device),
                       torch.as_tensor(v.imag, dtype=dt, device=device), dt)
    k = torch.ones((), dtype=torch.int64, device=device)

    def all_errs(lams, Q):
        return np.array([resnorm(lams[s], Q[:, s]) for s in range(len(lams))])

    t_check = 0.0
    with trace.clock("nt.scan") as scan, StepGraph(step, carry, k) as run:
        if check_error_every and np.isfinite(tol):
            chunk = int(check_error_every)
            k_done = 0
            while k_done < m:
                steps = min(chunk, m - k_done)
                run.advance(steps)
                k_done += steps
                run.wait()  # the checks' time is the host's alone
                with trace.clock("nt.scan.check") as check:
                    with trace.span("nt.scan.check.extract"):
                        lams, Q = _tiar_extract(carry, k_done, n, sigma,
                                                gamma)
                    with trace.span("nt.scan.check.measure"):
                        errs = all_errs(lams, Q)
                t_check += check.seconds
                if int(np.sum(errs < tol)) >= neigs:
                    break
        else:
            run.advance(m)
            k_done = m
            lams, Q = _tiar_extract(carry, k_done, n, sigma, gamma)
            errs = all_errs(lams, Q)
    t_scan = scan.seconds

    idx = np.argsort(errs)
    nconv = int(np.sum(errs < tol)) if np.isfinite(tol) else len(errs)
    take = idx[: min(neigs, nconv)]
    info = {"t_scan": t_scan, "t_check": t_check, "nconv": nconv,
            "k_done": k_done, "errs": errs[idx], "graph": run.stats(),
            "hessenberg": _hessenberg(carry)}
    return lams[take], Q[:, take], info


def tiar_real(nep, sigma=0.0, gamma=1.0, maxit=30, neigs=6, tol=None, v=None,
              dtype=torch.float32, lu_piv=None, check_error_every=None,
              errmeasure=None, return_info=False, device=None):
    """Complex-as-real TIAR on a DEP (the contract of
    :func:`neptpu_torch.solvers.iar_real.iar_real`, with the
    tensor-factorized basis).  Residuals are measured on the host in
    complex128 unless ``errmeasure`` is given."""
    device = solver_device(nep, device)
    n = nep.n
    m = int(maxit)
    dt = to_torch_dtype(dtype)
    if tol is None:
        tol = 1e4 * float(torch.finfo(dt).eps)
    with trace.clock("nt.factorize") as fact:
        if lu_piv is None:
            lu_piv = dep_shift_block_lu(nep, sigma, dtype=dt, device=device)
            _sync(device)
    t_fact = fact.seconds
    Cre, Cim = dep_coeff_table(nep, sigma, gamma, m)
    if v is None:
        v = np.ones(n)
    rn = errmeasure if errmeasure is not None else _dep_host_resnorm(nep)
    lams, Q, info = run_tiar_real(
        nep.bank, m, Cre, Cim, gamma, v, lu_piv, dt,
        sigma=sigma, gamma=gamma, neigs=neigs, tol=tol, resnorm=rn, n=n,
        check_error_every=check_error_every, device=device)
    info["t_factorize"] = t_fact
    if return_info:
        return lams, Q, info
    return lams, Q


def tiar_real_spmf(nep, sigma=0.0, gamma=1.0, maxit=30, neigs=6, tol=None,
                   v=None, dtype=torch.float32, lu_piv=None, bank=None,
                   check_error_every=None, errmeasure=None,
                   return_info=False, device=None):
    """Complex-as-real TIAR on a real-operand SPMF (gun-class problems; the
    contract of :func:`neptpu_torch.solvers.spmf_real.iar_real_spmf`, with
    the dense block LU as the shifted solver unless ``lu_piv`` is given)."""
    device = resolve_device(device, like=bank)
    mats, fv = collect_spmf_terms(nep)
    n = mats[0].shape[0]
    m = int(maxit)
    dt = to_torch_dtype(dtype)
    if tol is None:
        tol = 1e4 * float(torch.finfo(dt).eps)
    if bank is None:
        bank = make_mixed_bank(mats, dtype=to_numpy_dtype(dt), device=device)
    with trace.clock("nt.factorize") as fact:
        if lu_piv is None:
            lu_piv = spmf_shift_block_lu(mats, fv, sigma, dtype=dt,
                                         device=device)
            _sync(device)
    t_fact = fact.seconds
    Cre, Cim = spmf_coeff_table(fv, sigma, gamma, m)
    if v is None:
        v = np.ones(n)
    rn = errmeasure if errmeasure is not None else _spmf_host_resnorm(mats, fv)
    lams, Q, info = run_tiar_real(
        bank, m, Cre, Cim, 0.0, v, lu_piv, dt,
        sigma=sigma, gamma=gamma, neigs=neigs, tol=tol, resnorm=rn, n=n,
        check_error_every=check_error_every, device=device)
    info["t_factorize"] = t_fact
    if return_info:
        return lams, Q, info
    return lams, Q
