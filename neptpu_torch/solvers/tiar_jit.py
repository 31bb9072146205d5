"""Complex TIAR in native complex dtype — the complex128 counterpart of the
split re/im :mod:`neptpu_torch.solvers.tiar_real`.

The tensor-factorized basis ``Z (n, m+1)`` times the coefficient tensor
``a (m+1)^3`` keeps memory at O(nm + m^3).  A step is two GEMMs (the
``Z @ a``-slice expansion and the coefficient table), ONE fused term-bank
apply of the complex operand (``lincomb_apply``: on the card the re/im pair
kernel of the DIA SpMV, one launch), the shifted solve against one dense LU
of M(sigma), and a DGKS pass against Z plus the (m+1)^2 tensor-level DGKS.
A step has the JAX package's static-shape form (its ``_step_fn``): the step
index ``k`` is a 0-dim int64 tensor on the device, read and written by index
ops in place in the preallocated carry.  Where the JAX package
compiles the steps into one ``lax.scan``, the port replays one captured CUDA
graph a step on the card (:mod:`neptpu_torch.solvers.scan_graph`) and loops
the same step eagerly on the CPU.  ``check_error_every`` chunks the steps
with host Ritz peeks for an early exit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import real_of, to_numpy_dtype, to_torch_dtype
from ..core import trace
from .common import solver_device
from .scan_graph import StepGraph
from .spmf_real import _sync

__all__ = ["tiar_scan_complex", "tiar_jitted", "tiar_jitted_spmf"]


def _step_fn(bank, m, C, gamma_id, lu, piv, cdt):
    """One complex TIAR step as ``step(carry, k)`` (the JAX package's
    ``_step_fn``): ``k`` is the 1-based step index, a 0-dim int64 tensor on
    the carry's device; the step updates the carry ``(Z (n, m+1), a
    (m+1)^3 [i=deriv, j=iter, l=Z-col], H (m+1, m))`` in place and returns
    beta.  Every shape is static and ``k`` is read on the device only."""
    dev = C.device
    jblk = torch.arange(m + 1, device=dev)
    rdt = real_of(cdt)
    invj = 1.0 / torch.clamp(jblk, min=1).to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    lo = jblk >= 1

    def step(carry, k):
        Z, a, H = carry
        km1 = (k - 1).view(1)
        kk = k.view(1)
        inv = torch.where(lo & (jblk <= k), invj, zero).to(rdt)

        # expand: y[:, 1+i] = (Z @ a[:, k-1, :].T)[:, i] / (i+1)
        A = a.index_select(1, km1)[:, 0, :]
        y = torch.roll(Z @ A.T, 1, dims=1) * inv[None, :]

        # Mlincomb via the table + the fused bank apply of the complex operand
        W = (C @ y.T).T  # (n, terms)
        z = bank.lincomb_apply(W).to(cdt)
        z = z - gamma_id * y[:, 1]
        y0 = -torch.linalg.lu_solve(lu, piv, z[:, None])[:, 0]

        # DGKS of y0 against Z
        def cgs(w):
            t = Z.conj().T @ w
            return w - Z @ t, t

        w, t1 = cgs(y0)
        w, t2 = cgs(w)
        t = t1 + t2
        beta = torch.sqrt(torch.sum(torch.abs(w) ** 2)).to(cdt)
        Z.index_copy_(1, kk, (w / beta)[:, None])
        top = jblk == k
        t = torch.where(top, beta, t)

        # tensor-level DGKS
        g = torch.roll(A, 1, dims=0) * inv[:, None]
        g[0, :] = t

        def tcgs(g):
            h = torch.einsum("ijl,il->j", a.conj(), g)
            return g - torch.einsum("ijl,j->il", a, h), h

        f, h1 = tcgs(g)
        f, h2 = tcgs(f)
        h = h1 + h2
        beta2 = torch.sqrt(torch.sum(torch.abs(f) ** 2)).to(cdt)
        H.index_copy_(1, km1, torch.where(top, beta2, h)[:, None])
        a.index_copy_(1, kk, (f / beta2)[:, None, :])
        return beta2

    return step


def _init(m, v0, cdt):
    n = v0.shape[0]
    dev = v0.device
    Z = torch.zeros((n, m + 1), dtype=cdt, device=dev)
    Z[:, 0] = v0 / torch.linalg.vector_norm(v0)
    a = torch.zeros((m + 1, m + 1, m + 1), dtype=cdt, device=dev)
    a[0, 0, 0] = 1.0
    H = torch.zeros((m + 1, m), dtype=cdt, device=dev)
    return (Z, a, H)


def _chunk(bank, m, nsteps, k0, carry, C, gamma_id, lu, piv):
    """Advance ``nsteps`` steps from (1-based) step ``k0``; the carry is
    updated in place and returned."""
    step = _step_fn(bank, m, C, gamma_id, lu, piv, carry[0].dtype)
    k = torch.full((), int(k0), dtype=torch.int64, device=carry[0].device)
    with StepGraph(step, carry, k) as run:
        run.advance(nsteps)
    return carry


def tiar_scan_complex(bank, m, C, gamma_id, v0, lu, piv):
    """Run m complex TIAR steps; returns the final carry ``(Z, a, H)``."""
    cdt = torch.promote_types(v0.dtype, C.dtype)
    carry = _init(m, v0.to(cdt), cdt)
    return _chunk(bank, m, m, 1, carry, C, gamma_id, lu, piv)


def _extract(carry, k_done, n, sigma, gamma):
    """Ritz values (numpy) and unit Ritz vectors (numpy, on the host) from
    the first ``k_done`` steps."""
    Z, a, H = carry
    H_h = H[:k_done, :k_done].cpu().numpy()
    D, W = np.linalg.eig(H_h)
    lams = complex(sigma) + complex(gamma) / D
    VV = Z[:n, :k_done] @ a[0, :k_done, :k_done].T
    Q = (VV @ torch.as_tensor(W, device=Z.device)).cpu().numpy()
    Q = Q / np.linalg.norm(Q, axis=0, keepdims=True)
    return lams, Q


def _run(bank, m, C, id_coeff, v, lu_piv, cdt, *, sigma, gamma, neigs, tol,
         resnorm, n, device, check_error_every=None):
    C = torch.as_tensor(C, device=device).to(cdt)
    gamma_id = complex(id_coeff)
    lu, piv = lu_piv
    lu = lu.to(cdt)
    v0 = torch.as_tensor(np.asarray(v, dtype=complex), device=device).to(cdt)
    step = _step_fn(bank, m, C, gamma_id, lu, piv, cdt)
    t_check = 0.0

    def peek(k_done):
        with trace.span("nt.scan.check.extract"):
            lams, Q = _extract(carry, k_done, n, sigma, gamma)
        with trace.span("nt.scan.check.measure"):
            return lams, Q, np.array([resnorm(lams[s], Q[:, s])
                                      for s in range(len(lams))])

    with trace.clock("nt.scan") as scan:
        carry = _init(m, v0, cdt)
        k = torch.ones((), dtype=torch.int64, device=device)
        with StepGraph(step, carry, k) as run:
            if check_error_every and np.isfinite(tol):
                chunk = int(check_error_every)
                k_done = 0
                while k_done < m:
                    steps = min(chunk, m - k_done)
                    run.advance(steps)
                    k_done += steps
                    run.wait()  # the checks' time is the host's alone
                    with trace.clock("nt.scan.check") as check:
                        lams, Q, errs = peek(k_done)
                    t_check += check.seconds
                    if int(np.sum(errs < tol)) >= neigs:
                        break
            else:
                run.advance(m)
                k_done = m
                lams, Q, errs = peek(k_done)
    t_scan = scan.seconds
    idx = np.argsort(errs)
    nconv = int(np.sum(errs < tol)) if np.isfinite(tol) else len(errs)
    take = idx[: min(neigs, nconv)]
    info = {"t_scan": t_scan, "t_check": t_check, "nconv": nconv,
            "k_done": k_done, "errs": errs[idx], "graph": run.stats(),
            "hessenberg": carry[2].cpu().numpy()}
    return lams[take], Q[:, take], info


def _dense_lu(M0, cdt, device):
    """LU of a complex scipy sparse matrix, densified on ``device``."""
    M0 = M0.tocoo()
    A = torch.zeros(M0.shape, dtype=cdt, device=device)
    rows = torch.as_tensor(M0.row.astype(np.int64), device=device)
    cols = torch.as_tensor(M0.col.astype(np.int64), device=device)
    A.index_put_((rows, cols), torch.as_tensor(M0.data, device=device).to(
        cdt), accumulate=True)
    return torch.linalg.lu_factor(A)


def _complex_shift_lu(mats, fv, sigma, cdt, device=None):
    """Dense LU ``(lu, piv)`` of M(sigma) = sum_i f_i(sigma) A_i: the sparse
    sum in complex128 on the host, factored on ``device``."""
    import scipy.sparse as sp

    from .spmf_real import spmf_fun_scalars

    with trace.span("nt.factorize.assemble"):
        w = spmf_fun_scalars(fv, sigma)
        M0 = None
        for wi, A in zip(w, mats):
            T = (A * wi) if sp.issparse(A) else sp.csr_matrix(
                np.asarray(A) * wi)
            M0 = T if M0 is None else M0 + T
    return _dense_lu(M0, cdt, device)


def tiar_jitted(nep, sigma=0.0, gamma=1.0, maxit=30, neigs=6, tol=None,
                v=None, dtype=torch.complex128, check_error_every=None,
                errmeasure=None, return_info=False, device=None):
    """Complex TIAR on a DEP (the contract of ``tiar``): returns ``(lams,
    Q)`` as numpy arrays (``info`` too with ``return_info``).  Residuals
    are measured on the host in complex128 unless ``errmeasure`` is
    given."""
    import scipy.sparse as sp

    from .iar_real import _dep_host_resnorm, dep_coeff_table

    device = solver_device(nep, device)
    n = nep.n
    m = int(maxit)
    cdt = to_torch_dtype(dtype)
    if tol is None:
        tol = 1e4 * float(torch.finfo(cdt).eps)
    sigma_c = complex(sigma)
    with trace.clock("nt.factorize") as fact:
        with trace.span("nt.factorize.assemble"):
            M0 = sp.coo_matrix(
                (np.full(n, -sigma_c), (np.arange(n), np.arange(n))),
                shape=(n, n)).tocsr()
            for t, A in zip(np.asarray(nep.tauv, dtype=float),
                            nep.bank.host_csr_terms()):
                M0 = M0 + np.exp(-t * sigma_c) * A
        lu_piv = _dense_lu(M0, cdt, device)
        _sync(device)
    t_fact = fact.seconds
    Cre, Cim = dep_coeff_table(nep, sigma, gamma, m)
    C = Cre + 1j * Cim
    if v is None:
        v = np.ones(n)
    rn = errmeasure if errmeasure is not None else _dep_host_resnorm(nep)
    lams, Q, info = _run(nep.bank, m, C, gamma, v, lu_piv, cdt,
                         sigma=sigma, gamma=gamma, neigs=neigs, tol=tol,
                         resnorm=rn, n=n, device=device,
                         check_error_every=check_error_every)
    info["t_factorize"] = t_fact
    if return_info:
        return lams, Q, info
    return lams, Q


def tiar_jitted_spmf(nep, sigma=0.0, gamma=1.0, maxit=30, neigs=6, tol=None,
                     v=None, dtype=torch.complex128, check_error_every=None,
                     errmeasure=None, return_info=False, device=None):
    """Complex TIAR on any SPMF (the gun and waveguide class): the complex
    counterpart of :func:`neptpu_torch.solvers.tiar_real.tiar_real_spmf`,
    over the merged real term bank (``make_mixed_bank``) applied to the
    complex operand."""
    from ..ops.mixed import make_mixed_bank
    from .spmf_real import (_spmf_host_resnorm, collect_spmf_terms,
                            spmf_coeff_table)

    device = solver_device(nep, device)
    mats, fv = collect_spmf_terms(nep)
    n = mats[0].shape[0]
    m = int(maxit)
    cdt = to_torch_dtype(dtype)
    if tol is None:
        tol = 1e4 * float(torch.finfo(cdt).eps)
    real = torch.float64 if cdt == torch.complex128 else torch.float32
    bank = make_mixed_bank(mats, dtype=to_numpy_dtype(real), device=device)
    with trace.clock("nt.factorize") as fact:
        lu_piv = _complex_shift_lu(mats, fv, sigma, cdt, device)
        _sync(device)
    t_fact = fact.seconds
    Cre, Cim = spmf_coeff_table(fv, sigma, gamma, m)
    C = Cre + 1j * Cim
    if v is None:
        v = np.ones(n)
    rn = errmeasure if errmeasure is not None else _spmf_host_resnorm(mats, fv)
    lams, Q, info = _run(bank, m, C, 0.0, v, lu_piv, cdt,
                         sigma=sigma, gamma=gamma, neigs=neigs, tol=tol,
                         resnorm=rn, n=n, device=device,
                         check_error_every=check_error_every)
    info["t_factorize"] = t_fact
    if return_info:
        return lams, Q, info
    return lams, Q
