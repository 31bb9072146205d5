"""Complex-as-real IAR for real-operand SPMFs — the device path for the gun
class of problems.

* The coefficient table ``C[i, j] = gamma^j f_i^{(j)}(sigma)`` is computed on
  the host in complex128 — exactly when the term functions carry
  closed-form derivative rules (:class:`neptpu_torch.ops.matfun.DerivFun`),
  else by the bidiagonal matrix-function trick on the CPU.
* The merged real term bank (``ops/mixed.py``: DIA main part + stacked
  low-rank boundary factors) drives the fused Mlincomb in paired real
  channels.
* The shifted solve is the partitioned SPIKE + SMW solver
  (``ops/partitioned.py``); the dense real 2n x 2n block LU is the fallback
  for bulks that are neither banded nor arrow.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..config import resolve_device, to_numpy_dtype, to_torch_dtype
from ..core import trace
from ..ops.mixed import make_mixed_bank
from .iar_real import (DeflationOps, apply_theta, auto_theta,
                       block_assemble_lu, run_iar_real)

__all__ = [
    "term_matrices",
    "collect_spmf_terms",
    "spmf_coeff_table",
    "finite_table_prefix",
    "spmf_fun_scalars",
    "spmf_shift_block_lu",
    "iar_real_spmf",
    "iar_real_spmf_multishift",
    "iar_real_spmf_deflated",
]


def term_matrices(bank):
    """Host scipy-CSR mirrors of every term of a DIA, CSR, dense or mixed
    bank (no device read where the bank keeps its construction-time host
    mirror)."""
    return bank.host_csr_terms()


def collect_spmf_terms(nep):
    """(scipy term matrices, fv) for an SPMF — including sums whose parts
    live in separate banks (gun = PEP + sqrt-SPMF)."""
    if not (hasattr(nep, "get_Av") and hasattr(nep, "get_fv")):
        raise TypeError(f"need an SPMF-like NEP, got {type(nep).__name__}")
    fv = list(nep.get_fv())
    mats = []
    for sub in _spmf_parts(nep):
        if hasattr(sub, "tauv"):  # DEP: virtual identity term (-lam I) first
            import scipy.sparse as sp

            mats.append(sp.eye(sub.n, format="csr"))
        mats.extend(sub.bank.host_csr_terms())
    if len(mats) != len(fv):
        raise ValueError(f"collected {len(mats)} operand matrices but "
                         f"{len(fv)} term functions")
    return mats, fv


def _spmf_parts(nep):
    """Flatten SPMFSumNEP trees into bank-holding leaves, fv-ordered."""
    if hasattr(nep, "nep1") and hasattr(nep, "nep2"):
        return _spmf_parts(nep.nep1) + _spmf_parts(nep.nep2)
    if not hasattr(nep, "bank"):
        raise TypeError(
            f"SPMF part {type(nep).__name__} holds no term bank; the "
            "complex-as-real path needs bank-backed operands")
    return [nep]


def _fun_derivs_cpu(f, lam, k):
    from ..ops.matfun import fun_derivatives

    return fun_derivatives(f, complex(lam), k).numpy()


def spmf_coeff_table(fv, sigma, gamma, m, scaled=False):
    """C[i, j] = gamma^j f_i^{(j)}(sigma), j = 0..m, column 0 zeroed (IAR
    feeds derivatives 1..m), complex128 on the host.  ``scaled`` divides
    column j by j! (the Taylor-normalized table); the gamma-power/factorial
    prefactor is accumulated progressively so neither factor over/underflows
    on its own.  Returns (Cre, Cim)."""
    sigma = complex(sigma)
    gamma = complex(gamma)
    gj = np.ones(m + 1, dtype=complex)
    for j in range(1, m + 1):
        gj[j] = gj[j - 1] * (gamma / j if scaled else gamma)
    C = np.zeros((len(fv), m + 1), dtype=complex)
    for i, f in enumerate(fv):
        if hasattr(f, "derivs"):
            C[i] = f.derivs(sigma, m + 1) * gj
        else:
            C[i] = _fun_derivs_cpu(f, sigma, m + 1).astype(complex) * gj
    C[:, 0] = 0.0
    return np.ascontiguousarray(C.real), np.ascontiguousarray(C.imag)


def finite_table_prefix(Cre, Cim, dtype):
    """Largest k such that columns 0..k of the coefficient table are finite
    and representable in ``dtype`` with GEMM headroom (a padded-basis GEMM
    would multiply inf columns by the zero padding and poison the scan with
    NaN from step 1)."""
    colmax = np.maximum(np.abs(Cre), np.abs(Cim)).max(axis=0)
    cap = float(torch.finfo(to_torch_dtype(dtype)).max) / max(
        16 * len(colmax), 256)
    ok = np.isfinite(colmax) & (colmax <= cap)
    bad = np.nonzero(~ok)[0]
    return int(bad[0] - 1) if bad.size else int(len(colmax) - 1)


def spmf_fun_scalars(fv, lam):
    """[f_i(lam)] in complex128 on the host (assembly + residuals)."""
    vals = np.zeros(len(fv), dtype=complex)
    for i, f in enumerate(fv):
        if hasattr(f, "derivs"):
            vals[i] = f.derivs(complex(lam), 1)[0]
        else:
            S = torch.tensor([[complex(lam)]], dtype=torch.complex128)
            vals[i] = complex(f(S)[0, 0])
    return vals


def spmf_shift_block_lu(mats, fv, sigma, dtype=torch.float32, device=None):
    """Real 2n x 2n block LU of M(sigma) = sum_i f_i(sigma) A_i: the sparse
    sum in complex128 on the host, the block form ``[[Re, -Im], [Im, Re]]``
    scattered and LU-factored (``torch.linalg.lu_factor``) on ``device``."""
    import scipy.sparse as sp

    device = resolve_device(device)
    with trace.span("nt.factorize.assemble"):
        w = spmf_fun_scalars(fv, sigma)
        M0 = None
        for wi, A in zip(w, mats):
            T = (A * wi) if sp.issparse(A) else sp.csr_matrix(
                np.asarray(A) * wi)
            M0 = T if M0 is None else M0 + T
    return block_assemble_lu(M0, dtype, device)


def _spmf_host_resnorm(mats, fv):
    """``(lam, q) -> ||M(lam) q||`` on the host in complex128; all terms
    stacked into one tall CSR so a call is ONE SpMV (the waveguide carries
    213 terms) and a weight contraction."""
    import scipy.sparse as sp

    nt, n = len(mats), mats[0].shape[0]
    A_all = sp.vstack([sp.csr_matrix(A) for A in mats], format="csr")
    A_all.eliminate_zeros()  # aligned banks hand out explicit zeros

    def resnorm(lam, q):
        w = spmf_fun_scalars(fv, lam)
        return float(np.linalg.norm(w @ (A_all @ q).reshape(nt, n)))

    return resnorm


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def iar_real_spmf(nep, sigma=0.0, gamma=1.0, maxit=30, neigs=6, tol=None,
                  v=None, dtype=torch.float32, lu_piv=None, bank=None,
                  check_error_every=None, errmeasure=None,
                  return_info=False, scaled="auto", precision=None,
                  return_solver=False, device=None):
    """Complex-as-real IAR on a real-operand SPMF (gun-class problems).

    Returns the converged ``(lams, Q)``, sorted by residual.  ``bank``
    optionally reuses a prebuilt merged real term bank; ``lu_piv`` a
    prefactored shifted solver.  ``check_error_every``: stop once ``neigs``
    Ritz pairs pass ``tol``, checking every that many steps.
    ``errmeasure``: optional ``(lam, q) -> float`` replacing the residual
    norm.  ``device``: where the bank, the factorization and the basis live
    (default: the device of ``bank``, else the card; ``"cpu"`` for a CPU run).
    ``precision`` is a no-op kept for parity with the JAX package (TF32 is
    off, so ``"highest"`` is what every float32 product already gets)."""
    device = resolve_device(device, like=bank)
    mats, fv = collect_spmf_terms(nep)
    n = mats[0].shape[0]
    m = int(maxit)
    dt = to_torch_dtype(dtype)
    if tol is None:
        tol = 1e4 * float(torch.finfo(dt).eps)
    t_bank = 0.0
    if bank is None:
        t0 = time.perf_counter()
        bank = make_mixed_bank(mats, dtype=to_numpy_dtype(dt), device=device)
        _sync(device)  # time the upload, not its enqueue
        t_bank = time.perf_counter() - t0

    with trace.clock("nt.factorize") as fact:
        if lu_piv is None:
            from ..ops.partitioned import build_spmf_shift_solver

            lu_piv = build_spmf_shift_solver(mats, fv, sigma, dtype=dt,
                                             device=device)
            if lu_piv is None:  # bulk neither banded nor arrow: dense LU
                lu_piv = spmf_shift_block_lu(mats, fv, sigma, dtype=dt,
                                             device=device)
            _sync(device)
    t_fact = fact.seconds

    # 'auto': classic Taylor space unless its table overflows ``dt`` before
    # ``maxit`` — then the theta-scaled space
    with trace.clock("nt.scan.table") as table:
        if scaled == "auto":
            Cre, Cim = spmf_coeff_table(fv, sigma, gamma, m, scaled=False)
            scaled = finite_table_prefix(Cre, Cim, dt) < m
        else:
            scaled = bool(scaled)
        Cre, Cim = spmf_coeff_table(fv, sigma, gamma, m, scaled=scaled)
        theta = 1.0
        if scaled:
            theta = auto_theta(Cre, Cim, m, dt)
            Cre, Cim = apply_theta(Cre, Cim, theta)
        m_fin = finite_table_prefix(Cre, Cim, dt)
        if m_fin < m:
            warnings.warn(
                f"coefficient table overflows {dt} past derivative order "
                f"{m_fin}; truncating maxit {m} -> {m_fin}")
            m = m_fin
            Cre, Cim = Cre[:, : m + 1], Cim[:, : m + 1]
    t_table = table.seconds
    if v is None:
        v = np.ones(n)

    rn = errmeasure if errmeasure is not None else _spmf_host_resnorm(mats, fv)
    lams, Q, info = run_iar_real(
        bank, m, Cre, Cim, 0.0, v, lu_piv, dt,  # no virtual -lam*I term
        sigma=sigma, gamma=gamma, neigs=neigs, tol=tol, resnorm=rn, n=n,
        check_error_every=check_error_every, scaled=scaled, theta=theta,
        device=device, precision=precision)
    info["t_factorize"] = t_fact
    info["t_bank"] = t_bank
    info["t_table"] = t_table
    info["theta"] = theta
    info["scaled"] = scaled
    if return_solver:
        info["solver"] = lu_piv
    if return_info:
        return lams, Q, info
    return lams, Q


def iar_real_spmf_multishift(nep, sigmas, gamma=1.0, maxit=30, neigs=6,
                             tol=None, dtype=torch.float32,
                             check_error_every=None, errmeasure=None,
                             precision=None, dedupe_rel=1e-7,
                             return_info=False, device=None):
    """Complex-as-real IAR from SEVERAL shifts, merged and deduplicated.

    The term bank is built once and shared; each extra shift costs one
    shifted factorization plus one scan.  Returns ``(lams, Q[, info])`` over
    the union of converged pairs, best residual first, pairs within
    ``dedupe_rel`` relative distance merged.  ``device=None`` is the card."""
    device = resolve_device(device)
    mats, fv = collect_spmf_terms(nep)
    dt = to_torch_dtype(dtype)
    t0 = time.perf_counter()
    bank = make_mixed_bank(mats, dtype=to_numpy_dtype(dt), device=device)
    _sync(device)  # time the upload, not its enqueue
    t_bank = time.perf_counter() - t0
    meas = errmeasure if errmeasure is not None else _spmf_host_resnorm(
        mats, fv)
    all_l, all_q, infos = [], [], []
    for s in sigmas:
        lams, Q, info = iar_real_spmf(
            nep, sigma=s, gamma=gamma, maxit=maxit, neigs=neigs, tol=tol,
            dtype=dt, bank=bank, check_error_every=check_error_every,
            errmeasure=errmeasure, precision=precision, return_info=True,
            device=device)
        infos.append(info)
        for j in range(len(lams)):
            all_l.append(complex(lams[j]))
            all_q.append(np.asarray(Q[:, j]))
    if not all_l:
        out = (np.zeros(0, complex), np.zeros((nep.n, 0), complex))
        return (out + ({"per_shift": infos, "t_bank": t_bank},)
                if return_info else out)
    errs = np.array([meas(la, q) for la, q in zip(all_l, all_q)])
    sel = []
    for j in np.argsort(errs):
        la = all_l[j]
        if all(abs(la - all_l[i]) > dedupe_rel * max(1.0, abs(la))
               for i in sel):
            sel.append(j)
    lams = np.array([all_l[j] for j in sel])
    Q = np.stack([all_q[j] for j in sel], axis=1)
    if return_info:
        return lams, Q, {"per_shift": infos, "errs": errs[sel],
                         "t_bank": t_bank}
    return lams, Q


def iar_real_spmf_deflated(nep, sigma=0.0, gamma=1.0, maxit=30, neigs=6,
                           tol=None, restarts=None, v=None,
                           dtype=torch.float32, check_error_every=None,
                           errmeasure=None, return_info=False, seed=0,
                           device=None):
    """Restarted complex-as-real IAR with Effenberger deflation: converged
    pairs never reconverge.

    Each sweep runs the theta-scaled scan extended by the current invariant
    pair (X, S) through :class:`~neptpu_torch.solvers.iar_real.DeflationOps`:
    the bank apply stays the ordinary one at length n on ``v' = v + X t``
    (one pair launch a step on the card), the bordered solve reuses the one
    shifted factorization.  A sweep's converged new pairs augment (X, S)
    (``normalize_schur_pair``); a sweep that converges nothing restarts from
    a fresh random vector (``np.random.default_rng(seed)``, as the JAX
    package draws them).  ``restarts`` defaults to ``neigs + 2`` sweeps.

    Returns ``(D, Q[, info])``: the original problem's eigenpairs as captured
    at convergence (``u = v + X (lam I - S)^{-1} w``, unit columns), sorted
    by ``errmeasure`` (default: the backward error ``||M(lam) u|| /
    sum_i |f_i(lam)| ||A_i||_F`` on the host).  ``info``: ``t_factorize``,
    ``t_scan``, ``t_check`` (host Ritz checks, all sweeps), ``theta``,
    ``sweeps`` (converged pairs per sweep), ``nconv``, ``m_per_sweep`` and,
    per sweep, ``t_check_sweeps``, ``k_done_sweeps`` (scan steps),
    ``max_abs_T`` (0 for the undeflated first sweep), ``graph_sweeps`` (how
    the steps ran: :meth:`~neptpu_torch.solvers.scan_graph.StepGraph.stats`)
    and ``hessenberg_sweeps``.  ``device=None`` is the card."""
    from ..models.deflation import normalize_schur_pair
    from ..ops.partitioned import build_spmf_shift_solver

    device = resolve_device(device)
    mats, fv = collect_spmf_terms(nep)
    n = mats[0].shape[0]
    m = int(maxit)
    dt = to_torch_dtype(dtype)
    if tol is None:
        tol = 1e4 * float(torch.finfo(dt).eps)
    if restarts is None:
        restarts = int(neigs) + 2
    bank = make_mixed_bank(mats, dtype=to_numpy_dtype(dt), device=device)

    with trace.clock("nt.factorize") as fact:
        solver = build_spmf_shift_solver(mats, fv, sigma, dtype=dt,
                                         device=device)
        if solver is None:
            solver = spmf_shift_block_lu(mats, fv, sigma, dtype=dt,
                                         device=device)
        _sync(device)
    t_fact = fact.seconds

    # the deflated scan runs in the theta-scaled Taylor space only
    Cre, Cim = spmf_coeff_table(fv, sigma, gamma, m, scaled=True)
    theta = auto_theta(Cre, Cim, m, dt)
    Cre, Cim = apply_theta(Cre, Cim, theta)
    m_fin = finite_table_prefix(Cre, Cim, dt)
    if m_fin < m:
        m = m_fin
        Cre, Cim = Cre[:, : m + 1], Cim[:, : m + 1]
    # the extension folds w-block content into v'_0 = X t_0, whose j=0 term
    # M(sigma) X t_0 must not be dropped: column 0 holds f_i(sigma) (without
    # deflation the pre-solve block 0 is zero, so it changes nothing)
    f0 = spmf_fun_scalars(fv, sigma)
    Cre[:, 0], Cim[:, 0] = f0.real, f0.imag

    fro = np.array([np.sqrt(np.abs(A.multiply(A.conj())).sum())
                    for A in mats])
    rn0 = _spmf_host_resnorm(mats, fv)

    def backward(lam, u):
        scale = float(np.abs(spmf_fun_scalars(fv, lam)) @ fro)
        return rn0(lam, u) / scale

    meas = errmeasure if errmeasure is not None else backward

    rng = np.random.default_rng(seed)
    X = np.zeros((n, 0), dtype=complex)
    S = np.zeros((0, 0), dtype=complex)
    sweeps, t_checks, max_T, k_done = [], [], [], []
    graphs, hessenbergs = [], []
    found = []  # (lam, recovered original eigvec) captured at convergence
    t_scan = 0.0
    for _ in range(int(restarts)):
        p = X.shape[1]
        if p >= neigs:
            break
        defl = None if p == 0 else DeflationOps.build(
            X, S, sigma, gamma * theta, m, dt, device=device)
        max_T.append(0.0 if defl is None else defl.max_abs_T())

        def rn_ext(lam, q, p=p, X=X, S=S):
            # original-problem error of the recovered eigvec
            # u = v + X (lam I - S)^{-1} w  (Effenberger recovery)
            if p == 0:
                u = q
            else:
                w = np.linalg.solve(complex(lam) * np.eye(p) - S,
                                    np.asarray(q[n:]))
                u = np.asarray(q[:n]) + X @ w
            nu = np.linalg.norm(u)
            return meas(lam, u / nu) if nu > 0 else np.inf

        if v is not None and p == 0:
            v0 = np.asarray(v, dtype=complex)
        else:
            v0 = (rng.standard_normal(n + p)
                  + 1j * rng.standard_normal(n + p))
        lams, Q, info = run_iar_real(
            bank, m, Cre, Cim, 0.0, v0, solver, dt,
            sigma=sigma, gamma=gamma, neigs=neigs - p, tol=tol,
            resnorm=rn_ext, n=n + p, check_error_every=check_error_every,
            scaled=True, theta=theta, defl=defl, device=device)
        t_scan += info["t_scan"]
        t_checks.append(info["t_check"])
        k_done.append(info["k_done"])
        graphs.append(info["graph"])
        hessenbergs.append(info["hessenberg"])
        sweeps.append(info["nconv"])
        if info["nconv"] == 0:
            continue  # a fresh random start next sweep
        # multi-augment the invariant pair with this sweep's converged new
        # pairs: V1 = [X, v_j...], S1 = [[S, w_j...], [0, diag(lam_j)]]
        eigS = np.linalg.eigvals(S) if p else np.array([])
        newV, newW, newL = [], [], []
        for j in range(len(lams)):
            la = complex(lams[j])
            if eigS.size and np.min(np.abs(la - eigS)) < 1e-8 * max(
                    1.0, abs(la)):
                continue  # numerically a duplicate (should not happen)
            if newL and np.min(np.abs(la - np.asarray(newL))) < 1e-8 * max(
                    1.0, abs(la)):
                continue
            newV.append(np.asarray(Q[:n, j]))
            newW.append(np.asarray(Q[n:, j]) if p else np.zeros(0))
            newL.append(la)
            # the recovered original-problem eigvec, captured now (the
            # invariant pair's conditioning can cost the final eig(S) digits)
            if p:
                wj = np.linalg.solve(la * np.eye(p) - S, newW[-1])
                uj = newV[-1] + X @ wj
            else:
                uj = newV[-1]
            found.append((la, uj / np.linalg.norm(uj)))
        if not newL:
            continue
        k = len(newL)
        V1 = np.concatenate([X] + [vv[:, None] for vv in newV], axis=1)
        S1 = np.zeros((p + k, p + k), dtype=complex)
        S1[:p, :p] = S
        for j in range(k):
            S1[:p, p + j] = newW[j]
            S1[p + j, p + j] = newL[j]
        S, X = normalize_schur_pair(S1, V1)

    # eigenpairs as captured at convergence, sorted by the error measure
    if found:
        D = np.array([la for la, _ in found])
        Q = np.stack([u for _, u in found], axis=1)
        order = np.argsort([meas(D[j], Q[:, j]) for j in range(len(D))])
        D, Q = D[order], Q[:, order]
    else:
        D = np.zeros(0, dtype=complex)
        Q = np.zeros((n, 0), dtype=complex)
    info = {"t_factorize": t_fact, "t_scan": t_scan,
            "t_check": float(sum(t_checks)), "theta": theta,
            "sweeps": sweeps, "nconv": int(len(D)), "m_per_sweep": m,
            "t_check_sweeps": t_checks, "max_abs_T": max_T,
            "k_done_sweeps": k_done, "graph_sweeps": graphs,
            "hessenberg_sweeps": hessenbergs}
    if return_info:
        return D, Q, info
    return D, Q
