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
from ..ops.mixed import make_mixed_bank
from .iar_real import (apply_theta, auto_theta, block_assemble_lu,
                       run_iar_real)

__all__ = [
    "collect_spmf_terms",
    "spmf_coeff_table",
    "finite_table_prefix",
    "spmf_fun_scalars",
    "spmf_shift_block_lu",
    "iar_real_spmf",
    "iar_real_spmf_multishift",
]


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
    w = spmf_fun_scalars(fv, sigma)
    M0 = None
    for wi, A in zip(w, mats):
        T = (A * wi) if sp.issparse(A) else sp.csr_matrix(np.asarray(A) * wi)
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
        t_bank = time.perf_counter() - t0

    t0 = time.perf_counter()
    if lu_piv is None:
        from ..ops.partitioned import build_spmf_shift_solver

        lu_piv = build_spmf_shift_solver(mats, fv, sigma, dtype=dt,
                                         device=device)
        if lu_piv is None:  # bulk neither banded nor arrow: dense block LU
            lu_piv = spmf_shift_block_lu(mats, fv, sigma, dtype=dt,
                                         device=device)
        _sync(device)
    t_fact = time.perf_counter() - t0

    # 'auto': classic Taylor space unless its table overflows ``dt`` before
    # ``maxit`` — then the theta-scaled space
    t0 = time.perf_counter()
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
    t_table = time.perf_counter() - t0
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
