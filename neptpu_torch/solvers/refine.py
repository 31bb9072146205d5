"""Eigenpair refinement: per-pair Newton (nonlinear inverse iteration) to
reference-class backward errors.

The float32 scan converges to backward errors around the float32 floor
(~1e-6).  :func:`newton_refine` closes the gap to 1e-9..1e-11 with residuals,
eigenvalue updates and the per-shift solves in complex128 on the HOST (scipy
``splu`` of M at a slightly offset shift per pair — the ``host`` backend).
The batched on-device backend of the JAX package (``BatchedShiftSMW``) is not
ported yet: asking for it raises.
"""
from __future__ import annotations

import numpy as np

__all__ = ["spmf_fun_derivs", "newton_refine"]


def spmf_fun_derivs(fv, lam, k=2):
    """D[i, j] = f_i^{(j)}(lam), j = 0..k-1, complex128 on the host."""
    lam = complex(lam)
    D = np.zeros((len(fv), k), dtype=complex)
    for i, f in enumerate(fv):
        if hasattr(f, "derivs"):
            D[i] = f.derivs(lam, k)
        else:
            from ..ops.matfun import fun_derivatives

            D[i] = fun_derivatives(f, lam, k).numpy()
    return D


class _TermOps:
    """Batched host-side SPMF residual machinery: all terms stacked into ONE
    tall CSR so each sweep pays a single SpMM ``A_all @ Q`` -> (nt, n, k),
    contracted against per-pair derivative weights with one einsum."""

    def __init__(self, csr, fv):
        import scipy.sparse as sp

        self.fv = fv
        self.nt = len(csr)
        self.n = csr[0].shape[0]
        self.A_all = sp.vstack(csr, format="csr")

    def weights(self, lams, nder=1):
        """W[i, d, j] = f_i^{(d)}(lams[j]) — complex128 (nt, nder, k)."""
        W = np.empty((self.nt, nder, len(lams)), dtype=complex)
        for j, la in enumerate(lams):
            W[:, :, j] = spmf_fun_derivs(self.fv, la, nder)
        return W

    def apply(self, Q):
        """(nt, n, k) stack of per-term products A_i @ Q, one SpMM."""
        return np.asarray(self.A_all @ Q).reshape(self.nt, self.n, -1)

    @staticmethod
    def contract(T, w):
        """sum_i w[i, j] * T[i, :, j] -> (n, k)."""
        return np.einsum("tnk,tk->nk", T, w)


def _chip_backend_missing():
    return NotImplementedError(
        "newton_refine backend='chip' (the batched on-device per-shift "
        "factorization, BatchedShiftSMW of neptpu/ops/partitioned.py) is not "
        "ported to neptpu_torch yet (ROADMAP queue A); use backend='host'")


def newton_refine(mats, fv, lams, Q, *, nsweeps=2, tol=None,
                  errmeasure=None, dtype=None, p=16, plan=None, ir=0,
                  shift_rel=1e-8, backend="host", target_distinct=None,
                  _second_pass=False):
    """Per-pair nonlinear inverse iteration ``v <- M(sig_j)^{-1} M'(lam_j) v``
    with a least-squares eigenvalue update, residuals in complex128 on the
    host.  Each pair's shift ``sig_j`` sits a relative ``shift_rel`` off its
    eigenvalue estimate (bounding the condition of M(sig_j)).

    ``backend``: ``"host"`` (scipy splu per shift) or ``"auto"`` (host below
    2n = 2e5, the JAX package's crossover); ``"chip"``, or ``"auto"`` above
    the crossover, raises ``NotImplementedError``.  ``dtype``, ``p`` and
    ``ir`` configure the chip backend and are unused here.
    Returns ``(lams, Q, errs)``."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    del dtype, p, ir  # chip-backend options
    lams = np.array(lams, dtype=complex, copy=True)
    Q = np.array(Q, dtype=complex, copy=True)
    k = len(lams)
    if k == 0:
        return lams, Q, np.zeros(0)
    if backend not in ("chip", "host", "auto"):
        raise ValueError(f"backend must be chip|host|auto, got {backend!r}")
    csr = [A.tocsr() for A in mats]
    if backend == "auto":
        from ..ops.partitioned import ShiftPlan

        if plan is None:
            plan = ShiftPlan(mats, fv)
        # crossover kept from the JAX package (measured there on a TPU, to
        # be re-measured on the card): host splu until 2n passes 2e5
        backend = "chip" if (plan.ok and 2 * plan.n > 2e5) else "host"
    if backend == "chip":
        raise _chip_backend_missing()
    # host sweeps are cheap (k SpMVs + triangular solves); weakly converged
    # Ritz pairs need several frozen-shift contractions
    nsweeps = max(int(nsweeps), 6)
    sig_f = lams + 1j * shift_rel * np.maximum(np.abs(lams), 1.0)
    # exact scipy splu per shift; aligned banks give every term one pattern,
    # so the weighted sum is one (nt,) @ (nt, nnz) GEMV
    A0 = csr[0]
    aligned = all(
        A.nnz == A0.nnz and np.array_equal(A.indices, A0.indices)
        and np.array_equal(A.indptr, A0.indptr) for A in csr[1:])
    if aligned:
        Dstack = np.stack([A.data.astype(complex) for A in csr])
    lus = []
    for j in range(k):
        w = spmf_fun_derivs(fv, sig_f[j], 1)[:, 0]
        if aligned:
            M = sp.csr_matrix((w @ Dstack, A0.indices, A0.indptr),
                              shape=A0.shape)
        else:
            M = None
            for wi, A in zip(w, csr):
                T = A.astype(complex) * wi
                M = T if M is None else M + T
        lus.append(spla.splu(M.tocsc()))

    ops = _TermOps(csr, fv)
    # an errmeasure callable may carry a batched form under ``.batch``
    err_batch = getattr(errmeasure, "batch", None)

    def meas_vec(lams_v, Qm):
        if err_batch is not None:
            return np.asarray(err_batch(lams_v, Qm), dtype=float)
        if errmeasure is not None:
            return np.array([float(errmeasure(lams_v[j], Qm[:, j]))
                             for j in range(len(lams_v))])
        return np.linalg.norm(
            ops.contract(ops.apply(Qm), ops.weights(lams_v, 1)[:, 0]), axis=0)

    errs = meas_vec(lams, Q)
    for _ in range(nsweeps):
        if tol is not None and np.all(errs < tol):
            break
        T = ops.apply(Q)                       # (nt, n, k), one SpMM
        W = ops.weights(lams, 2)
        Mq = ops.contract(T, W[:, 0])
        Mpq = ops.contract(T, W[:, 1])
        # least-squares eigenvalue update lam = argmin ||M(lam) q||
        denom = np.einsum("nk,nk->k", np.conj(Mpq), Mpq).real
        num = np.einsum("nk,nk->k", np.conj(Mpq), Mq)
        step = np.where(denom > 0, num / np.where(denom > 0, denom, 1.0), 0)
        cand = lams - step
        # inverse-iteration RHS at the updated eigenvalues: M'(cand) q
        R = ops.contract(T, ops.weights(cand, 2)[:, 1])
        Y = np.stack([lus[j].solve(R[:, j]) for j in range(k)], axis=1)
        newQ = Y / np.linalg.norm(Y, axis=0, keepdims=True)
        # accept the first improving combo of (new lam, new q) /
        # (old lam, new q) / (new lam, old q), per pair; never worse
        pend = np.arange(k)
        for li, Qi in ((cand, newQ), (lams.copy(), newQ), (cand, Q.copy())):
            if not len(pend):
                break
            e = meas_vec(li[pend], Qi[:, pend])
            hit = e < errs[pend]
            idx = pend[hit]
            lams[idx] = li[idx]
            Q[:, idx] = Qi[:, idx]
            errs[idx] = e[hit]
            pend = pend[~hit]

    def _distinct_done():
        """``target_distinct`` distinct pairs already below tol."""
        if target_distinct is None:
            return False
        good = np.nonzero(errs < tol)[0]
        sel = []
        for j in good[np.argsort(errs[good])]:
            if all(abs(lams[j] - lams[i]) > 1e-7 * max(1.0, abs(lams[j]))
                   for i in sel):
                sel.append(j)
        return len(sel) >= int(target_distinct)

    # stragglers get up to four more passes, each with a fresh factorization
    # at the now-better eigenvalue estimates
    passes = 0
    while (tol is not None and not _second_pass and passes < 4
           and np.any(errs >= tol) and not _distinct_done()):
        bad = np.nonzero(errs >= tol)[0]
        lb, Qb, eb = newton_refine(
            mats, fv, lams[bad], Q[:, bad], nsweeps=nsweeps, tol=tol,
            errmeasure=errmeasure, plan=plan, shift_rel=shift_rel,
            backend="host", _second_pass=True)
        improved = False
        for t, j in enumerate(bad):
            if eb[t] < errs[j]:
                lams[j], Q[:, j], errs[j] = lb[t], Qb[:, t], eb[t]
                improved = True
        passes += 1
        if not improved:
            break
    return lams, Q, errs
