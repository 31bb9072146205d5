"""Eigenpair refinement: per-pair Newton (nonlinear inverse iteration) to
reference-class backward errors.

The float32 scan converges to backward errors around the float32 floor
(~1e-6).  :func:`newton_refine` closes the gap to 1e-9..1e-11: residuals and
eigenvalue updates run in complex128 on the host, the per-pair shifted solves
either on the host (the ``host`` backend: an exact complex128 scipy ``splu``
of M at a slightly offset shift per pair, M assembled over the terms' union
pattern, and SuperLU's symmetric minimum-degree ordering with threshold
pivoting where that pattern is structurally symmetric, its default COLAMD
and partial pivoting elsewhere) or on the device through one batched
per-shift factorization (:class:`neptpu_torch.ops.partitioned.
BatchedShiftSMW`: float32 SPIKE + SMW factors with float64 iterative
refinement — the ``chip`` backend).  :func:`resinv_refine` polishes against
the scan's own frozen factorization instead, with no new one.
"""
from __future__ import annotations

import functools
import weakref

import numpy as np

from ..core import trace

__all__ = ["spmf_fun_derivs", "newton_refine", "resinv_refine"]


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
    """Batched host-side SPMF residual machinery, the terms stacked by row
    support.  Terms whose nonempty rows are the same form a group: its rows
    ``r``, its term indices ``t`` and one CSR stacking those terms restricted
    to ``r``.  ``apply(Q)`` pays one SpMM a group, and ``contract`` sums
    each group's products against its terms' weights into the output's rows
    ``r``: the same products and sums as one tall stack of all nt terms over
    all n rows, with the rows that hold no entry left out (at the waveguide
    each of the 210 boundary terms touches 105 of 11655 rows).  Where every
    term covers every row there is one group, and that tall stack.  It
    holds the terms' other host forms too, each built on first use and then
    kept: ``union`` (:class:`_UnionTerms`, for the host splu) and ``plan``
    (a :class:`ShiftPlan`, for the chip factorization)."""

    def __init__(self, csr, fv):
        import scipy.sparse as sp

        self.csr = csr
        self.fv = fv
        self.nt = len(csr)
        self.n = n = csr[0].shape[0]
        stack = sp.vstack(csr, format="csr")
        # terms collected from an aligned bank share the union pattern and
        # carry explicit zeros (9 in 10 stored entries at waveguide size):
        # dropped, so a term's support is the rows it really touches
        stack.eliminate_zeros()
        full = np.diff(stack.indptr).reshape(self.nt, n) > 0
        by_support = {}
        for t in range(self.nt):
            by_support.setdefault(full[t].tobytes(), []).append(t)
        self.groups = []
        for terms in by_support.values():
            rows = np.flatnonzero(full[terms[0]])
            if rows.size:
                terms = np.array(terms)
                # |rows| empty rows on top: slot 0 of the group's product,
                # which ``contract`` fills with the sum so far
                self.groups.append((rows, terms, sp.vstack(
                    [sp.csr_matrix((rows.size, n)),
                     stack[(terms[:, None] * n + rows).ravel()]],
                    format="csr")))
        self.stack_rows = sum(r.size * t.size for r, t, _ in self.groups)

    def weights(self, lams, nder=1):
        """W[i, d, j] = f_i^{(d)}(lams[j]) — complex128 (nt, nder, k)."""
        W = np.empty((self.nt, nder, len(lams)), dtype=complex)
        for j, la in enumerate(lams):
            W[:, :, j] = spmf_fun_derivs(self.fv, la, nder)
        return W

    def apply(self, Q):
        """The per-term products A_i @ Q on their groups' rows: one SpMM a
        group, -> a complex (1 + |t|, |r|, k) stack, slot 0 ``contract``'s
        and the products of the group's terms after it."""
        with trace.span("nt.refine.residual"):
            trace.count("nt.refine.stack_rows", self.stack_rows)
            trace.count("nt.refine.stack_rows_full", self.nt * self.n)
            return [np.asarray(A @ Q, dtype=complex).reshape(
                t.size + 1, r.size, -1) for r, t, A in self.groups]

    def contract(self, stacks, w):
        """sum_i w[i, j] * (A_i @ Q)[:, j] -> (n, k), from ``apply(Q)``.

        Each group's einsum takes the sum so far of its rows in slot 0 at
        weight 1, so every row adds its terms' products one at a time in
        term order, as one tall stack of all terms would: the same bits
        wherever no two groups that share a row interleave in term
        order."""
        with trace.span("nt.refine.residual"):
            k = w.shape[1]
            out = np.zeros((self.n, k), dtype=complex)
            one = np.ones((1, k))
            for (rows, terms, _), T in zip(self.groups, stacks):
                T[0] = out[rows]
                out[rows] = np.einsum("tnk,tk->nk", T,
                                      np.concatenate([one, w[terms]]))
            return out

    @functools.cached_property
    def union(self):
        return _UnionTerms(self.csr)

    @functools.cached_property
    def plan(self):
        from ..ops.partitioned import ShiftPlan

        with trace.span("nt.refine.plan"):
            return ShiftPlan(self.csr, self.fv)


_held = None   # (weak refs to the terms, their _TermOps) of the last call


def _term_ops(mats, fv):
    """The :class:`_TermOps` of these terms.

    Where the terms are CSR, the forms are built on copies of them and held
    while the caller's matrices live, and a later call reuses them only
    where its terms are those matrices and functions one by one, with
    arrays equal, exactly, in value and type, to the copies.  Terms in
    another format are converted anew every call and so never held.  Any
    call that does not reuse the held forms drops them."""
    global _held
    csr = [A.tocsr() for A in mats]
    held = _held
    if held is not None and _reuses(held, csr, fv):
        trace.count("nt.refine.ops_held")
        return held[1]
    _held = held = None     # the old forms go before the new are built
    trace.count("nt.refine.ops_built")
    if any(A is not B for A, B in zip(mats, csr)):
        return _TermOps(csr, fv)
    ops = _TermOps([A.copy() for A in csr], list(fv))
    _held = [weakref.ref(A, _let_go) for A in csr], ops
    return ops


def _reuses(held, csr, fv):
    refs, ops = held
    return (len(refs) == len(csr) and len(ops.fv) == len(fv)
            and all(r() is A for r, A in zip(refs, csr))
            and all(f is g for f, g in zip(ops.fv, fv))
            and all(_equal(A, B) for A, B in zip(csr, ops.csr)))


def _equal(A, B):
    return A.shape == B.shape and all(
        a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in ((A.data, B.data), (A.indices, B.indices),
                     (A.indptr, B.indptr)))


def _let_go(ref):
    """A held term matrix is gone: the forms of its terms go with it."""
    global _held
    if _held is not None and any(r is ref for r in _held[0]):
        _held = None


def _refine_batch_limit(plan, p=8, budget_bytes=6.0e9):
    """Largest shift-batch whose solver state fits the device-memory budget.

    Per-shift footprint of :class:`BatchedShiftSMW` (ir mode): float32 block
    inverses + reduced inverse, float64 block-tridiag matvec form, float64
    HALF SMW operands (Xh, Lh, Uh — R columns each, the rot_i commutation
    halving).  The default budget is the JAX package's, kept for parity
    until it is re-measured on the card."""
    n2 = 2 * plan.n
    b2 = 2 * max(plan.b, 1) + 1
    blk = -(-n2 // p)
    rank = sum(L.shape[1] for _, L, _ in plan.lr) + 2 * plan.m
    Rh = max(rank, 1)
    per = (4 * (p * blk * blk + (2 * b2 * p) ** 2)      # fac + reduced
           + 8 * 3 * n2 * b2                            # D64/B64/C64
           + 8 * 3 * n2 * Rh                            # X64h, Lh64, Uh64
           + 12 * n2 * b2)                              # strips (f32 + f64)
    return max(1, int(budget_bytes // per))


# SuperLU's diagonal pivot threshold where the terms' union pattern is
# structurally symmetric.  There it orders by minimum degree on A + A^T and
# keeps a diagonal pivot of at least this share of its column's largest
# entry (UMFPACK's symmetric strategy defaults to the same 0.001).  At
# gun_like (n = 9956, one CPU core, one BLAS thread) that halves the
# factors: on ten shifts of its band 367k entries in L and U against COLAMD
# with partial pivoting's 821k, 37-50 ms a factorization against 75-92 ms,
# at the same solve residual (4e-14).  A larger threshold lets pivots leave
# the diagonal where the refinement factors, 1e-8 off an eigenvalue: there
# 0.01 leaves it at 1.6-1.8 % of the columns and stores 608k entries
# against 0.001's 383k-391k, and 0.1 stores 3.0M-3.4M.
SYMMETRIC_PIVOT_THRESH = 0.001


class _UnionTerms:
    """The terms over the union of their patterns, in CSC order: ``terms``,
    a sparse (union entries, terms) matrix that holds the terms' nonzeros,
    so that ``matrix(w)``, the CSC matrix of ``sum_i w[i] A_i``, takes its
    data from one sparse product ``terms @ w`` over fixed indices - work in
    the terms' nonzeros, and no BLAS call.  ``symmetric``: the union
    pattern equals its transpose's."""

    def __init__(self, csr):
        import scipy.sparse as sp

        self.shape = csr[0].shape
        n = self.shape[0]
        keys, data, term = [], [], []
        for t, A in enumerate(csr):
            C = A.copy()
            C.eliminate_zeros()
            C = C.tocsc()
            C.sum_duplicates()
            col = np.repeat(np.arange(n, dtype=np.int64), np.diff(C.indptr))
            keys.append(col * n + C.indices)
            data.append(C.data)
            term.append(np.full(C.nnz, t, dtype=np.int32))
        key = np.concatenate(keys)
        order = np.argsort(key, kind="stable")
        key = key[order]
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        self.terms = sp.csr_matrix(
            (np.concatenate(data)[order], np.concatenate(term)[order],
             np.r_[starts, key.size]), shape=(starts.size, len(csr)))
        key_u = key[starts]
        row, col = key_u % n, key_u // n
        self.indices = row.astype(np.int32)
        self.indptr = np.searchsorted(col, np.arange(n + 1)).astype(np.int32)
        self.symmetric = np.array_equal(np.sort(row * n + col), key_u)

    def matrix(self, w):
        import scipy.sparse as sp

        return sp.csc_matrix(
            (self.terms @ np.asarray(w, dtype=complex), self.indices,
             self.indptr), shape=self.shape)


def _host_shift_lus(terms, fv, sig_f):
    """An exact complex128 scipy ``splu`` of M(sig) at each shift, M(sig)
    assembled over the terms' union pattern (``terms``, a
    :class:`_UnionTerms`).  Where that pattern is structurally symmetric,
    SuperLU orders by minimum degree on A + A^T with threshold pivoting
    (``SYMMETRIC_PIVOT_THRESH``), its mode for such matrices; elsewhere it
    keeps its defaults (COLAMD, partial pivoting).  Counts each
    factorization and the entries of L and U that SuperLU stores."""
    import scipy.sparse.linalg as spla

    opts = {}
    if terms.symmetric:
        opts = dict(permc_spec="MMD_AT_PLUS_A",
                    diag_pivot_thresh=SYMMETRIC_PIVOT_THRESH,
                    options=dict(SymmetricMode=True))
    lus = {}
    for j, sg in enumerate(sig_f):
        lus[j] = spla.splu(terms.matrix(spmf_fun_derivs(fv, sg, 1)[:, 0]),
                           **opts)
        trace.count("nt.refine.factorizations")
        trace.count("nt.refine.lu_fill", lus[j].nnz)
    return lus


def _validate_shifts(ops, sig_f, bsolver, rel_tol=1e-6, seed=123):
    """One random-probe solve per shift against the host float64 residual;
    returns the indices of the shifts whose relative residual exceeds
    ``rel_tol`` (the mixed-precision SPIKE + SMW chain can still lose a shift
    whose BANDED bulk alone is near-singular); those go to a host splu."""
    k = len(sig_f)
    probe = np.random.default_rng(seed).standard_normal((ops.n, k))
    yre, yim = bsolver.solve_pairs(probe, np.zeros_like(probe))
    Y = yre + 1j * yim
    W = ops.weights(sig_f, 1)[:, 0]          # (nt, k)
    My = ops.contract(ops.apply(Y), W)       # batched residual matvecs
    rel = np.linalg.norm(My - probe, axis=0) / np.linalg.norm(probe, axis=0)
    return [int(j) for j in np.nonzero(~np.isfinite(rel) | (rel > rel_tol))[0]]


class _HostBatchSolver:
    """The host backend's batch solver: one scipy ``splu`` of M at each
    pair's shift ``sig``, applied column by column."""

    def __init__(self, lus, sig):
        self.lus = lus
        self.sig = sig

    def solve(self, R):
        return np.stack([self.lus[j].solve(R[:, j])
                         for j in range(R.shape[1])], axis=1)


def newton_refine(mats, fv, lams, Q, *, nsweeps=2, tol=None,
                  errmeasure=None, dtype=None, p=16, bsolver=None, plan=None,
                  ir=0, shift_rel=1e-8, return_solver=False, max_batch=None,
                  backend="chip", target_distinct=None, device=None,
                  stats=None, _second_pass=False):
    """Per-pair nonlinear inverse iteration ``v <- M(sig_j)^{-1} M'(lam_j) v``
    with a least-squares eigenvalue update, residuals in complex128 on the
    host.  Each pair's shift ``sig_j`` sits a relative ``shift_rel`` off its
    eigenvalue estimate (bounding the condition of M(sig_j)); solve
    inexactness multiplies the CORRECTION, not the iterate, so float32
    device factors do not cap the attainable backward error.

    ``backend``: ``"chip"`` factors all shifts in one batched
    :class:`BatchedShiftSMW` on ``device`` (default: the card), in
    memory-sized chunks of at most ``max_batch`` shifts; ``"host"`` uses a
    scipy splu per shift; ``"auto"`` picks the host below 2n = 2e5 (the JAX
    package's crossover, not yet re-measured on the card).  ``dtype``, ``p``
    and ``ir`` configure the chip backend; the host backend's splu is
    :func:`_host_shift_lus`'s.  ``stats``: a dict that, when
    given, accumulates over all chunks and passes ``"chip_shifts"`` (shifts
    factored and solved on the device) and ``"host_fallback_shifts"`` (shifts
    of the chip backend whose probe solve failed validation and went to a
    host splu instead); a traced call counts the same under
    ``nt.refine.chip.shifts`` and ``nt.refine.chip.fallbacks``.

    ``bsolver``: the batch solver of an earlier call (``return_solver=True``)
    with one shift a pair.  On the chip backend it is a
    :class:`BatchedShiftSMW`, used without factorization or chunking but
    probe-validated as a new one is, so a shift that fails still goes to a
    host splu (as in the JAX package).  On the host backend it is the host's
    batch of splu factors, reused only where it was factored at these very
    shifts and refactored otherwise (the JAX package always refactors; the
    factors are the same).  Returns ``(lams, Q, errs)``, and the batch
    solver of the first pass as a fourth item with ``return_solver=True``
    (None where the pairs went in chunks or there were none).

    The terms' host forms (the row-support groups, the union pattern, the
    ``ShiftPlan`` and its device form) are held across calls for the last
    term list of CSR matrices, built on copies of them, while the matrices
    live: a call reuses them only where ``mats`` and ``fv`` are the held
    objects one by one and the matrices' arrays equal, exactly, the copies;
    any other call builds them anew.  A passed ``plan`` serves its call
    only."""
    with trace.span("nt.refine"):
        lams = np.array(lams, dtype=complex, copy=True)
        Q = np.array(Q, dtype=complex, copy=True)
        k = len(lams)
        if k == 0:
            return (lams, Q, np.zeros(0)) + ((None,) if return_solver else ())
        if backend not in ("chip", "host", "auto"):
            raise ValueError(
                f"backend must be chip|host|auto, got {backend!r}")
        # ONE partition count for both the memory budget and the solver
        p = min(int(p), 8)
        with trace.span("nt.refine.ops"):
            ops = _term_ops(mats, fv)

        def shift_plan():
            # a passed plan serves this call only; the held one is built on
            # first use
            return ops.plan if plan is None else plan

        if backend == "auto":
            # the JAX package's crossover, not yet re-measured on the card;
            # below it the host whatever the plan says, so no plan is built
            backend = ("chip" if 2 * ops.n > 2e5 and shift_plan().ok
                       else "host")
        if backend == "host":
            # host sweeps are cheap (k SpMVs + triangular solves); weakly
            # converged Ritz pairs need several frozen-shift contractions
            nsweeps = max(int(nsweeps), 6)
        else:
            import torch

            from ..config import resolve_device
            from ..ops.partitioned import BATCH_SIZES, BatchedShiftSMW

            device = resolve_device(device)
            if dtype is None:
                dtype = torch.float32
        # an errmeasure callable may carry a batched form under ``.batch``
        err_batch = getattr(errmeasure, "batch", None)

        def measure(lams_v, Qm):
            with trace.span("nt.refine.measure"):
                if err_batch is not None:
                    return np.asarray(err_batch(lams_v, Qm), dtype=float)
                if errmeasure is not None:
                    return np.array([float(errmeasure(lams_v[j], Qm[:, j]))
                                     for j in range(len(lams_v))])
                return np.linalg.norm(ops.contract(
                    ops.apply(Qm), ops.weights(lams_v, 1)[:, 0]), axis=0)

        def run_pass(lams, Q, bsolver):
            """One pass over the pairs: factor at their offset shifts (or
            take ``bsolver``), then up to ``nsweeps`` sweeps."""
            lams = np.array(lams, dtype=complex, copy=True)
            Q = np.array(Q, dtype=complex, copy=True)
            k = len(lams)
            sig_f = lams + 1j * shift_rel * np.maximum(np.abs(lams), 1.0)
            if backend == "host":
                if bsolver is None or not np.array_equal(bsolver.sig, sig_f):
                    with trace.span("nt.refine.factor"):
                        bsolver = _HostBatchSolver(
                            _host_shift_lus(ops.union, fv, sig_f), sig_f)
                solve = bsolver.solve
            else:
                with trace.span("nt.refine.factor"):
                    if bsolver is None:
                        # factor at OFFSET shifts: an eigenvalue-accurate
                        # shift makes M(lam_j) singular to ~the backward
                        # error, and the float32-seeded refinement diverges
                        # once kappa * eps_f32 > 1
                        bsolver = BatchedShiftSMW(
                            mats, fv, sig_f, dtype=dtype, p=p,
                            plan=shift_plan(), ir=ir, device=device)
                        trace.count("nt.refine.factorizations", k)
                    # one probe solve a shift, a passed solver's too: a
                    # shift whose solve fails goes to a host splu
                    bad = _validate_shifts(ops, sig_f, bsolver)
                    lus = (_host_shift_lus(ops.union, fv, sig_f[bad])
                           if bad else {})
                trace.count("nt.refine.chip.shifts", k - len(bad))
                trace.count("nt.refine.chip.fallbacks", len(bad))
                if stats is not None:
                    stats["chip_shifts"] = (
                        stats.get("chip_shifts", 0) + k - len(bad))
                    stats["host_fallback_shifts"] = (
                        stats.get("host_fallback_shifts", 0) + len(bad))

                def solve(R):
                    yre, yim = bsolver.solve_pairs(R.real, R.imag)
                    Y = yre + 1j * yim
                    for t, j in enumerate(bad):
                        Y[:, j] = lus[t].solve(R[:, j])
                    return Y

            errs = measure(lams, Q)
            for _ in range(int(nsweeps)):
                if tol is not None and np.all(errs < tol):
                    break
                with trace.span("nt.refine.sweep"):
                    T = ops.apply(Q)             # one SpMM a row-support group
                    W = ops.weights(lams, 2)
                    Mq = ops.contract(T, W[:, 0])
                    Mpq = ops.contract(T, W[:, 1])
                    # least-squares eigenvalue update lam = argmin ||M(lam) q||
                    denom = np.einsum("nk,nk->k", np.conj(Mpq), Mpq).real
                    num = np.einsum("nk,nk->k", np.conj(Mpq), Mq)
                    step = np.where(denom > 0,
                                    num / np.where(denom > 0, denom, 1.0), 0)
                    cand = lams - step
                    # inverse-iteration RHS at the updated eigenvalues
                    Y = solve(ops.contract(T, ops.weights(cand, 2)[:, 1]))
                    newQ = Y / np.linalg.norm(Y, axis=0, keepdims=True)
                # accept the first improving combo of (new lam, new q) /
                # (old lam, new q) / (new lam, old q), per pair; never worse
                pend = np.arange(k)
                for li, Qi in ((cand, newQ), (lams.copy(), newQ),
                               (cand, Q.copy())):
                    if not len(pend):
                        break
                    e = measure(li[pend], Qi[:, pend])
                    hit = e < errs[pend]
                    idx = pend[hit]
                    lams[idx] = li[idx]
                    Q[:, idx] = Qi[:, idx]
                    errs[idx] = e[hit]
                    pend = pend[~hit]
            return lams, Q, errs, bsolver

        def distinct_done(lams, errs):
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

        # memory-aware chunking: each chunk gets its OWN factorization
        # (built, used for all sweeps, freed), in even sizes (5+5, not 9+1)
        size = k
        if backend == "chip" and bsolver is None and not _second_pass:
            if max_batch is None:
                lim = _refine_batch_limit(shift_plan(), p=p)
                fits = [c for c in BATCH_SIZES if c <= lim]
                max_batch = fits[-1] if fits else lim
            size = -(-k // -(-k // max_batch))
        if size < k:
            target_distinct = None
        # stragglers get more passes, each with a fresh factorization at the
        # now-better eigenvalues (host refactors are cheap: up to four)
        max_passes = 0 if tol is None or _second_pass else (
            4 if backend == "host" else 2)
        errs = np.zeros(k)
        for s0 in range(0, k, size):
            sl = slice(s0, s0 + size)
            ls, Qs, es, solver = run_pass(lams[sl], Q[:, sl], bsolver)
            for _ in range(max_passes):
                if not np.any(es >= tol) or distinct_done(ls, es):
                    break
                bad = np.nonzero(es >= tol)[0]
                lb, Qb, eb, _ = run_pass(ls[bad], Qs[:, bad], None)
                hit = eb < es[bad]
                ls[bad[hit]], Qs[:, bad[hit]], es[bad[hit]] = (
                    lb[hit], Qb[:, hit], eb[hit])
                if not hit.any():
                    break
            lams[sl], Q[:, sl], errs[sl] = ls, Qs, es
        if return_solver:
            return lams, Q, errs, solver if size == k else None
        return lams, Q, errs


def resinv_refine(mats, fv, solver, lams, Q, *, nsweeps=3, tol=None,
                  errmeasure=None):
    """Polish eigenpairs ``(lams[j], Q[:, j])`` by residual inverse iteration
    against ``solver``, a ``solve_pair`` object factored at the IAR shift
    (reused — no new factorization).  ``errmeasure(lam, q)`` drives the
    optional early exit at ``tol`` and the returned error vector.

    Returns ``(lams, Q, errs)`` with unit columns; a pair that fails to
    improve keeps its best-so-far iterate.  Frozen-shift residual inverse
    iteration amplifies the shift-closest eigendirections in every other
    pair's correction, so each correction is projected out of the span of
    the current set before it is applied; the attainable floor is then set by
    cross-contamination inside the span (~1e-9 backward on the gun/WEP
    class) — for 1e-10+ floors use :func:`newton_refine`."""
    import torch

    from .iar_real import as_pair_solver

    solver = as_pair_solver(solver)
    lams = np.array(lams, dtype=complex, copy=True)
    Q = np.array(Q, dtype=complex, copy=True)
    k = len(lams)
    if k == 0:
        return lams, Q, np.zeros(0)
    n = Q.shape[0]
    csr = [A.tocsr() for A in mats]

    def meas(lam, q):
        if errmeasure is not None:
            return float(errmeasure(lam, q))
        D = spmf_fun_derivs(fv, lam, 1)[:, 0]
        return float(np.linalg.norm(sum(wi * (A @ q)
                                        for wi, A in zip(D, csr))))

    errs = np.array([meas(lams[j], Q[:, j]) for j in range(k)])
    ref = solver.X if getattr(solver, "X", None) is not None else (
        solver.base.strips if hasattr(solver, "base") else solver.lu)

    for _ in range(int(nsweeps)):
        if tol is not None and np.all(errs < tol):
            break
        # eigenvalue update + residual, all pairs, host complex128
        R = np.zeros((n, k), dtype=complex)
        cand = lams.copy()
        for j in range(k):
            D = spmf_fun_derivs(fv, lams[j], 2)
            Aq = [A @ Q[:, j] for A in csr]
            Mq = sum(D[i, 0] * Aq[i] for i in range(len(csr)))
            Mpq = sum(D[i, 1] * Aq[i] for i in range(len(csr)))
            # one-dim Newton on u^H M(lam) q with u = q (Rayleigh functional)
            denom = np.vdot(Q[:, j], Mpq)
            if denom != 0:
                cand[j] = lams[j] - np.vdot(Q[:, j], Mq) / denom
                Dn = spmf_fun_derivs(fv, cand[j], 1)[:, 0]
                Mq = sum(Dn[i] * Aq[i] for i in range(len(csr)))
            R[:, j] = Mq
        # device correction: dq = M(sigma)^{-1} r, all pairs in one block
        dre, dim_ = solver.solve_pair(
            torch.as_tensor(R.real).to(device=ref.device, dtype=ref.dtype),
            torch.as_tensor(R.imag).to(device=ref.device, dtype=ref.dtype))
        dq = (dre.to(torch.float64).cpu().numpy()
              + 1j * dim_.to(torch.float64).cpu().numpy())
        Uo, _ = np.linalg.qr(Q)
        dq = dq - Uo @ (Uo.conj().T @ dq)
        newQ = Q - dq
        newQ = newQ / np.linalg.norm(newQ, axis=0, keepdims=True)
        for j in range(k):
            e = meas(cand[j], newQ[:, j])
            if e < errs[j]:  # accept lam and q together, else keep both
                lams[j] = cand[j]
                Q[:, j] = newQ[:, j]
                errs[j] = e
    return lams, Q, errs
