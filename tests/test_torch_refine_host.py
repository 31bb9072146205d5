"""The host backend's shifted factorizations (``refine._host_shift_lus``
over the terms' ``refine._UnionTerms``): M(sig) assembled over their union
pattern, and SuperLU's symmetric ordering with threshold pivoting where that
pattern is structurally symmetric, against scipy's default ``splu`` of the
summed CSR matrix and against the JAX package's host refinement, on the
CPU."""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from torch_port_helpers import CPU, backward_errmeasure

import neptpu
import neptpu_torch
from neptpu_torch import trace
from neptpu_torch.solvers import refine as trefine
from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                            iar_real_spmf, spmf_fun_scalars)

jrefine = importlib.import_module("neptpu.solvers.refine")
jspmf = importlib.import_module("neptpu.solvers.spmf_real")

# gun_like's band, as the benchmark's refined traffic sweeps it
BAND = 15000.0 + 100j + 1000.0 * np.arange(10)
SIGMA, GAMMA = 2.0e4 + 100j, 1.0e4
WEP = dict(nx=29, nz=21, benchmark_problem="JARLEBRING", neptype="SPMF")
SPLU = spla.splu
SYMMETRIC = dict(permc_spec="MMD_AT_PLUS_A",
                 diag_pivot_thresh=trefine.SYMMETRIC_PIVOT_THRESH,
                 options=dict(SymmetricMode=True))


def _summed(csr, fv, sig):
    """M(sig) as the CSR sum of the weighted terms, scipy's default form."""
    w = trefine.spmf_fun_derivs(fv, sig, 1)[:, 0]
    return sum(wi * A.astype(complex) for wi, A in zip(w, csr)).tocsc()


def _fill(lu):
    return lu.L.nnz + lu.U.nnz


class _SpluLog:
    """``scipy.sparse.linalg.splu`` that records each call's matrix, options
    and factor; ``default=True`` drops the options, giving scipy's call."""

    def __init__(self, default=False):
        self.default = default
        self.calls = []

    def __call__(self, A, **opts):
        lu = SPLU(A) if self.default else SPLU(A, **opts)
        self.calls.append((A, opts, lu))
        return lu


@pytest.fixture(scope="module")
def gun():
    nep = neptpu_torch.nep_gallery("gun_like", device=CPU)
    mats, fv = collect_spmf_terms(nep)
    return dict(nep=nep, mats=mats, fv=fv, csr=[A.tocsr() for A in mats])


# ten shifts of the band: the same solves as scipy's default splu (1e-12),
# never more fill, and every factorization took the symmetric ordering
def test_gun_like_shift_lus_match_the_default_splu(gun, monkeypatch):
    csr, fv = gun["csr"], gun["fv"]
    terms = trefine._UnionTerms(csr)
    assert terms.symmetric
    log = _SpluLog()
    monkeypatch.setattr(spla, "splu", log)
    with trace.collect() as col:
        lus = trefine._host_shift_lus(terms, fv, BAND)
    monkeypatch.undo()
    assert [opts for _, opts, _ in log.calls] == [SYMMETRIC] * 10
    rng = np.random.default_rng(0)
    fill = 0
    for j, sg in enumerate(BAND):
        M = _summed(csr, fv, sg)
        ref = spla.splu(M)
        r = rng.standard_normal(M.shape[0]) + 1j * rng.standard_normal(
            M.shape[0])
        x, x0 = lus[j].solve(r), ref.solve(r)
        assert np.linalg.norm(x - x0) / np.linalg.norm(x0) < 1e-12
        assert np.linalg.norm(M @ x - r) / np.linalg.norm(r) < 1e-12
        assert _fill(lus[j]) <= _fill(ref) and lus[j].nnz <= ref.nnz
        fill += lus[j].nnz
    c = col.counters()
    assert c["nt.refine.factorizations"] == 10
    assert c["nt.refine.lu_fill"] == fill


# the small waveguide: its union pattern is not symmetric, so every splu is
# scipy's default call
def test_unsymmetric_pattern_keeps_the_default_call(monkeypatch):
    mats, fv = collect_spmf_terms(neptpu_torch.nep_gallery(
        "waveguide", device=CPU, **WEP))
    csr = [A.tocsr() for A in mats]
    terms = trefine._UnionTerms(csr)
    assert not terms.symmetric
    log = _SpluLog()
    monkeypatch.setattr(spla, "splu", log)
    sig = np.array([-3 - 3.5j, -1.2 - 1.6j])
    with trace.collect() as col:
        lus = trefine._host_shift_lus(terms, fv, sig)
    monkeypatch.undo()
    assert [opts for _, opts, _ in log.calls] == [{}, {}]
    assert col.counters()["nt.refine.factorizations"] == 2
    r = np.random.default_rng(1).standard_normal(csr[0].shape[0]) + 0j
    for j, sg in enumerate(sig):
        ref = spla.splu(_summed(csr, fv, sg))
        assert np.array_equal(lus[j].perm_c, ref.perm_c)
        x0 = ref.solve(r)
        assert np.linalg.norm(lus[j].solve(r) - x0) / np.linalg.norm(x0) \
            < 1e-12


def _int_terms(aligned, n=40, nt=4, seed=3):
    """Integer-valued terms (every weighted sum of them exact in floating
    point): ``aligned`` - one shared pattern with explicit zeros stored, as
    an aligned bank keeps it; else each its own pattern, one of them
    unsymmetric; the first term holds no zero."""
    rng = np.random.default_rng(seed)
    if aligned:
        P = sp.random(n, n, density=0.1, random_state=seed, format="csr")
        P = (P + P.T + sp.eye(n)).tocsr()
        out = []
        for t in range(nt):
            data = rng.integers(1, 5, P.nnz).astype(float)
            if t:
                data[rng.random(P.nnz) < 0.3] = 0.0     # explicit zeros
            out.append(sp.csr_matrix((data, P.indices.copy(),
                                      P.indptr.copy()), shape=(n, n)))
        return out
    out = [sp.random(n, n, density=0.08, random_state=seed + t,
                     format="csr", data_rvs=lambda k: rng.integers(1, 9, k))
           for t in range(nt)]
    out[0] = (out[0] + sp.eye(n)).tocsr()
    return out


# the union-pattern contraction is the summed CSR matrix, entry for entry
@pytest.mark.parametrize("aligned", [True, False])
def test_union_assembly_equals_the_csr_sum(aligned):
    csr = _int_terms(aligned)
    terms = trefine._UnionTerms(csr)
    w = np.array([3 - 2j, -1 + 1j, 2 + 0j, -4 - 3j])
    M = terms.matrix(w)
    ref = sum(wi * A.astype(complex) for wi, A in zip(w, csr)).tocsc()
    assert M.format == "csc" and M.has_sorted_indices
    assert (M - ref).count_nonzero() == 0
    assert np.array_equal(M.toarray(), ref.toarray())
    pattern = sum(abs(A) for A in csr)
    pattern.eliminate_zeros()
    assert terms.symmetric == (
        ((pattern != 0) != (pattern.T != 0)).nnz == 0)
    assert terms.symmetric == aligned


@pytest.fixture(scope="module")
def gun_pairs(gun):
    """Candidates from a short float32 scan of gun_like on the CPU (backward
    errors 2e-6..6e-5), and the backward error of both packages' tests."""
    meas = backward_errmeasure(gun["mats"], gun["fv"], spmf_fun_scalars)
    lams, Q = iar_real_spmf(gun["nep"], sigma=SIGMA, gamma=GAMMA, maxit=20,
                            neigs=16, tol=1e-3, check_error_every=20,
                            dtype=torch.float32, errmeasure=meas, device=CPU)
    return np.asarray(lams), np.asarray(Q), meas


def _distinct(lams, errs, tol=1e-9):
    sel = []
    for j in np.argsort(errs):
        if errs[j] < tol and all(abs(lams[j] - lams[i]) > 1e-7 * abs(lams[j])
                                 for i in sel):
            sel.append(j)
    return len(sel)


# host refinement at gun_like, its shifts 1e-8 relative off the eigenvalues
# (M(sig) nearly singular), to the benchmark's 1e-9 and to the smoke run's
# 1e-11: as many distinct pairs below tol as with the default splu, the JAX
# package's eigenvalues (rel 1e-9), and no factor with more fill than the
# default's of the same matrix
@pytest.mark.parametrize("tol", [1e-9, 1e-11])
def test_gun_like_host_refinement_matches_default_and_jax(gun, gun_pairs,
                                                          monkeypatch, tol):
    lams, Q, meas = gun_pairs
    kw = dict(nsweeps=3, tol=tol, errmeasure=meas, backend="host",
              shift_rel=1e-8, target_distinct=10)
    log = _SpluLog()
    monkeypatch.setattr(spla, "splu", log)
    tl, _, te = trefine.newton_refine(gun["mats"], gun["fv"], lams, Q, **kw)
    monkeypatch.setattr(spla, "splu", _SpluLog(default=True))
    dl, _, de = trefine.newton_refine(gun["mats"], gun["fv"], lams, Q, **kw)
    monkeypatch.undo()
    assert log.calls and all(opts == SYMMETRIC for _, opts, _ in log.calls)
    for A, _, lu in log.calls:
        assert _fill(lu) <= _fill(spla.splu(A))
    assert _distinct(tl, te, tol) == _distinct(dl, de, tol) >= 10
    jmats, jfv = jspmf.collect_spmf_terms(neptpu.nep_gallery("gun_like"))
    jl, _, je = jrefine.newton_refine(jmats, jfv, lams, Q, **kw)
    assert np.array_equal(te < 1e-9, je < 1e-9)
    ok = te < 1e-9
    assert np.max(np.abs(tl[ok] - jl[ok]) / np.abs(jl[ok])) < 1e-9
