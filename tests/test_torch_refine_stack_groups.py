"""The Newton refinement's residual products stacked by row support
(``refine._TermOps``): the terms whose nonempty rows are the same form one
group, stacked over those rows only.  Each case holds the grouped
``contract(apply(Q), w)`` to the per-term sum of ``w_i A_i Q`` over the terms'
own CSR and, bit for bit, to the contraction of one tall stack of all terms
(no two groups that share a row interleave in term order in these cases),
checks the groups, and the counters ``nt.refine.stack_rows`` (rows a product
computes) and ``nt.refine.stack_rows_full`` (rows the tall stack would), on
the CPU."""
import numpy as np
import pytest
import scipy.sparse as sp

from torch_port_helpers import CPU

import neptpu_torch
from neptpu_torch import trace
from neptpu_torch.solvers import refine as trefine
from neptpu_torch.solvers.spmf_real import collect_spmf_terms

WEP = dict(nx=29, nz=21, benchmark_problem="JARLEBRING", neptype="SPMF")


def _gallery(name, **kw):
    mats, fv = collect_spmf_terms(neptpu_torch.nep_gallery(name, device=CPU,
                                                           **kw))
    return [A.tocsr() for A in mats], fv


def _synthetic(aligned):
    """Three terms on n = 60.  ``aligned=False``: each covers every row.
    ``aligned=True``: the terms share one stored pattern, as terms collected
    from an aligned bank do, with explicit zeros: the second is nonzero on
    rows 10..19 only, the third nowhere."""
    rng = np.random.default_rng(7)
    n = 60
    pattern = (sp.random(n, n, density=0.1, random_state=rng)
               + sp.eye(n)).tocsr()
    csr = []
    for t in range(3):
        A = pattern.copy().astype(complex)
        A.data = rng.standard_normal(A.nnz) + 1j * rng.standard_normal(A.nnz)
        if aligned and t:
            keep = np.zeros(n, dtype=bool)
            keep[10:20] = t == 1
            A.data[~np.repeat(keep, np.diff(A.indptr))] = 0.0
        csr.append(A)
    return csr, [None] * 3


CASES = {
    # the reduced waveguide: one term on every row, two on the interior
    # rows, and the boundary terms, nz on each side's nz rows
    "wep_small": (lambda: _gallery("waveguide", **WEP), 4),
    # K and M on every row, W1 on 19 rows, W2 on 65
    "gun_like": (lambda: _gallery("gun_like"), 3),
    "full_rows": (lambda: _synthetic(aligned=False), 1),
    "aligned_zeros": (lambda: _synthetic(aligned=True), 2),
}


def _support(A):
    C = A.copy()
    C.eliminate_zeros()
    return np.flatnonzero(np.diff(C.indptr))


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_products_equal_the_per_term_sum(case):
    build, ngroups = CASES[case]
    csr, fv = build()
    ops = trefine._TermOps(csr, fv)
    n, nt, k = ops.n, len(csr), 5
    rng = np.random.default_rng(11)
    Q = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
    w = rng.standard_normal((nt, k)) + 1j * rng.standard_normal((nt, k))
    with trace.collect() as c:
        got = ops.contract(ops.apply(Q), w)
    want = sum(w[i] * (A @ Q) for i, A in enumerate(csr))
    assert np.linalg.norm(got - want) <= 1e-15 * np.linalg.norm(want)
    tall = sp.vstack(csr, format="csr")
    tall.eliminate_zeros()
    T = np.asarray(tall @ Q).reshape(nt, n, k)
    assert np.array_equal(got, np.einsum("tnk,tk->nk", T, w))
    assert len(ops.groups) == ngroups
    # each term in the one group of its own nonempty rows
    supports = [_support(A) for A in csr]
    for rows, terms, A in ops.groups:
        # slot 0, the sum so far, then the group's terms on its rows
        assert A.shape == ((1 + terms.size) * rows.size, n)
        assert A[:rows.size].nnz == 0
        for t in terms:
            assert np.array_equal(supports[t], rows)
    grouped = sorted(t for _, terms, _ in ops.groups for t in terms)
    assert grouped == [t for t in range(nt) if supports[t].size]
    rows = sum(s.size for s in supports)
    assert c.counters() == {"nt.refine.stack_rows": rows,
                            "nt.refine.stack_rows_full": nt * n}
    assert c.totals()["nt.refine.residual"]["calls"] == 2


def test_full_rows_are_one_tall_stack():
    """Where every term covers every row the one group is the tall stack of
    all terms, under its empty slot 0."""
    csr, fv = _synthetic(aligned=False)
    ops = trefine._TermOps(csr, fv)
    (rows, terms, A), = ops.groups
    assert np.array_equal(rows, np.arange(ops.n))
    assert np.array_equal(terms, np.arange(len(csr)))
    assert A[:ops.n].nnz == 0
    assert (A[ops.n:] != sp.vstack(csr, format="csr")).nnz == 0
    assert ops.stack_rows == len(csr) * ops.n


def test_refinement_counts_every_product():
    """A host refinement of two rough pairs on the reduced waveguide, its
    default measure included: every product counts the grouped rows and the
    full stack's, at the share of the grouping, under the residual span."""
    csr, fv = _gallery("waveguide", **WEP)
    rng = np.random.default_rng(5)
    n = csr[0].shape[0]
    Q = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    with trace.collect() as c:
        trefine.newton_refine(csr, fv, [-2.7 - 3.2j, -3.1 - 3.6j], Q,
                              backend="host", nsweeps=1)
    got = c.counters()
    rows = sum(_support(A).size for A in csr)
    products = got["nt.refine.stack_rows_full"] // (len(csr) * n)
    assert products >= 3        # the first measure, a sweep, a candidate's
    assert got["nt.refine.stack_rows_full"] == products * len(csr) * n
    assert got["nt.refine.stack_rows"] == products * rows
    assert rows < len(csr) * n / 5
    spans = c.totals()
    assert spans["nt.refine.residual"]["calls"] >= 2 * products
    assert spans["nt.refine.residual"]["seconds"] <= spans["nt.refine"][
        "seconds"]
