"""The Newton refinement's held term forms (``refine._held``): a call on the
terms of the last call reuses their ``_TermOps`` with every form it built
(the row-support groups, ``_UnionTerms``, the ``ShiftPlan`` and its device
form), and gives the bits a call on fresh copies of the terms gives; a term
edited in place, a replaced term function or another term list builds them
anew, the old forms gone before the new are built; a passed ``plan``
serves its call alone; the forms go when their terms go, and terms given
in another format than CSR are never held.
Counters ``nt.refine.ops_built`` and ``nt.refine.ops_held``; CPU, port
only."""
import copy
import gc
import weakref

import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, SMALL_GAMMA, SMALL_SIGMA, small_gun_like

import neptpu_torch as nt
from neptpu_torch import trace
from neptpu_torch.ops import partitioned
from neptpu_torch.solvers import refine
from neptpu_torch.solvers.spmf_real import collect_spmf_terms

BACKENDS = ["host", "chip"]
# the form each backend builds besides the groups: the host splu's union
# pattern, the chip factorization's plan
FORM = {"host": "_UnionTerms", "chip": "ShiftPlan"}
UPLOAD = "nt.refine.chip.upload_bytes"


@pytest.fixture(scope="module")
def pairs():
    from neptpu_torch.models.gallery.nlevp import _gun_from_matrices

    nep = _gun_from_matrices(*small_gun_like(nx=24), device=CPU)
    mats, fv = collect_spmf_terms(nep)
    lams, Q = nt.iar_real_spmf(nep, sigma=SMALL_SIGMA, gamma=SMALL_GAMMA,
                               maxit=24, neigs=4, tol=1e-3,
                               dtype=torch.float64, device=CPU)
    return mats, fv, lams, Q


@pytest.fixture
def terms(pairs):
    """Term objects of this test alone."""
    mats, fv, lams, Q = pairs
    return copy.deepcopy(mats), copy.deepcopy(fv), lams, Q


def _held_ops():
    """The held ``_TermOps``."""
    return refine._held[1]


def _counted(monkeypatch):
    """Builds of each host form, by class name."""
    built = {}
    for mod, name in ((refine, "_TermOps"), (refine, "_UnionTerms"),
                      (partitioned, "ShiftPlan")):
        def counted(*a, _name=name, _cls=getattr(mod, name), **kw):
            built[_name] = built.get(_name, 0) + 1
            return _cls(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return built


def _refine(mats, fv, lams, Q, backend, **kw):
    with trace.collect() as col:
        out = nt.newton_refine(mats, fv, lams, Q, backend=backend, nsweeps=2,
                               tol=1e-12, ir=3, device=CPU, **kw)
    return out, col.counters()


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("backend", BACKENDS)
def test_second_call_builds_nothing_and_matches_a_fresh_one(monkeypatch,
                                                            terms, backend):
    mats, fv, lams, Q = terms
    built = _counted(monkeypatch)
    first, c1 = _refine(mats, fv, lams, Q, backend)
    assert built["_TermOps"] == 1 and built[FORM[backend]] == 1
    built.clear()
    second, c2 = _refine(mats, fv, lams, Q, backend)
    assert built == {}
    assert c1["nt.refine.ops_built"] == c2["nt.refine.ops_held"] == 1
    assert "nt.refine.ops_held" not in c1 and "nt.refine.ops_built" not in c2
    fresh, _ = _refine(copy.deepcopy(mats), copy.deepcopy(fv), lams, Q,
                       backend)
    assert _same(second, fresh) and _same(first, fresh)


def test_second_chip_call_uploads_the_weights_alone(terms):
    mats, fv, lams, Q = terms
    _, c1 = _refine(mats, fv, lams, Q, "chip")
    _, c2 = _refine(mats, fv, lams, Q, "chip")
    form = _held_ops().plan.on_device(torch.device(CPU))
    # every batch's (shifts, terms) complex128 weights, and nothing else
    shifts = c2["nt.refine.chip.shifts"] + c2["nt.refine.chip.fallbacks"]
    assert c2[UPLOAD] == 16 * shifts * (len(form.bulk_idx)
                                        + len(form.lr_terms))
    assert c1[UPLOAD] == c2[UPLOAD] + form.nbytes


@pytest.mark.parametrize("backend", BACKENDS)
def test_term_edited_in_place_rebuilds(monkeypatch, terms, backend):
    mats, fv, lams, Q = terms
    _refine(mats, fv, lams, Q, backend)
    mats[1].data *= 1 + 1e-3
    built = _counted(monkeypatch)
    got, c = _refine(mats, fv, lams, Q, backend)
    assert built["_TermOps"] == 1 and c["nt.refine.ops_built"] == 1
    fresh, _ = _refine(copy.deepcopy(mats), copy.deepcopy(fv), lams, Q,
                       backend)
    assert _same(got, fresh)


@pytest.mark.parametrize("backend", BACKENDS)
def test_replaced_term_function_rebuilds(monkeypatch, terms, backend):
    mats, fv, lams, Q = terms
    first, _ = _refine(mats, fv, lams, Q, backend)
    fv[2] = copy.deepcopy(fv[2])         # in the list the first call saw
    built = _counted(monkeypatch)
    got, c = _refine(mats, fv, lams, Q, backend)
    assert built["_TermOps"] == 1 and c["nt.refine.ops_built"] == 1
    assert _held_ops().fv[2] is fv[2]
    fresh, _ = _refine(copy.deepcopy(mats), copy.deepcopy(fv), lams, Q,
                       backend)
    assert _same(got, fresh) and _same(got, first)


@pytest.mark.parametrize("backend", BACKENDS)
def test_passed_plan_serves_its_call_alone(terms, backend):
    mats, fv, lams, Q = terms
    first, _ = _refine(mats, fv, lams, Q, backend)
    held = _held_ops()
    before = held.__dict__.get("plan")   # the chip's held plan; none on the host
    passed = partitioned.ShiftPlan(mats, fv)
    got, c = _refine(mats, fv, lams, Q, backend, plan=passed)
    assert c["nt.refine.ops_held"] == 1 and _held_ops() is held
    assert held.__dict__.get("plan") is before
    assert (backend == "chip") == bool(passed._on_device)
    assert _same(got, first)


@pytest.mark.parametrize("backend", BACKENDS)
def test_another_term_list_replaces_the_entry(monkeypatch, terms, backend):
    mats, fv, lams, Q = terms
    other = copy.deepcopy(mats), fv     # equal matrices, other objects
    built = _counted(monkeypatch)
    runs = [_refine(m, f, lams, Q, backend)
            for m, f in ((mats, fv), other, (mats, fv))]
    assert built["_TermOps"] == built[FORM[backend]] == 3
    assert [c.get("nt.refine.ops_built") for _, c in runs] == [1, 1, 1]
    assert refine._held[0][0]() is mats[0]
    assert _same(runs[0][0], runs[1][0]) and _same(runs[0][0], runs[2][0])


@pytest.mark.parametrize("backend", BACKENDS)
def test_old_forms_go_before_the_new_are_built(monkeypatch, terms, backend):
    mats, fv, lams, Q = terms
    _refine(mats, fv, lams, Q, backend)
    old = weakref.ref(_held_ops())
    seen = []
    real = refine._TermOps

    def build(*a, **kw):
        seen.append(old())
        return real(*a, **kw)

    monkeypatch.setattr(refine, "_TermOps", build)
    _refine(copy.deepcopy(mats), fv, lams, Q, backend)
    assert seen == [None]


@pytest.mark.parametrize("backend", BACKENDS)
def test_held_forms_go_with_their_terms(pairs, backend):
    mats, fv = copy.deepcopy(pairs[0]), copy.deepcopy(pairs[1])
    _, c = _refine(mats, fv, *pairs[2:], backend)
    assert c["nt.refine.ops_built"] == 1
    held = weakref.ref(_held_ops())
    form = weakref.ref(getattr(_held_ops(), {"host": "union",
                                             "chip": "plan"}[backend]))
    del mats
    gc.collect()
    assert refine._held is None and held() is None and form() is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_terms_in_another_format_are_never_held(monkeypatch, terms,
                                                backend):
    mats, fv, lams, Q = terms
    csc = [A.tocsc() for A in mats]
    built = _counted(monkeypatch)
    runs = [_refine(csc, fv, lams, Q, backend) for _ in range(2)]
    assert built["_TermOps"] == built[FORM[backend]] == 2
    assert [c.get("nt.refine.ops_built") for _, c in runs] == [1, 1]
    assert refine._held is None
    assert _same(runs[0][0], runs[1][0])
