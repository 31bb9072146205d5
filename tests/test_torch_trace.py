"""The port's spans and counters (``neptpu_torch.trace``): the no-op when
nobody traces, nesting and self time, the spans in the profiler's trace,
the spans the solvers record beside their ``info`` times, the counters of
the refinement's factorizations and of the chip backend's shifts and host
fallbacks, the scan's host peeks and the pairs they measure, the
refinement's passes, the scan's SMW correction, and the benchmark's readers
of the waveguide cell's spans and counters.  This file imports no JAX; its
``cuda`` case runs on the card with

    python -m pytest --noconftest tests/test_torch_trace.py -m cuda -q
"""
import json
import time

import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, SMALL_GAMMA, SMALL_SIGMA, small_gun_like

import neptpu_torch as nt
from neptpu_torch import trace
from neptpu_torch.solvers.spmf_real import collect_spmf_terms

# the scan entries' ``info`` as it was before the spans (``iar_real``, and
# ``iar_real_spmf`` with the bank, table and theta keys beside)
INFO_KEYS = {"t_scan", "t_check", "nconv", "k_done", "errs", "graph",
             "hessenberg", "t_factorize", "scaled", "theta"}
SPMF_INFO_KEYS = INFO_KEYS | {"t_bank", "t_table"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA events time the card")
    return torch.device("cuda")


@pytest.fixture
def tiny_dep():
    """The 24 x 24 delay problem of the benchmark's CPU cells, with the
    scan's arguments of its traffic (maxit 30, 4 pairs, checks every
    10 steps), in float64 to an absolute residual of 1e-8."""
    nep = nt.nep_gallery("dep_symm_double", 24, device=CPU)
    kw = dict(sigma=-1.0, gamma=1.0, maxit=30, neigs=4, tol=1e-8,
              dtype=torch.float64, check_error_every=10, return_info=True,
              device=CPU)
    return nep, kw


def test_nothing_traced_gives_the_shared_noop():
    before = (trace.profiled().totals(), trace.profiled().counters())
    first = trace.span("nt.test.a")
    assert first is trace.span("nt.test.b", device=True)
    with first as sp:
        trace.count("nt.test.calls")
    assert sp.seconds == 0.0
    assert (trace.profiled().totals(), trace.profiled().counters()) == before
    # a clock reads its time all the same
    with trace.clock("nt.test.clock") as c:
        time.sleep(0.002)
    assert c.seconds >= 0.002


def test_nesting_parents_self_time_and_counts():
    with trace.collect() as col:
        with trace.span("nt.test.outer"):
            time.sleep(0.004)
            with trace.span("nt.test.inner"):
                time.sleep(0.004)
                trace.count("nt.test.calls")
            with trace.span("nt.test.inner"):
                trace.count("nt.test.calls", 2)
            time.sleep(0.002)
        with trace.clock("nt.test.after") as c:
            pass
    spans = col.spans()
    assert [s["name"] for s in spans] == ["nt.test.outer", "nt.test.inner",
                                          "nt.test.inner", "nt.test.after"]
    assert [s["parent"] for s in spans] == [None, 0, 0, None]
    assert all(s["device_ms"] is None for s in spans)
    tot = col.totals()
    outer, inner = tot["nt.test.outer"], tot["nt.test.inner"]
    assert inner["calls"] == 2 and outer["calls"] == 1
    assert outer["self_seconds"] == pytest.approx(
        outer["seconds"] - inner["seconds"], abs=1e-9)
    assert outer["self_seconds"] >= 0.006 and inner["seconds"] >= 0.004
    assert inner["self_seconds"] == pytest.approx(inner["seconds"])
    assert tot["nt.test.after"]["seconds"] == pytest.approx(c.seconds)
    assert col.counters() == {"nt.test.calls": 3}
    # a block outside the request records nothing into it
    with trace.span("nt.test.later"):
        pass
    assert len(col.spans()) == 4


def test_spans_nest_in_the_profilers_chrome_trace(tmp_path, tiny_dep):
    from torch.profiler import ProfilerActivity, profile

    nep, kw = tiny_dep
    trace.profiled().clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            nt.iar_real(nep, **kw)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    user = [e for e in events if e.get("cat") == "user_annotation"]
    caller = next(e for e in user if e["name"] == "caller")
    names = {e["name"] for e in user}
    assert {"nt.factorize", "nt.factorize.assemble", "nt.scan.table",
            "nt.scan", "nt.scan.check", "nt.scan.check.extract",
            "nt.scan.check.measure"} <= names
    for e in user:
        if e["name"].startswith("nt."):
            assert caller["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= caller["ts"] + caller["dur"]
    # outside any request, the profiled spans went to the profile collector
    tot = trace.profiled().totals()
    assert tot["nt.scan"]["calls"] == 1
    assert tot["nt.scan.check"]["calls"] == tot["nt.scan.check.measure"][
        "calls"] >= 1
    trace.profiled().clear()
    with trace.span("nt.test.after"):  # the profiler stopped
        pass
    assert trace.profiled().totals() == {}


def _scan_spans_hold_info(col, info):
    tot = col.totals()
    assert tot["nt.scan"]["seconds"] == pytest.approx(info["t_scan"])
    assert tot["nt.factorize"]["seconds"] == pytest.approx(
        info["t_factorize"])
    assert tot["nt.scan.check"]["seconds"] == pytest.approx(info["t_check"])
    measure = tot["nt.scan.check.measure"]["seconds"]
    assert info["t_scan"] >= info["t_check"] >= measure > 0.0
    assert tot["nt.factorize.assemble"]["calls"] == 1
    assert tot["nt.scan.check"]["calls"] == info["k_done"] // 10
    spans = col.spans()
    index = {s["name"]: i for i, s in enumerate(spans)}
    for child, parent in (("nt.factorize.assemble", "nt.factorize"),
                          ("nt.scan.check", "nt.scan"),
                          ("nt.scan.check.measure", "nt.scan.check")):
        assert spans[index[child]]["parent"] == index[parent]


def test_iar_real_spans_beside_its_info(tiny_dep):
    nep, kw = tiny_dep
    _, _, plain = nt.iar_real(nep, **kw)
    with trace.collect() as col:
        lams, _, info = nt.iar_real(nep, **kw)
    assert set(plain) == set(info) == INFO_KEYS
    assert len(lams) == 4
    _scan_spans_hold_info(col, info)
    assert col.totals()["nt.scan.table"]["calls"] == 1


def test_iar_real_spmf_spans_beside_its_info(tiny_dep):
    nep, kw = tiny_dep
    with trace.collect() as col:
        lams, _, info = nt.iar_real_spmf(nep, **kw)
    assert set(info) == SPMF_INFO_KEYS
    assert len(lams) == 4
    _scan_spans_hold_info(col, info)
    assert col.totals()["nt.scan.table"]["seconds"] == pytest.approx(
        info["t_table"])
    # on the CPU no step is captured or replayed
    assert "nt.scan.capture" not in col.totals()
    assert "nt.scan.replays" not in col.counters()


def _small_gun_pairs():
    """Pairs of the small gun-structured problem from a float64 scan near
    its bench point, for the refinement to polish."""
    from neptpu_torch.models.gallery.nlevp import _gun_from_matrices

    nep = _gun_from_matrices(*small_gun_like(nx=24), device=CPU)
    mats, fv = collect_spmf_terms(nep)
    lams, Q = nt.iar_real_spmf(nep, sigma=SMALL_SIGMA, gamma=SMALL_GAMMA,
                               maxit=24, neigs=4, tol=1e-3,
                               dtype=torch.float64, device=CPU)
    return mats, fv, lams, Q


def test_host_refinement_counts_a_factorization_a_splu(monkeypatch):
    import scipy.sparse.linalg as spla

    mats, fv, lams, Q = _small_gun_pairs()
    calls = []
    splu = spla.splu

    def counted(A, *args, **kwargs):
        calls.append(A.shape)
        return splu(A, *args, **kwargs)

    monkeypatch.setattr(spla, "splu", counted)
    with trace.collect() as col:
        _, _, errs = nt.newton_refine(mats, fv, lams, Q, nsweeps=3,
                                      tol=1e-12, backend="host")
    tot = col.totals()
    assert calls and col.counters()["nt.refine.factorizations"] == len(calls)
    # the outermost call alone: the straggler passes sit inside it
    assert tot["nt.refine"]["calls"] == 1
    assert tot["nt.refine.factor"]["calls"] >= 1
    assert tot["nt.refine.sweep"]["calls"] >= 1
    assert tot["nt.refine.measure"]["calls"] >= 1
    assert tot["nt.refine"]["seconds"] >= tot["nt.refine.factor"]["seconds"]


def test_chip_backend_spans_replace_its_timings():
    mats, fv, lams, Q = _small_gun_pairs()
    k = len(lams)
    with trace.collect() as col:
        _, _, errs, bsolver = nt.newton_refine(
            mats, fv, lams, Q, nsweeps=2, tol=1e-12, ir=3, backend="chip",
            return_solver=True, device=CPU)
    tot = col.totals()
    assert not hasattr(bsolver, "timings")
    for name in ("nt.refine.plan", "nt.refine.chip.assemble",
                 "nt.refine.chip.factor", "nt.refine.chip.smw"):
        assert tot[name]["calls"] >= 1
    assert "device_ms" not in tot["nt.refine.chip.factor"]  # the CPU
    assert col.counters()["nt.refine.factorizations"] >= k
    spans = col.spans()
    for s in spans:
        if s["name"].startswith("nt.refine.chip."):
            assert spans[s["parent"]]["name"] == "nt.refine.factor"


@pytest.mark.parametrize("failing", [[], [1]])
def test_chip_backend_counts_its_shifts_and_host_fallbacks(monkeypatch,
                                                           failing):
    from neptpu_torch.solvers import refine

    mats, fv, lams, Q = _small_gun_pairs()
    real = refine._validate_shifts
    # a shift whose probe solve fails goes to a host splu
    monkeypatch.setattr(refine, "_validate_shifts", lambda *a, **kw: sorted(
        set(real(*a, **kw)) | {j for j in failing if j < len(a[1])}))
    stats = {}
    with trace.collect() as col:
        nt.newton_refine(mats, fv, lams, Q, nsweeps=2, tol=1e-12, ir=3,
                         backend="chip", stats=stats, device=CPU)
    counters = col.counters()
    assert counters["nt.refine.chip.shifts"] == stats["chip_shifts"] >= 1
    assert counters["nt.refine.chip.fallbacks"] == stats[
        "host_fallback_shifts"] >= len(failing)
    assert counters["nt.refine.chip.shifts"] + counters[
        "nt.refine.chip.fallbacks"] == sum(stats.values())


# maxit 25 at checks every 10 or 7: a short last chunk; 1e-14 is never met
@pytest.mark.parametrize("maxit, every, tol", [(30, 10, 1e-8),
                                               (25, 10, 1e-8),
                                               (30, 7, 1e-14)])
def test_scan_counts_its_peeks_and_the_pairs_they_measure(tiny_dep, maxit,
                                                          every, tol):
    from neptpu_torch.solvers.iar_real import _dep_host_resnorm

    nep, kw = tiny_dep
    resnorm = _dep_host_resnorm(nep)
    measured = []

    def errmeasure(lam, q):
        measured.append(lam)
        return resnorm(lam, q)

    kw = dict(kw, maxit=maxit, check_error_every=every, tol=tol,
              errmeasure=errmeasure)
    with trace.collect() as col:
        _, _, info = nt.iar_real(nep, **kw)
    peeks = col.totals()["nt.scan.check"]["calls"]
    assert peeks == -(-info["k_done"] // every)
    assert col.counters()["nt.scan.check.pairs"] == len(measured) > 0


def _counted_batches(monkeypatch):
    """The shifts of each batched factorization of the chip backend."""
    from neptpu_torch.ops import partitioned

    real, sizes = partitioned.BatchedShiftSMW, []

    def counted(mats, fv, sig, *args, **kwargs):
        sizes.append(len(sig))
        return real(mats, fv, sig, *args, **kwargs)

    monkeypatch.setattr(partitioned, "BatchedShiftSMW", counted)
    return sizes


# chunks of two shifts, each met at its first pass; and one pair started
# 1e-2 off, which one sweep a pass leaves above tol in its first pass and
# in each straggler pass
@pytest.mark.parametrize("case", ["chunked", "straggler"])
def test_refinement_counts_its_passes(monkeypatch, case):
    mats, fv, lams, Q = _small_gun_pairs()
    k = len(lams)
    kw = dict(nsweeps=3, tol=1e-9, ir=3, backend="chip", device=CPU)
    if case == "chunked":
        kw["max_batch"] = 2
    else:
        rng = np.random.default_rng(3)
        lams, Q = lams.copy(), Q.copy()
        lams[0] *= 1 + 1e-5
        Q[:, 0] += 1e-2 * np.linalg.norm(Q[:, 0]) * rng.standard_normal(
            len(Q)) / np.sqrt(len(Q))
        kw["nsweeps"] = 1
    sizes = _counted_batches(monkeypatch)
    with trace.collect() as col:
        _, _, errs = nt.newton_refine(mats, fv, lams, Q, **kw)
    # a pass on the chip backend is one ``nt.refine.factor`` span
    assert col.totals()["nt.refine.factor"]["calls"] == len(sizes)
    if case == "chunked":
        assert sizes == [2, 2] and (errs < 1e-9).all()
    else:
        # one chunk of every pair, then a pass of the straggler alone for
        # each of the two passes a straggler gets
        assert sizes == [k, 1, 1] and errs[0] >= 1e-9
        assert (errs[1:] < 1e-9).all()


# ``_small_gun_pairs`` refined with one sweep a pass towards an unreachable
# 1e-14, so every pass leaves stragglers, the first shift of each chip pass
# sent to a host splu: (lams, errs, Q[:2]) as the recursive newton_refine
# returned them before its passes became one build and two loops
PINNED = {
    "host": (
        [1249.640663791793 + 0.07520507171536074j,
         1266.0748784145167 + 0.548876451822401j,
         1262.5836900292793 + 1.1413114105077966j,
         1232.542356149611 + 0.010256817708211028j],
        [1.510858110430687e-11, 6.03777648053728e-12,
         4.2286249327016854e-12, 9.796341324618884e-12],
        [[-0.00983214820952992 + 0.06455655887728286j,
          -0.005310558001467141 - 0.0024107519416354923j,
          0.014168860000909226 - 0.009884273592699177j,
          -0.04188843591848751 - 0.032480503378018964j],
         [-0.0035102058749107773 + 0.031552600994056566j,
          -0.0030760839984056345 - 0.039044167498842514j,
          -0.02595686218196922 + 0.0037825766234286695j,
          -0.03910841750810303 - 0.02992584317912875j]]),
    "chip": (
        [1249.640663791793 + 0.07520507171536074j,
         1266.0748784145167 + 0.5488764518224162j,
         1262.5836900292793 + 1.1413114105078133j,
         1232.542356149611 + 0.010256817708217222j],
        [1.510858110430687e-11, 3.9490564320386664e-11,
         2.6468781428137354e-13, 2.7525560693517123e-13],
        [[-0.00983214820952992 + 0.06455655887728286j,
          -0.005310557937979492 - 0.0024107520814892545j,
          -0.009884272286456995 - 0.014168860912151202j,
          -0.04188843524639166 - 0.032480504244783576j],
         [-0.0035102058749107773 + 0.031552600994056566j,
          -0.003076082970188234 - 0.039044167579854204j,
          0.003782574230436228 + 0.02595686253068887j,
          -0.039108416888869346 - 0.02992584398836875j]]),
}


# a call builds each host form of its terms once, whatever its passes; a
# second call on the same terms, on the auto backend below the crossover,
# builds none and gives the same bits; and the passes give the pinned pairs
# (to rounding: Q's chip and host paths differ at 1e-8)
@pytest.mark.parametrize("backend", ["host", "chip"])
def test_newton_refine_builds_each_host_form_once(monkeypatch, backend):
    from neptpu_torch.solvers import refine

    mats, fv, lams, Q = _small_gun_pairs()
    real = refine._validate_shifts
    monkeypatch.setattr(refine, "_validate_shifts", lambda *a, **kw: sorted(
        set(real(*a, **kw)) | {0}))
    built = {}
    for name in ("_TermOps", "_UnionTerms"):
        def counted(*a, _name=name, _cls=getattr(refine, name), **kw):
            built[_name] = built.get(_name, 0) + 1
            return _cls(*a, **kw)

        monkeypatch.setattr(refine, name, counted)
    kw = dict(nsweeps=1, tol=1e-14, ir=3, device=CPU)
    with trace.collect() as col:
        tl, tQ, te = nt.newton_refine(mats, fv, lams, Q, backend=backend,
                                      **kw)
    assert col.totals()["nt.refine.factor"]["calls"] == 3
    assert built == {"_TermOps": 1, "_UnionTerms": 1}
    pl, pe, pq = PINNED[backend]
    np.testing.assert_allclose(tl, pl, rtol=1e-14)
    np.testing.assert_allclose(te, pe, rtol=1e-6)
    np.testing.assert_allclose(tQ[:2], pq, rtol=1e-10)
    if backend == "host":
        built.clear()
        with trace.collect() as col:
            al, aQ, ae = nt.newton_refine(mats, fv, lams, Q, backend="auto",
                                          **kw)
        assert "nt.refine.plan" not in col.totals()
        assert built == {}
        assert np.array_equal(al, tl) and np.array_equal(ae, te)
        assert np.array_equal(aQ, tQ)


def test_shifted_solver_records_its_smw_correction_and_rank():
    from neptpu_torch.models.gallery.nlevp import _gun_from_matrices
    from neptpu_torch.ops.partitioned import build_spmf_shift_solver

    nep = _gun_from_matrices(*small_gun_like(nx=24), device=CPU)
    mats, fv = collect_spmf_terms(nep)
    with trace.collect() as col:
        solver = build_spmf_shift_solver(mats, fv, SMALL_SIGMA,
                                         dtype=torch.float64, device=CPU)
    tot = col.totals()
    assert solver.Lh is not None
    assert tot["nt.factorize.smw"]["calls"] == 1
    assert "device_ms" not in tot["nt.factorize.smw"]  # the CPU
    assert col.counters()["nt.factorize.smw_rank"] == solver.Lh.shape[1] >= 1
    spans = col.spans()
    index = {s["name"]: i for i, s in enumerate(spans)}
    assert spans[index["nt.factorize.smw"]]["parent"] is None
    assert index["nt.factorize.assemble"] < index["nt.factorize.smw"]


# the readers of the waveguide cell's spans and counters in the benchmark
WEP_READERS = ("refine_chip_assemble_s", "refine_chip_factor_s",
               "refine_chip_smw_s", "refine_chip_shifts",
               "refine_host_fallbacks", "factorize_smw_s")


def _reader(name):
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from portbench.harness import load_module

    return load_module(os.path.join(repo, "portbench", "layers",
                                    f"{name}.py"), "layers")


@pytest.mark.parametrize("name", WEP_READERS)
def test_wep_readers_give_nothing_without_their_span_or_counter(
        monkeypatch, name):
    import sys

    rec = {"window": {"solves": [{"traced": True}, {"traced": False}]},
           "solves": [{"traced": False}]}
    trace.profiled().clear()
    with trace.collect():  # spans of a request: not the profiled ones
        with trace.span("nt.refine.chip.factor"):
            trace.count("nt.refine.chip.shifts", 4)
    reader = _reader(name)
    assert reader.read(rec) is None
    monkeypatch.setitem(sys.modules, "neptpu_torch.trace", None)
    monkeypatch.delattr(nt, "trace")
    assert reader.read(rec) is None


def test_wep_readers_take_the_profiled_solves():
    from torch.profiler import ProfilerActivity, profile

    rec = {"window": {"solves": [{"traced": True}, {"traced": True},
                                 {"traced": False}]}}
    trace.profiled().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with trace.span("nt.refine.chip.factor"):
                time.sleep(0.002)
            with trace.span("nt.factorize.smw"):
                pass
            trace.count("nt.refine.chip.shifts", 8)
            trace.count("nt.refine.chip.fallbacks", 0)
    tot = trace.profiled().totals()
    read = {name: _reader(name).read(rec) for name in WEP_READERS}
    trace.profiled().clear()
    assert read["refine_chip_shifts"] == 8.0
    assert read["refine_host_fallbacks"] == 0.0
    # no CUDA events on the CPU: the host seconds, a profiled solve
    assert read["refine_chip_factor_s"] == pytest.approx(
        tot["nt.refine.chip.factor"]["seconds"] / 2) and \
        read["refine_chip_factor_s"] >= 0.002
    assert read["factorize_smw_s"] == pytest.approx(
        tot["nt.factorize.smw"]["seconds"] / 2)
    assert read["refine_chip_assemble_s"] is None
    assert read["refine_chip_smw_s"] is None


def test_load_totals_hold_the_import():
    load = trace.load_totals()
    assert load["nt.load.import"]["calls"] == 1
    assert load["nt.load.import"]["seconds"] > 0.0


@pytest.mark.cuda
def test_replayed_steps_resolve_device_time_without_a_synchronize(
        cuda, monkeypatch):
    nep = nt.nep_gallery("dep_symm_double", 24, device=cuda)
    kw = dict(sigma=-1.0, maxit=30, neigs=4, tol=1e-6, check_error_every=10,
              return_info=True, device=cuda)
    nt.iar_real(nep, **kw)  # the first scan sets up cuBLAS and the library
    syncs = []
    real = torch.cuda.synchronize

    def counted(*args, **kwargs):
        syncs.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    _, _, plain = nt.iar_real(nep, **kw)
    untraced = len(syncs)
    syncs.clear()
    with trace.collect() as col:
        _, _, info = nt.iar_real(nep, **kw)
        traced = len(syncs)
    assert traced == untraced
    tot = col.totals()
    replays = col.counters()["nt.scan.replays"]
    assert replays == info["graph"]["replays"] == info["k_done"] - 1
    assert tot["nt.scan.capture"]["calls"] == 1
    assert tot["nt.scan.steps"]["device_ms"] > 0.0
    assert tot["nt.scan.steps"]["calls"] == info["k_done"] // 10
