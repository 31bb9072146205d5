"""A problem given only through the compute-function protocol (the kind
``protocol``), driven by a solver that returns pairs and no scan info (the
entry contract ``"pairs"``): the contour solver ``contour_beyn`` on the
24 x 24 delay problem, whole runs of the harness on the CPU (its look for a
card skipped), its control ``rounded_mder`` among them.  The cell's records
keep the scan cells' keys, and the scan cells' records keep theirs."""
import json
import os
import time
import types

import numpy as np
import pytest

import neptpu_torch
import tiny
from portbench import harness, measures
from portbench.harness import run_cell

CELL = "tiny.contour"
RECORD_KEYS = {"sigma", "latency_s", "t_factorize", "t_scan", "t_check",
               "k_done", "t_refine", "returned", "distinct", "traced"}
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}
# the per-layer metrics whose readers take nothing from a scan's info
METRICS = ("build_s", "load_s", "device_idle_share")
# seconds by which the measure of the returned pairs moves the harness's
# clock, far above a tiny solve's latency
HOUR = 3600.0


def _band(point, half=0.01):
    """A band whose one grid point is ``point``."""
    return {"real": [point - half, point + half], "imag": 0.0, "points": 1}


def checkout(tmp):
    """``tiny.checkout(tmp)`` with the configuration ``dep_tiny_protocol``
    (``dep_tiny``'s grid as the gallery builds it) and its cell
    ``tiny.contour``.  The scan's ``tol`` lies between the pairs' backward
    errors (1.6e-17 on the CPU, 1.7e-17 on an H100) and those under the
    control (3.2e-10, CPU); the rank decision keeps the contour's 1e-6."""
    root = tiny.checkout(tmp)
    base = os.path.join(root, "portbench")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    with open(os.path.join(base, "configs", "dep_tiny.json")) as fh:
        cfg = json.load(fh)
    tiny._dump(dict(cfg, name="dep_tiny_protocol", kind="protocol",
                    scan_dtype="complex128"),
               os.path.join(base, "configs", "dep_tiny_protocol.json"))
    bench["configs"].append({
        "name": "dep_tiny_protocol", "source": cfg["source"][:200],
        "file": "portbench/configs/dep_tiny_protocol.json",
        "reduced": ["grid"], "why": "a small delay problem for the CPU tests"})
    tiny._dump({"entry": "contour_beyn", "returns": "pairs",
                "shift": _band(-1.02),
                "scan": {"radius": 0.02, "N": 64, "k": 24, "neigs": 6,
                         "tol": 1e-12, "rank_drop_tol": 1e-6},
                "k": 3, "correct": {"short_share": 0.6}},
               os.path.join(base, "traffic", "tiny_contour.json"))
    bench["workloads"].append({"name": CELL, "config": "dep_tiny_protocol",
                               "traffic": "tiny_contour", "chips": 1,
                               "why": "CPU test"})
    for m in bench["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append(CELL)
    tiny._dump(bench, os.path.join(root, "BENCHMARK.json"))
    return root


@pytest.fixture
def root(tmp_path):
    return checkout(tmp_path)


def run(root, cell, trace=0, **kw):
    rc, res = run_cell(root, cell, 2**31 + 11, 0.2, trace, device="cpu",
                       **kw)
    assert rc == 0
    return res


def records(monkeypatch):
    """The records of every solve the harness makes from now on."""
    got = []
    call = harness.Solver.__call__

    def recording(self, sigma, annotate=False):
        answer, rec = call(self, sigma, annotate)
        got.append(rec)
        return answer, rec

    monkeypatch.setattr(harness.Solver, "__call__", recording)
    return got


def patch_entry(monkeypatch, wrap):
    real = neptpu_torch.contour_beyn
    monkeypatch.setattr(neptpu_torch, "contour_beyn",
                        lambda *a, **kw: wrap(*real(*a, **kw)))


def test_sound_run_is_correct(root, monkeypatch):
    got = records(monkeypatch)
    res = run(root, CELL)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["short_share"]["value"] == 0.0
    assert set(res) == RESULT_KEYS
    assert all(set(r) == RECORD_KEYS for r in got)
    assert all(r[k] is None for r in got
               for k in ("t_factorize", "t_scan", "t_check", "k_done"))
    assert all(r["distinct"] >= 3 for r in got)


def test_traced_run_is_correct_and_reads_its_metrics(root):
    res = run(root, CELL, trace=1)
    assert res["correct"] and res["failed"] == 0
    assert res["metrics"]["build_s"]["value"] > 0
    assert res["device"]["window_s"] > 0


def test_pairs_are_measured_off_the_clock(root, monkeypatch):
    skew = [0.0]
    real = time.perf_counter
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(
        perf_counter=lambda: real() + skew[0]))
    made = measures.errmeasure

    def late(ref):
        err = made(ref)
        batch = err.batch

        def late_batch(*args):
            skew[0] += HOUR
            return batch(*args)

        err.batch = late_batch
        return err

    monkeypatch.setattr(measures, "errmeasure", late)
    got = records(monkeypatch)
    res = run(root, CELL)
    assert res["correct"] and skew[0] >= HOUR
    assert got and all(r["latency_s"] < HOUR for r in got)


def test_eigenvalue_altered_where_the_entry_returns_it(root, monkeypatch):
    patch_entry(monkeypatch,
                lambda lams, V: (np.asarray(lams) * (1 + 1e-3), V))
    res = run(root, CELL)
    assert not res["correct"]
    assert res["checks"]["short_share"]["value"] == 1.0


def test_entry_that_returns_no_pair(root, monkeypatch):
    patch_entry(monkeypatch,
                lambda lams, V: (np.zeros(0, dtype=complex), V[:, :0]))
    res = run(root, CELL)
    assert not res["correct"]
    assert res["checks"]["short_share"]["value"] == 1.0
    assert res["failed"] == res["attempted"]


def test_control_rounds_what_mder_returns(root):
    res = run(root, CELL, control="rounded_mder")
    assert not res["correct"]
    assert res["checks"]["short_share"]["value"] == 1.0


def test_refinement_of_a_protocol_problem_is_refused_at_set_up(root,
                                                               monkeypatch):
    path = os.path.join(root, "portbench", "traffic", "tiny_contour.json")
    with open(path) as fh:
        traffic = json.load(fh)
    traffic["refine"] = {"keep": 2, "backend": "auto", "nsweeps": 3,
                         "tol": 1e-10}
    tiny._dump(traffic, path)

    def no_solve(*args, **kwargs):
        raise AssertionError("a solve ran before the refusal")

    monkeypatch.setattr(neptpu_torch, "contour_beyn", no_solve)
    with pytest.raises(SystemExit, match="refinement"):
        run_cell(root, CELL, 3, 0.2, 0, device="cpu")


@pytest.mark.parametrize("cell, control, kind", [
    (CELL, "bf16_factor", "protocol"), ("tiny.ritz", "rounded_mder", "dep")])
def test_control_of_another_kind_raises(root, cell, control, kind):
    with pytest.raises(ValueError, match=f"{kind} problem"):
        run_cell(root, cell, 3, 0.2, 0, device="cpu", control=control)


@pytest.mark.parametrize("cell", tiny.TINY)
def test_scan_cells_keep_their_record_and_result(root, cell, monkeypatch):
    got = records(monkeypatch)
    res = run(root, cell)
    assert res["correct"] and set(res) == RESULT_KEYS
    assert got and all(set(r) == RECORD_KEYS for r in got)
    assert all(isinstance(r["k_done"], int) and r["k_done"] > 0
               and isinstance(r["t_scan"], float) for r in got)
