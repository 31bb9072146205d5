"""The reader of the refinement's factor fill (``layers/refine_lu_fill.py``):
a traced run that refines reads the stored entries of L and U a
factorization, one that refines nothing reads nothing, and a program that
counts no fill gives nothing."""
import os

import pytest

import tiny
from portbench.harness import load_module, run_cell

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reader():
    return load_module(os.path.join(BASE, "layers", "refine_lu_fill.py"),
                       "layers")


@pytest.mark.parametrize("cell", ["tiny.ritz", "tiny.refined"])
def test_traced_run_reads_the_fill_only_where_it_refines(tmp_path, cell):
    from neptpu_torch import trace

    trace.profiled().clear()  # one run a process, as the benchmark makes
    rc, res = run_cell(tiny.checkout(tmp_path), cell, 2**31 + 17, 0.3, 1,
                       device="cpu", log=open(os.devnull, "w"))
    assert rc == 0 and res["correct"]
    if cell == "tiny.ritz":
        assert "refine_lu_fill" not in res["metrics"]
    else:
        fill = res["metrics"]["refine_lu_fill"]["value"]
        c = trace.profiled().counters()
        assert fill == pytest.approx(c["nt.refine.lu_fill"]
                                     / c["nt.refine.factorizations"])
        assert fill >= 576  # at least the diagonal of the 576-row problem


def test_reader_gives_nothing_without_the_fill_counter(monkeypatch):
    from neptpu_torch import trace

    rec = {"window": {"solves": [{"traced": True}, {"traced": True}]}}
    col = trace.Collector()
    col._counters.update({"nt.refine.factorizations": 20})
    monkeypatch.setattr(trace, "profiled", lambda: col)
    assert reader().read(rec) is None       # a program without the counter
    col._counters["nt.refine.lu_fill"] = 20 * 4000
    assert reader().read(rec) == 4000
    rec["window"]["solves"] = [{"traced": False}]
    assert reader().read(rec) is None       # no solve was profiled
