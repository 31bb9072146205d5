"""The readers of the Newton refinement's held term forms
(``layers/refine_ops_s.py``, ``layers/refine_ops_reuse_share.py``): a
traced run that refines reads the seconds a solve of the forms' test or
build and the share of calls that reuse them, one that refines nothing
reads neither, and a program without the span or the counters gives
nothing."""
import os

import pytest

import tiny
from portbench.harness import load_module, run_cell

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("refine_ops_s", "refine_ops_reuse_share")


def reader(name):
    return load_module(os.path.join(BASE, "layers", f"{name}.py"), "layers")


@pytest.mark.parametrize("cell", ["tiny.ritz", "tiny.refined"])
def test_traced_run_reads_both_only_where_it_refines(tmp_path, cell):
    from neptpu_torch import trace

    root = tiny.checkout(tmp_path)
    trace.profiled().clear()  # one run a process, as the benchmark makes
    rc, res = run_cell(root, cell, 2**31 + 31, 0.3, 1, device="cpu",
                       log=open(os.devnull, "w"))
    assert rc == 0 and res["correct"]
    if cell == "tiny.ritz":
        assert not set(METRICS) & set(res["metrics"])
        return
    got = {m: res["metrics"][m]["value"] for m in METRICS}
    totals, c = trace.profiled().totals(), trace.profiled().counters()
    assert 0 < got["refine_ops_s"] <= totals["nt.refine"]["seconds"]
    # the warm-up solve built the forms; every profiled solve reuses them
    assert "nt.refine.ops_built" not in c and c["nt.refine.ops_held"] >= 1
    assert got["refine_ops_reuse_share"] == 100.0


def test_readers_give_nothing_without_the_span_or_counters(monkeypatch):
    from neptpu_torch import trace

    rec = {"window": {"solves": [{"traced": True}, {"traced": True}]}}
    col = trace.Collector()
    col._counters.update({"nt.refine.factorizations": 12})
    monkeypatch.setattr(trace, "profiled", lambda: col)
    for name in METRICS:                    # a program without them
        assert reader(name).read(rec) is None
    col._counters["nt.refine.ops_held"] = 3
    assert reader("refine_ops_reuse_share").read(rec) == 100.0
    col._counters["nt.refine.ops_built"] = 1
    assert reader("refine_ops_reuse_share").read(rec) == pytest.approx(75.0)
    col._spans.append(["nt.refine.ops", None, 0, 3 * 10**8, None])
    assert reader("refine_ops_s").read(rec) == pytest.approx(0.15)
    rec["window"]["solves"] = [{"traced": False}]
    for name in METRICS:                    # no solve was profiled
        assert reader(name).read(rec) is None
