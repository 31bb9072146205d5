"""The readers of the scan's host peeks, the pairs they measure and the
refinement's passes (``layers/scan_checks.py``, ``check_pairs.py``,
``refine_passes.py``): nothing from a program without their span or counter
or from a run that profiled no solve, and the mean over the profiled solves
otherwise (a span's calls, a counter's total)."""
import os

import pytest

from portbench.harness import load_module

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# reader: (what it reads, its name)
READS = {"scan_checks": ("span", "nt.scan.check"),
         "check_pairs": ("counter", "nt.scan.check.pairs"),
         "refine_passes": ("span", "nt.refine.factor")}


def reader(name):
    return load_module(os.path.join(BASE, "layers", f"{name}.py"), "layers")


def record(col, kind, name, n):
    """``n`` closed top-level spans, or a counter at ``n``, in ``col``."""
    if kind == "span":
        col._spans.extend([name, None, 0, 1, None] for _ in range(n))
    else:
        col._counters[name] = n


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_gives_the_mean_over_the_profiled_solves(monkeypatch, name):
    from neptpu_torch import trace

    rec = {"window": {"solves": [{"traced": True}, {"traced": True},
                                 {"traced": False}]}}
    col = trace.Collector()
    # the spans and counters of a traced solve, none of them this reader's
    for other, (kind, what) in READS.items():
        if other != name:
            record(col, kind, what, 7)
    monkeypatch.setattr(trace, "profiled", lambda: col)
    assert reader(name).read(rec) is None   # a program without them
    record(col, *READS[name], 9)
    assert reader(name).read(rec) == 4.5
    rec["window"]["solves"] = [{"traced": False}]
    assert reader(name).read(rec) is None   # no solve was profiled


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_gives_nothing_without_the_trace_module(monkeypatch, name):
    import sys

    import neptpu_torch

    rec = {"window": {"solves": [{"traced": True}]}}
    monkeypatch.setitem(sys.modules, "neptpu_torch.trace", None)
    monkeypatch.delattr(neptpu_torch, "trace")
    assert reader(name).read(rec) is None
