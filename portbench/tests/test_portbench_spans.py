"""The readers of the program's spans and counters (``portbench/spans.py``
and the seven readers beside the others in ``layers/``): a traced run gives
each a value where its span ran, an untraced run's result is what it was,
and a program without ``neptpu_torch.trace`` gives them nothing."""
import os
import sys

import pytest
import torch

import tiny
from portbench.harness import load_module, run_cell

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("load_s", "factorize_host_s", "scan_capture_s",
           "scan_step_device_ms", "check_measure_s", "refine_factor_s",
           "refine_factors")
# a CPU scan runs every step eagerly: it captures and replays nothing
CARD_ONLY = {"scan_capture_s", "scan_step_device_ms"}
REFINE = {"refine_factor_s", "refine_factors"}
UNTRACED = {"solve_s", "solve_p90_s", "setup_s"}


def _run(root, cell, trace, device="cpu"):
    from neptpu_torch import trace as program_trace

    program_trace.profiled().clear()  # one run a process, as the driver's
    rc, res = run_cell(root, cell, 2**31 + 11, 0.3, trace, device=device,
                       log=open(os.devnull, "w"))
    assert rc == 0 and res["correct"]
    return res


@pytest.mark.parametrize("cell", ["tiny.ritz", "tiny.refined"])
def test_traced_run_reads_every_span_that_ran(tmp_path, cell):
    root = tiny.checkout(tmp_path)
    res = _run(root, cell, 1)
    want = set(READERS) - CARD_ONLY
    if cell == "tiny.ritz":
        want -= REFINE
    got = {m: v["value"] for m, v in res["metrics"].items() if m in READERS}
    assert set(got) == want
    assert all(v > 0 for v in got.values())
    if cell == "tiny.refined":
        assert got["refine_factors"] == int(got["refine_factors"]) >= 1
    res = _run(root, cell, 0)
    assert set(res["metrics"]) == UNTRACED
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device",
                        "checks"}


def test_readers_give_nothing_without_the_programs_trace(monkeypatch):
    rec = {"window": {"solves": [{"traced": True}, {"traced": False}]},
           "solves": [{"traced": False}]}
    monkeypatch.setitem(sys.modules, "neptpu_torch.trace", None)
    import neptpu_torch

    monkeypatch.delattr(neptpu_torch, "trace")
    for name in READERS:
        assert load_module(os.path.join(BASE, "layers", f"{name}.py"),
                           "layers").read(rec) is None


@pytest.mark.cuda
def test_traced_run_on_the_card_reads_all_seven(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan captures only there")
    root = tiny.checkout(tmp_path)
    res = _run(root, "tiny.refined", 1, device="cuda")
    assert set(READERS) <= set(res["metrics"])
    assert res["metrics"]["scan_step_device_ms"]["value"] > 0
