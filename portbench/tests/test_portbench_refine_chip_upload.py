"""The reader of the chip refinement's host-to-device bytes
(``layers/refine_chip_upload_bytes.py``): a traced run that refines on the
chip backend reads the bytes a solve, one that refines nothing reads
nothing, and a program that counts no such bytes gives nothing."""
import json
import os

import pytest

import tiny
from portbench.harness import load_module, run_cell

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTER = "nt.refine.chip.upload_bytes"


def reader():
    return load_module(os.path.join(BASE, "layers",
                                    "refine_chip_upload_bytes.py"), "layers")


@pytest.mark.parametrize("cell", ["tiny.ritz", "tiny.refined"])
def test_traced_run_reads_the_bytes_only_where_the_chip_refines(tmp_path,
                                                                cell):
    from neptpu_torch import trace

    root = tiny.checkout(tmp_path)
    mix = os.path.join(root, "portbench", "traffic", "tiny_refined.json")
    with open(mix) as fh:
        traffic = json.load(fh)
    traffic["refine"]["backend"] = "chip"    # the card's backend, here on
    with open(mix, "w") as fh:               # the CPU
        json.dump(traffic, fh)
    trace.profiled().clear()  # one run a process, as the benchmark makes
    rc, res = run_cell(root, cell, 2**31 + 23, 0.3, 1, device="cpu",
                       log=open(os.devnull, "w"))
    assert rc == 0 and res["correct"]
    if cell == "tiny.ritz":
        assert "refine_chip_upload_bytes" not in res["metrics"]
    else:
        got = res["metrics"]["refine_chip_upload_bytes"]["value"]
        c = trace.profiled().counters()
        assert c["nt.refine.factorizations"] > 0
        # the counter over a whole number of profiled solves
        solves = c[COUNTER] / got
        assert solves == pytest.approx(round(solves)) and solves >= 1


def test_reader_gives_nothing_without_the_counter(monkeypatch):
    from neptpu_torch import trace

    rec = {"window": {"solves": [{"traced": True}, {"traced": True}]}}
    col = trace.Collector()
    col._counters.update({"nt.refine.chip.shifts": 18})
    monkeypatch.setattr(trace, "profiled", lambda: col)
    assert reader().read(rec) is None       # a program without the counter
    col._counters[COUNTER] = 2 * 5.0e7
    assert reader().read(rec) == 5.0e7
    rec["window"]["solves"] = [{"traced": False}]
    assert reader().read(rec) is None       # no solve was profiled
