"""A configuration, a traffic mix and a per-layer metric added as new files,
with their entries in ``BENCHMARK.json``, are found by name: no other file
of the harness changes."""
import json
import os

import tiny
from portbench.harness import run_cell

METRIC = '''"""Solves that the traced run profiled."""


def read(record):
    return sum(1 for s in record["window"]["solves"] if s["traced"])
'''


def test_new_config_mix_and_metric_are_picked_up(tmp_path):
    root = tiny.checkout(tmp_path)
    base = os.path.join(root, "portbench")
    with open(os.path.join(base, "configs", "dep_tiny.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="dep_small", grid=20, n=400, gallery_args=[20])
    with open(os.path.join(base, "configs", "dep_small.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(base, "traffic", "tiny_ritz.json")) as fh:
        mix = json.load(fh)
    mix["shift"] = {"real": [-1.2, -0.8], "imag": 0.0, "points": 2}
    with open(os.path.join(base, "traffic", "small_ritz.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(base, "layers", "traced_solves.py"), "w") as fh:
        fh.write(METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "dep_small", "source": "test",
                             "file": "portbench/configs/dep_small.json",
                             "reduced": ["grid"], "why": "test"})
    bench["workloads"].append({"name": "small.ritz", "config": "dep_small",
                               "traffic": "small_ritz", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "traced_solves", "unit": "solves",
                               "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "solve_s",
                               "workloads": ["small.ritz"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)

    rc, res = run_cell(root, "small.ritz", 9, 0.3, 1, device="cpu")
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"traced_solves"}
    assert res["metrics"]["traced_solves"]["value"] >= 1
    rc, res = run_cell(root, "small.ritz", 9, 0.3, 0, device="cpu")
    assert set(res["metrics"]) == {"solve_s", "solve_p90_s", "setup_s"}
    assert list(res)[-1] == "checks"
    # the cells beside it keep their metrics: the new one is not theirs
    rc, res = run_cell(root, "tiny.ritz", 9, 0.3, 1, device="cpu")
    assert "traced_solves" not in res["metrics"]
