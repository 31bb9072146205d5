"""A checkout in a temporary folder holding the benchmark, two small delay
configurations beside the real ones, and links to the port and its data,
for the harness's CPU tests."""
import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = ("tiny.ritz", "tiny.refined")


def _dump(obj, path):
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


def checkout(tmp):
    """``tmp`` made a checkout: ``BENCHMARK.json`` and ``portbench/`` copied,
    ``neptpu_torch`` and ``neptpu`` (data files only) linked, and the cells
    ``tiny.ritz`` (``iar_real`` on a 24 x 24 grid) and ``tiny.refined``
    (``iar_real_spmf`` and refinement on the same problem) added."""
    root = str(tmp)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for pkg in ("neptpu_torch", "neptpu"):
        os.symlink(os.path.join(REPO, pkg), os.path.join(root, pkg))
    base = os.path.join(root, "portbench")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    with open(os.path.join(base, "configs", "dep_symm_double.json")) as fh:
        cfg = json.load(fh)
    for name, kind in (("dep_tiny", "dep"), ("dep_tiny_spmf", "spmf")):
        _dump(dict(cfg, name=name, kind=kind, grid=24, n=576,
                   gallery_args=[24], reference="dep_symm_double",
                   reduced=["grid"]),
              os.path.join(base, "configs", f"{name}.json"))
        bench["configs"].append({
            "name": name, "source": cfg["source"][:200],
            "file": f"portbench/configs/{name}.json", "reduced": ["grid"],
            "why": "a small delay problem for the CPU tests"})
    with open(os.path.join(base, "traffic", "dep_sweep_ritz.json")) as fh:
        ritz = json.load(fh)
    ritz["scan"].update(maxit=30, neigs=4, check_error_every=10)
    ritz["k"] = 4
    ritz["correct"] = {"short_share": 0.6}   # the floor limit is dep's own
    _dump(ritz, os.path.join(base, "traffic", "tiny_ritz.json"))
    refined = dict(ritz, entry="iar_real_spmf",
                   refine={"keep": 6, "backend": "auto", "nsweeps": 3,
                           "tol": 1e-9, "ir": 3, "shift_rel": 1e-8,
                           "target_distinct": 4})
    _dump(refined, os.path.join(base, "traffic", "tiny_refined.json"))
    for cell, config, mix in (("tiny.ritz", "dep_tiny", "tiny_ritz"),
                              ("tiny.refined", "dep_tiny_spmf",
                               "tiny_refined")):
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": "CPU test"})
        for m in bench["per_layer"]:
            if "workloads" in m and (m["name"] != "refine_s"
                                     or cell == "tiny.refined"):
                m["workloads"].append(cell)
    _dump(bench, os.path.join(root, "BENCHMARK.json"))
    return root
