"""The benchmark's plain reference of the waveguide (``portbench/reference/
wep.py``) against the port's gallery problem, its square-root branch, and a
small run of the benchmark's harness judged by it.  This file imports no
JAX; the harness runs in a child process, since a process that prints a
result may hold no JAX.

Tolerances: the reference assembles the same finite-difference stencil,
wavenumber and boundary modes as the port's ``assemble_waveguide_spmf_fd``,
both in float64 and complex128, in another order of the same operations
(torch against NumPy, coordinates against Kronecker products), so
M(lam) x agrees to a few float64 roundings of its largest terms: rel 1e-12
leaves three orders of room above the 1e-16 read and fails any change of a
coefficient, a node or a branch.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import CPU

import neptpu_torch as nt
from neptpu_torch.solvers.spmf_real import collect_spmf_terms, spmf_fun_scalars

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench.harness import load_module  # noqa: E402

BASE = os.path.join(REPO, "portbench")


def config(name="wep", **small):
    with open(os.path.join(BASE, "configs", f"{name}.json")) as fh:
        cfg = json.load(fh)
    if small:
        nx, nz = small["nx"], small["nz"]
        cfg.update(nx=nx, nz=nz, n=nx * nz + 2 * nz,
                   gallery_args=[nx, nz, "JARLEBRING", "SPMF"])
    return cfg


def reference():
    return load_module(os.path.join(BASE, "reference", "wep.py"),
                       "reference")


def apply(mats, w, x):
    return sum(wi * (A @ x) for wi, A in zip(w, mats))


def agreement(cfg, lams, seed):
    """Relative gap of the reference's M(lam) x from the port's at each
    lam, for a seeded complex x."""
    ref = reference().build(cfg)
    nep = nt.nep_gallery(cfg["gallery"], *cfg["gallery_args"], device=CPU)
    mats, fv = collect_spmf_terms(nep)
    assert ref.n == mats[0].shape[0] == cfg["n"]
    assert len(ref.mats) == len(mats) == 3 + 2 * cfg["nz"]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(ref.n) + 1j * rng.standard_normal(ref.n)
    gaps = []
    for lam in lams:
        ours = apply(ref.mats, ref.weights(np.array([lam]))[:, 0], x)
        theirs = apply(mats, spmf_fun_scalars(fv, lam), x)
        gaps.append(np.linalg.norm(ours - theirs) / np.linalg.norm(theirs))
    return gaps


def test_small_waveguide_is_the_gallery_problem():
    rng = np.random.default_rng(19)
    lams = (rng.uniform(-6, 2, 3) + 1j * rng.uniform(0.5, 6, 3)
            * np.array([1, -1, -1]))
    assert (lams.imag > 0).any() and (lams.imag < 0).any()
    gaps = agreement(config(nx=21, nz=11), lams, seed=20)
    assert max(gaps) <= 1e-12, gaps


@pytest.mark.parametrize("name, n, terms", [("wep", 11655, 213),
                                           ("wep_large", 13915, 233)])
def test_full_size_waveguide_is_the_gallery_problem(name, n, terms):
    cfg = config(name)
    assert cfg["gallery_args"][:2] == [cfg["nx"], cfg["nz"]]
    assert cfg["n"] == n and cfg["terms"] == terms == 3 + 2 * cfg["nz"]
    gaps = agreement(cfg, [-3.0 - 3.5j], seed=21)
    assert gaps[0] <= 1e-12, gaps


def test_square_roots_take_the_branch_with_nonnegative_imaginary_part():
    ref = reference()
    nx, nz = 21, 11
    b, c, d0 = ref.coefficients(nx, nz, 0.1)
    lams = np.array([-3.0 - 3.5j, 0.4 + 2.0j, -1.0 + 0.3j, 2.0 - 0.1j])
    args = (torch.as_tensor(lams)[None, :] ** 2
            + b[:, None] * torch.as_tensor(lams)[None, :] + c[:, None])
    below = args.imag < 0
    assert below.sum() >= 10 and (~below).sum() >= 10
    # the boundary weights are i sqrt(.) + d0: the root is (f - d0) / i
    roots = (ref.weights(lams, b, c, d0)[3:] - d0) / 1j
    assert (roots.imag >= 0).all()
    assert np.allclose(roots ** 2, args.numpy(), rtol=1e-12)
    # the principal root of the same arguments lies below the axis there
    assert (torch.sqrt(args).imag[below] < 0).all()


# A child process runs the harness twice on the CPU in a checkout holding a
# reduced waveguide of a configuration: the traffic of its cell at the
# published target, refined by the chip backend on the CPU; then with one
# refined eigenvalue moved by 1e-3.  At 21 x 11 the scan takes 40 steps: the
# float32 scan holds 8 Ritz pairs at 1e-5 there after 40 steps and loses some
# by 100.  At 25 x 21 the cell's 100 steps give 4 distinct pairs at 1e-9.
CHILD = r"""
import json, sys
root, cell = sys.argv[1:3]
sys.path.insert(0, root)
import neptpu_torch
from portbench.harness import run_cell

out = {}
out["sound"] = run_cell(root, cell, 2**31 + 19, 0.2, 0, device="cpu")
real = neptpu_torch.newton_refine

def altered(*args, **kwargs):
    lams, Q, errs = real(*args, **kwargs)
    lams = lams.copy()
    lams[0] *= 1 + 1e-3
    return lams, Q, errs

neptpu_torch.newton_refine = altered
out["altered"] = run_cell(root, cell, 2**31 + 19, 0.2, 0, device="cpu")
print(json.dumps(out))
"""

# each configuration's reduced grid (nx, nz) and scan steps (None: the
# traffic's own), with the cell whose traffic it takes
SMALL = {"wep": ((21, 11), 40, "wep.refined"),
         "wep_large": ((25, 21), None, "wep_large.refined")}


def checkout(root, name="wep"):
    """``root`` made a checkout: the benchmark, the port linked, and the
    cell ``<name>.tiny``: the traffic of the configuration's cell, with its
    scan steps as ``SMALL`` says, on its reduced waveguide."""
    (nx, nz), maxit, of = SMALL[name]
    tiny = f"{name}_tiny"
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(BASE, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(REPO, "neptpu_torch"),
               os.path.join(root, "neptpu_torch"))
    base = os.path.join(root, "portbench")
    cfg = dict(config(name, nx=nx, nz=nz), name=tiny, reference="wep",
               reduced=["nx", "nz"])
    with open(os.path.join(base, "configs", f"{tiny}.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = {c["name"]: c for c in bench["workloads"]}[of]
    with open(os.path.join(base, "traffic", f"{cell['traffic']}.json")) as fh:
        mix = json.load(fh)
    if maxit is not None:
        mix["scan"]["maxit"] = maxit
    with open(os.path.join(base, "traffic", f"{tiny}.json"), "w") as fh:
        json.dump(mix, fh)
    bench["configs"].append({"name": tiny, "source": "test",
                             "file": f"portbench/configs/{tiny}.json",
                             "reduced": ["nx", "nz"], "why": "CPU test"})
    bench["workloads"].append(dict(cell, name=f"{name}.tiny", config=tiny,
                                   traffic=tiny, why="CPU test"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return str(root)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_harness_run_is_judged_by_the_reference(tmp_path, name):
    root = checkout(tmp_path, name)
    run = subprocess.run([sys.executable, "-c", CHILD, root, f"{name}.tiny"],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    rc, sound = out["sound"]
    assert rc == 0 and sound["correct"], sound
    assert sound["failed"] == 0
    assert sound["checks"]["short_share"]["value"] == 0.0
    assert sound["checks"]["backward_max"]["value"] <= 1e-9
    rc, bad = out["altered"]
    assert rc == 0 and not bad["correct"], bad
    assert bad["checks"]["backward_max"]["value"] > 1e-9
