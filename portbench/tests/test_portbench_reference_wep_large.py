"""The finer waveguide's configuration (``configs/wep_large.json``) agrees
with itself, with the cell that runs it and with the plain reference it
names: the grid, the unknowns, the terms and the gallery's arguments."""
import numpy as np

from portbench.harness import Cell
from portbench.tests.test_portbench_reference import REPO, config, reference


def test_wep_large_configuration_is_the_references_problem():
    cfg = config("wep_large")
    nx, nz = cfg["nx"], cfg["nz"]
    assert (nx, nz) == (119, 115) and nx == nz + 4
    assert cfg["gallery_args"] == [nx, nz, cfg["waveguide"], "SPMF"]
    assert cfg["n"] == nx * nz + 2 * nz == 13915
    assert cfg["terms"] == 3 + 2 * nz == 233
    assert cfg["reduced"] == []
    # the configuration differs from the wep one only in its size and name
    small = config("wep")
    same = set(small) - {"name", "source", "form", "gallery_args", "nx", "nz",
                         "n", "terms", "assumed"}
    assert all(cfg[k] == small[k] for k in same)
    cell = Cell(REPO, "wep_large.refined")
    assert cell.cfg == cfg and cell.reference_name == "wep"
    ref = reference(cell.reference_name).build(cfg, REPO)
    assert ref.n == cfg["n"] and len(ref.mats) == cfg["terms"]
    assert all(A.shape == (cfg["n"], cfg["n"]) for A in ref.mats)
    # each boundary term is one dense nz x nz corner block
    assert {ref.mats[3 + j].nnz for j in range(2 * nz)} == {nz * nz}
    w = ref.weights(np.array([-3.0 - 3.5j]))
    assert w.shape == (cfg["terms"], 1) and np.isfinite(w).all()
