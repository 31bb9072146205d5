"""Port parity of the two sharded IAR scans: ``iar_real_sharded`` (banded
delay problem: halo-exchange bank + SPIKE) and ``iar_real_spmf_sharded``
(the gun class: sharded mixed bank + SPIKE + SMW), each on one world of four
gloo ranks on the CPU spawned for this module
(``torch_dist_worker.spawn_world``), held against the JAX package's sharded
scan on four virtual devices, the JAX serial scan and the port's serial
scan on the same problem.

``dep0_tridiag`` runs at n = 512, the smallest size at which both packages
build it with a DIA bank (a sharded bank needs one), at maxit 40 (at 30 only
one pair converges at sigma = -0.2 + 0.1i); eigenvalues agree to rel 1e-10.
The small gun runs as ``test_mixed_sharded.py``'s gun-class case: the pairs
nearest sigma within 1e-9 of the JAX serial scan, residuals below 1e-7.
"""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import neptpu
import torch_dist_worker as W
from torch_port_helpers import small_gun_ops

NDEV = W.WORLD
jspmf_real = importlib.import_module("neptpu.solvers.spmf_real")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.spawn_world(tmp_path_factory.mktemp("world"),
                         ["iar_dep", "iar_gun"])


def test_scans_agree_across_ranks(world):
    for out in world:
        assert out["loaded"] == []
        for name in ("iar_dep", "iar_gun"):
            np.testing.assert_array_equal(out[name]["lam"],
                                          world[0][name]["lam"])
    np.testing.assert_array_equal(world[0]["iar_dep"]["Q"],
                                  world[-1]["iar_dep"]["Q"])


def test_iar_real_sharded_matches_jax_sharded(world):
    from neptpu.parallel import make_mesh
    from neptpu.solvers.iar_sharded import iar_real_sharded

    if len(jax.devices()) < NDEV:
        pytest.skip(f"needs {NDEV} virtual devices")
    mesh = make_mesh(rows=NDEV, nodes=1, devices=jax.devices()[:NDEV])
    cfg = dict(W.IAR_DEP)
    nep = neptpu.nep_gallery("dep0_tridiag", cfg.pop("n"))
    lam_j, _ = iar_real_sharded(nep, mesh, dtype=jnp.float64, **cfg)
    out = world[0]["iar_dep"]
    assert len(out["lam"]) == len(lam_j) >= 4
    np.testing.assert_allclose(np.sort_complex(out["lam"]),
                               np.sort_complex(np.asarray(lam_j)),
                               rtol=1e-10, atol=1e-12)


def test_iar_real_sharded_matches_serial_port(world):
    out = world[0]["iar_dep"]
    assert len(out["lam"]) == len(out["lam_serial"]) >= 4
    np.testing.assert_allclose(np.sort_complex(out["lam"]),
                               np.sort_complex(out["lam_serial"]),
                               rtol=1e-10, atol=1e-12)
    n = W.IAR_DEP["n"]
    assert out["Q"].shape == (n, len(out["lam"]))
    # a rank's window: blk 128 plus one halo row on each side, 2 terms,
    # 3 diagonals
    assert out["window"] == (2, 3, n // NDEV + 2)


def test_iar_real_spmf_sharded_matches_jax_serial(world):
    from neptpu.models.gallery.nlevp import _i_sqrt_shifted

    K, mM, W1, W2 = small_gun_ops()
    nep = neptpu.SumNEP(neptpu.PEP([K, mM]), neptpu.SPMF_NEP(
        [W1, W2], [_i_sqrt_shifted(0.0), _i_sqrt_shifted(9.0)]))
    cfg = W.IAR_GUN
    lam_s, _ = jspmf_real.iar_real_spmf(
        nep, sigma=cfg["sigma"], maxit=cfg["maxit"], neigs=8,
        tol=cfg["tol"], dtype=jnp.float64, scaled=True)
    lam_s = np.asarray(lam_s)
    out = world[0]["iar_gun"]
    assert out["nconv"] >= 3 and len(out["lam"]) == 3
    near = sorted(out["lam"], key=lambda la: abs(la - cfg["sigma"]))[:2]
    for la in near:
        assert min(abs(la - lam_s)) < 1e-9, (la, lam_s)
    assert max(out["res"]) < 1e-7
    # n = 60 over four ranks: blk 15 plus one halo row on each side
    assert out["window"] == (2, 3, 15 + 2)
