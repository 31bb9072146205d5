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

Both scans' Hessenberg pairs are held against the JAX package's compiled
scans (``_build_scan``, ``_build_mixed_scan``, whose results the JAX fixture
here records) at rel 1e-12: the same float64 steps, sums in another order.
The step checks run the same static-shape step a step at a time under modes
that fail on any host read: the columns they write equal the scan's bit for
bit.
"""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import neptpu
import torch_dist_worker as W
from torch_port_helpers import rel_err, small_gun_ops

NDEV = W.WORLD
jspmf_real = importlib.import_module("neptpu.solvers.spmf_real")
jsharded = importlib.import_module("neptpu.solvers.iar_sharded")
jmixed = importlib.import_module("neptpu.parallel.mixed_sharded")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.spawn_world(tmp_path_factory.mktemp("world"),
                         ["iar_dep", "iar_gun", "step_dep", "step_gun"])


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded scans on four virtual devices at the
    worker's settings: per scan the eigenvalues and the Hessenberg pair its
    compiled scan returned (recorded around ``_build_scan`` /
    ``_build_mixed_scan``)."""
    from neptpu.models.gallery.nlevp import _i_sqrt_shifted
    from neptpu.parallel import make_mesh

    if len(jax.devices()) < NDEV:
        pytest.skip(f"needs {NDEV} virtual devices")
    mesh = make_mesh(rows=NDEV, nodes=1, devices=jax.devices()[:NDEV])
    out = {}

    def recorded(mod, name, key):
        build = getattr(mod, name)

        def wrapped(*args, **kwargs):
            run = build(*args, **kwargs)

            def call(*xs):
                res = run(*xs)
                out[key] = {"H": np.asarray(res[2]) + 1j * np.asarray(res[3])}
                return res

            return call

        return wrapped

    cfg = dict(W.IAR_DEP)
    nep = neptpu.nep_gallery("dep0_tridiag", cfg.pop("n"))
    K, mM, W1, W2 = small_gun_ops()
    gun = neptpu.SumNEP(neptpu.PEP([K, mM]), neptpu.SPMF_NEP(
        [W1, W2], [_i_sqrt_shifted(0.0), _i_sqrt_shifted(9.0)]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsharded, "_build_scan",
                   recorded(jsharded, "_build_scan", "dep"))
        mp.setattr(jmixed, "_build_mixed_scan",
                   recorded(jmixed, "_build_mixed_scan", "gun"))
        lam, _ = jsharded.iar_real_sharded(nep, mesh, dtype=jnp.float64,
                                           **cfg)
        out["dep"]["lam"] = np.asarray(lam)
        lam, _ = jmixed.iar_real_spmf_sharded(gun, mesh, dtype=jnp.float64,
                                              **W.IAR_GUN)
        out["gun"]["lam"] = np.asarray(lam)
    return out


def test_scans_agree_across_ranks(world):
    for out in world:
        assert out["loaded"] == []
        for name in ("iar_dep", "iar_gun"):
            np.testing.assert_array_equal(out[name]["lam"],
                                          world[0][name]["lam"])
    np.testing.assert_array_equal(world[0]["iar_dep"]["Q"],
                                  world[-1]["iar_dep"]["Q"])


def test_iar_real_sharded_matches_jax_sharded(world, jax_sharded):
    lam_j = jax_sharded["dep"]["lam"]
    out = world[0]["iar_dep"]
    assert len(out["lam"]) == len(lam_j) >= 4
    np.testing.assert_allclose(np.sort_complex(out["lam"]),
                               np.sort_complex(np.asarray(lam_j)),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("key,job", [("dep", "iar_dep"), ("gun", "iar_gun")])
def test_sharded_hessenberg_matches_jax_compiled_scan(world, jax_sharded,
                                                      key, job):
    """The static-shape sharded step's Hessenberg pair after the whole scan
    equals the JAX compiled scan's at rel 1e-12 (float64)."""
    H, Hj = world[0][job]["hessenberg"], jax_sharded[key]["H"]
    assert H.shape == Hj.shape
    assert rel_err(H, Hj) < 1e-12
    for out in world:
        np.testing.assert_array_equal(out[job]["hessenberg"], H)


@pytest.mark.parametrize("job,scan", [("step_dep", "iar_dep"),
                                      ("step_gun", "iar_gun")])
def test_sharded_steps_read_nothing_on_the_host(world, job, scan):
    """At four ranks each step runs under modes that fail on any read of a
    tensor to the host (the step index included) and on any upload of host
    data - so on an NCCL mesh one captured graph serves every step - and
    writes the scan's Hessenberg columns bit for bit.  On the CPU the scan
    itself ran every step eagerly and says why."""
    for out in world:
        assert out[job]["k"] == W.STEPS + 1
        np.testing.assert_array_equal(
            out[job]["H"], out[scan]["hessenberg"][:, :W.STEPS])
        steps = out[scan].get("steps", W.IAR_DEP["maxit"])
        assert out[scan]["graph"] == {"graphed": False, "eager_steps": steps,
                                      "replays": 0, "capture_s": 0.0,
                                      "why": "cpu"}


def test_iar_real_sharded_matches_serial_port(world):
    out = world[0]["iar_dep"]
    assert len(out["lam"]) == len(out["lam_serial"]) >= 4
    np.testing.assert_allclose(np.sort_complex(out["lam"]),
                               np.sort_complex(out["lam_serial"]),
                               rtol=1e-10, atol=1e-12)
    n = W.IAR_DEP["n"]
    assert out["Q"].shape == (n, len(out["lam"]))
    # B1's bulk on a rank's block: 2 terms, 3 diagonals, blk 128
    assert out["bulk"] == (2, 3, n // NDEV)


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
    # n = 60 over four ranks: B1's bulk on a block of 15 rows
    assert out["bulk"] == (2, 3, 15)
