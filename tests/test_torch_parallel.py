"""Port parity of the sharded layer's pieces: the Mesh collectives, the
halo-exchange DIA bank (kernel B1's plain twin on each rank's block, then
the boundary corrections from the neighbours' strips), the
row-sharded CSR bank, the psum Gram, SPIKE, the sharded SPIKE + SMW solve
and the node-sharded contour moments.

The port runs SPMD: ONE world of four gloo ranks on the CPU is spawned for
this module (``torch_dist_worker.spawn_world``, file rendezvous, one thread a
rank) and runs every check; each test reads the ranks' results.  The JAX
side runs here, on a four-device mesh over the conftest's virtual CPU
devices, on the same numpy inputs.

Tolerances (relative, in norm): the bank applies and the Gram are the same
float64 sums in another order (1e-12); the SPIKE and SMW solves are LU
solves of the same blocks (1e-10); the moments sum the same dense solves
(1e-10); ``contour_beyn``'s eigenvalues go through an SVD and a small eig on
top (1e-7, the JAX test's).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import neptpu
import torch_dist_worker as W
from torch_port_helpers import CPU, rel_err

NDEV = W.WORLD


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.spawn_world(tmp_path_factory.mktemp("world"),
                         ["collectives", "dia", "csr", "gram", "spike", "smw",
                          "moments", "beyn"])


@pytest.fixture(scope="module")
def jmesh():
    from neptpu.parallel import make_mesh

    if len(jax.devices()) < NDEV:
        pytest.skip(f"needs {NDEV} virtual devices")
    return (make_mesh(rows=NDEV, nodes=1, devices=jax.devices()[:NDEV]),
            make_mesh(rows=1, nodes=NDEV, devices=jax.devices()[:NDEV]))


def test_ranks_agree_and_load_no_jax(world):
    """Every rank returns the same gathered results, ran on gloo over a
    (4, 1) and a (1, 4) mesh, and imported neither JAX nor the JAX
    package."""
    for r, out in enumerate(world):
        assert out["loaded"] == [], (r, out["loaded"])
        assert out["backend"] == "gloo"
        assert out["shape"] == ({"rows": NDEV, "nodes": 1},
                                {"rows": 1, "nodes": NDEV})
        for name in ("dia", "csr", "gram", "spike", "smw", "moments", "beyn"):
            for key, v in world[0][name].items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(out[name][key], v)


def test_mesh_collectives(world):
    """``psum``, ``all_gather`` (rank order) and ``neighbour_exchange``
    (zeros at the chain ends, as ``ppermute`` gives), also started and
    waited for with another collective in between."""
    for r, out in enumerate(world):
        c = out["collectives"]
        assert c["rank"] == (r, r, 0)
        np.testing.assert_array_equal(c["psum"], np.full(2, 10.0))
        np.testing.assert_array_equal(c["psum_nodes"], np.full(2, r + 1.0))
        np.testing.assert_array_equal(c["gather"], np.repeat(
            np.arange(1.0, NDEV + 1)[:, None], 2, axis=1))
        np.testing.assert_array_equal(c["from_prev"],
                                      np.full(2, 100.0 * r))
        np.testing.assert_array_equal(
            c["from_next"], np.full(2, 10.0 * (r + 2) if r < NDEV - 1 else 0))
        # neighbour_exchange_start, a psum between the start and the wait
        prev, nxt, between = c["started"]
        np.testing.assert_array_equal(prev, c["from_prev"])
        np.testing.assert_array_equal(nxt, c["from_next"])
        np.testing.assert_array_equal(between, c["psum"])


def test_sharded_dia_lincomb_matches_jax(world, jmesh):
    from neptpu.ops.dia import DiaTermBank
    from neptpu.parallel import (ShardedDiaBank, shard_vector,
                                 sharded_dia_lincomb, unshard_vector)

    mats, Wop = W.dia_inputs()
    n = Wop.shape[0]
    sb = ShardedDiaBank(DiaTermBank.from_matrices(mats), NDEV).device_put(
        jmesh[0])
    y_j = unshard_vector(sharded_dia_lincomb(
        sb, shard_vector(Wop, sb.ndev, sb.blk), jmesh[0]), n)
    ref = sum(A @ Wop[:, i] for i, A in enumerate(mats))
    out = world[0]["dia"]
    for y in (out["y"], out["y_functional"], out["y_window"]):
        assert rel_err(y, y_j) < 1e-12
        assert rel_err(y, ref) < 1e-12
    # B1's bulk runs on the rank's block: 3 terms, 5 offsets, blk 60
    assert out["bulk"] == (3, 5, 60)


def test_bulk_boundary_apply_matches_jax_local_halo_lincomb(world):
    """Each rank's bulk/boundary apply (gathered) equals the JAX body's
    ``local_halo_lincomb`` on the same rank's block and strips, and the
    one-launch window form on the same strips, at rel 1e-12 (float64)."""
    from neptpu.ops.dia import DiaTermBank
    from neptpu.parallel import ShardedDiaBank, local_halo_lincomb

    mats, Wop = W.dia_inputs()
    n = Wop.shape[0]
    sb = ShardedDiaBank(DiaTermBank.from_matrices(mats), NDEV)
    blk, lo, hi = sb.blk, sb.halo_lo, sb.halo_hi
    Wp = np.zeros((NDEV * blk + lo + hi, Wop.shape[1]))
    Wp[lo:lo + n] = Wop  # zero rows before the first block, after the last
    y_j = np.concatenate([np.asarray(local_halo_lincomb(
        sb.data[d], sb.offsets, Wp[lo + d * blk: lo + (d + 1) * blk],
        Wp[d * blk: lo + d * blk], Wp[lo + (d + 1) * blk:
                                      lo + (d + 1) * blk + hi], lo, hi))
        for d in range(NDEV)])[:n]
    out = world[0]["dia"]
    assert rel_err(out["y"], y_j) < 1e-12
    assert rel_err(out["y_functional"], y_j) < 1e-12
    assert rel_err(out["y"], out["y_window"]) < 1e-12


def test_row_sharded_bank_matches_jax(world, jmesh):
    from neptpu.ops.sparse import SparseTermBank
    from neptpu.parallel import RowShardedBank, sharded_lincomb_apply

    mats, Wop = W.csr_inputs()
    sbank = RowShardedBank(SparseTermBank.from_matrices(mats), NDEV)
    y_j = np.asarray(sharded_lincomb_apply(sbank, Wop, jmesh[0]))
    assert rel_err(world[0]["csr"]["y"], y_j) < 1e-12
    ref = sum(A @ Wop[:, i] for i, A in enumerate(mats))
    assert rel_err(world[0]["csr"]["y"], ref) < 1e-12


def test_sharded_gram_matches_jax(world, jmesh):
    from neptpu.parallel import sharded_gram

    V, w = W.gram_inputs()
    h_j = np.asarray(sharded_gram(jnp.asarray(V), jnp.asarray(w), jmesh[0]))
    assert rel_err(world[0]["gram"]["h"], h_j) < 1e-12


def test_spike_banded_solve_matches_jax(world, jmesh):
    from neptpu.parallel import SpikeBandedSolver, dia_strips_from_dense

    A, offs, B = W.spike_inputs()
    X_j = np.asarray(SpikeBandedSolver(dia_strips_from_dense(A, offs), offs,
                                       jmesh[0]).solve(B))
    X = world[0]["spike"]["X"]
    assert rel_err(X, X_j) < 1e-10
    assert np.abs(A @ X - B).max() < 1e-9


def test_spike_complex_interleaved_matches_jax(world):
    """The interleaved complex case against the JAX package's SPIKE over
    four partitions on one device (``PartitionedBandedSolver``: the same
    blocks, spikes and reduced system; its four-device ``shard_map``
    compile takes half a minute here) and the dense solve."""
    from neptpu.ops.partitioned import PartitionedBandedSolver
    from neptpu.parallel import (dia_strips_from_dense,
                                 interleave_complex_banded)

    Ac, offs, bc = W.spike_inputs(complex_=True)
    rstrips, roffs = interleave_complex_banded(
        dia_strips_from_dense(Ac, offs), offs)
    f = np.zeros(2 * len(bc))
    f[0::2], f[1::2] = bc.real, bc.imag
    xr = np.asarray(PartitionedBandedSolver(rstrips, roffs, p=NDEV,
                                            mode="lu").solve(jnp.asarray(f)))
    xc = world[0]["spike"]["xc"]
    assert rel_err(xc, xr[0::2] + 1j * xr[1::2]) < 1e-10
    assert rel_err(xc, np.linalg.solve(Ac, bc)) < 1e-10


def test_smw_solve_matches_jax_and_splu(world):
    """The sharded SPIKE + SMW solve of ``test_mixed_sharded.py``'s
    waveguide against the JAX package's SPIKE + SMW solve over four
    partitions on one device (``build_spmf_shift_solver``, float64 LU mode;
    the four-device version compiles for two minutes here) and scipy's
    ``splu`` of M(sigma)."""
    import scipy.sparse.linalg as spla

    from neptpu.ops.partitioned import build_spmf_shift_solver
    from neptpu.solvers.spmf_real import collect_spmf_terms, spmf_fun_scalars

    nep = neptpu.nep_gallery("waveguide", nx=17, nz=11,
                             benchmark_problem="TAUSCH", neptype="SPMF")
    mats, fv = collect_spmf_terms(nep)
    f = W.smw_rhs(mats[0].shape[0])
    slv = build_spmf_shift_solver(mats, fv, W.SMW_SIGMA, dtype=jnp.float64,
                                  p=NDEV, mode="lu")
    xre, xim = slv.solve_pair(jnp.asarray(f.real), jnp.asarray(f.imag))
    out = world[0]["smw"]
    assert out["reduced"] == 2 * out["b"] * NDEV
    assert rel_err(out["x"], np.asarray(xre) + 1j * np.asarray(xim)) < 1e-10
    w = spmf_fun_scalars(fv, W.SMW_SIGMA)
    M = sum(wi * A.astype(complex) for wi, A in zip(w, mats)).tocsc()
    assert rel_err(out["x"], spla.splu(M).solve(f)) < 1e-10


def test_contour_moments_match_jax(world, jmesh):
    from neptpu.parallel import sharded_contour_moments

    cfg = W.MOMENTS
    A_j = np.asarray(sharded_contour_moments(
        neptpu.nep_gallery("dep0"), cfg["sigma"], cfg["radius"],
        W.moments_inputs(), cfg["N"], cfg["n_moments"], jmesh[1]))
    A = world[0]["moments"]["A"]
    assert A.shape == A_j.shape == (2, 5, 2)
    for j in range(2):
        assert rel_err(A[j], A_j[j]) < 1e-10


def test_contour_beyn_mesh_matches_jax(world, jmesh):
    lam_j, _ = neptpu.contour_beyn(neptpu.nep_gallery("dep0"), mesh=jmesh[1],
                                   **W.BEYN)
    out = world[0]["beyn"]
    lam_j = np.sort_complex(np.asarray(lam_j))
    assert len(out["lam"]) == len(lam_j) >= 1
    np.testing.assert_allclose(np.sort_complex(out["lam"]), lam_j,
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.sort_complex(out["lam"]),
                               np.sort_complex(out["lam_serial"]),
                               rtol=1e-7, atol=1e-9)


def test_complex_lowrank_to_interleaved_matches_jax():
    from neptpu.ops.partitioned import complex_lowrank_to_interleaved as jf
    from neptpu_torch.ops.partitioned import (
        complex_lowrank_to_interleaved as tf)

    rng = np.random.default_rng(4)
    Lc = rng.standard_normal((9, 3)) + 1j * rng.standard_normal((9, 3))
    Uc = rng.standard_normal((9, 3)) + 1j * rng.standard_normal((9, 3))
    for a, b in zip(tf(Lc, Uc), jf(Lc, Uc)):
        np.testing.assert_array_equal(a, np.asarray(b))
    Lt, Ut = tf(Lc, Uc)
    A = Lc @ Uc.T
    blockform = np.block([[A.real, -A.imag], [A.imag, A.real]])
    perm = np.arange(18).reshape(2, 9).T.reshape(-1)  # interleaving
    np.testing.assert_allclose(Lt @ Ut.T, blockform[perm][:, perm],
                               atol=1e-13)


def test_multihost_two_processes():
    """Two processes wired from the torchrun variables run
    ``sharded_dia_lincomb`` through ``make_mesh(multihost=True)``."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    procs = []
    for rank in range(2):
        env = dict(env_base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK="0")
        procs.append(subprocess.Popen(
            [sys.executable, worker, "multihost"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert "multihost sharded lincomb OK" in out, out[-3000:]


def test_cpu_mesh_names_its_backend():
    """The port picks the backend from the device (gloo for the CPU) and
    never stages through the host on the CPU."""
    from neptpu_torch.parallel.mesh import default_backend

    assert default_backend(CPU) == "gloo"
    assert default_backend("cuda") == "nccl"
