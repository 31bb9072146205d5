"""Port parity: calls the JAX package accepts and the port once refused -
``newton_refine(bsolver=, return_solver=)``, the term banks' dense and CSR
views, ``SPMF_NEP(align_sparsity_patterns=)``, and the JAX package's
arguments of ``initialize_distributed`` and ``make_mesh(devices=)`` - each
against the JAX package's answer on the same numpy inputs, on the CPU."""
import importlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import CPU, backward_errmeasure, rel_err

import neptpu
import neptpu_torch
from neptpu_torch.ops import partitioned as tpart
from neptpu_torch.solvers import refine as trefine
from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                            iar_real_spmf, spmf_fun_scalars)

jrefine = importlib.import_module("neptpu.solvers.refine")
jspmf = importlib.import_module("neptpu.solvers.spmf_real")
jsparse = importlib.import_module("neptpu.ops.sparse")
tsparse = importlib.import_module("neptpu_torch.ops.sparse")
jparallel = importlib.import_module("neptpu.parallel")

WEP = dict(nx=29, nz=21, benchmark_problem="JARLEBRING", neptype="SPMF")
SIGMA = -3 - 3.5j


@pytest.fixture(scope="module")
def wep_pairs():
    """The small waveguide of ``tests/test_refine.py`` in both packages and
    three rough pairs from a short float32 scan of the port."""
    tnep = neptpu_torch.nep_gallery("waveguide", device=CPU, **WEP)
    mats, fv = collect_spmf_terms(tnep)
    jmats, jfv = jspmf.collect_spmf_terms(neptpu.nep_gallery("waveguide",
                                                             **WEP))
    backward = backward_errmeasure(mats, fv, spmf_fun_scalars)
    lams, Q = iar_real_spmf(tnep, sigma=SIGMA, maxit=18, neigs=4, tol=1e-2,
                            dtype=torch.float32, errmeasure=backward,
                            device=CPU)
    return dict(mats=mats, fv=fv, jmats=jmats, jfv=jfv, backward=backward,
                lams=np.asarray(lams)[:3], Q=np.asarray(Q)[:, :3])


def _no_factorization(*args, **kwargs):
    raise AssertionError("a factorization ran although a solver was given")


# the first call returns its batch solver, as the JAX package's does; a
# second call from the same pairs with that solver factorizes nothing and
# gives the same pairs (1e-12: the same solves in the same order), and both
# land on the JAX package's eigenvalues (rel 1e-9, as the refine tests)
@pytest.mark.parametrize("backend", ["host", "chip"])
def test_newton_refine_returns_and_reuses_its_solver(wep_pairs, backend,
                                                     monkeypatch):
    w = wep_pairs
    kw = dict(nsweeps=2, errmeasure=w["backward"], backend=backend,
              shift_rel=1e-8)
    if backend == "chip":
        kw.update(ir=3)
    tl, tQ, te, solver = trefine.newton_refine(
        w["mats"], w["fv"], w["lams"], w["Q"], return_solver=True,
        dtype=torch.float32, device=CPU, **kw)
    assert solver is not None
    if backend == "chip":
        assert isinstance(solver, tpart.BatchedShiftSMW)
    jl, _, je, jsolver = jrefine.newton_refine(
        w["jmats"], w["jfv"], w["lams"], w["Q"], return_solver=True,
        dtype=jnp.float32, **kw)
    assert jsolver is not None
    assert np.all(te < 1e-9) and np.all(je < 1e-9), (te, je)
    assert np.max(np.abs(tl - jl) / np.abs(jl)) < 1e-9
    # the second call: any factorization raises
    monkeypatch.setattr(tpart, "BatchedShiftSMW", _no_factorization)
    monkeypatch.setattr(trefine, "_host_shift_lus", _no_factorization)
    tl2, tQ2, te2, solver2 = trefine.newton_refine(
        w["mats"], w["fv"], w["lams"], w["Q"], bsolver=solver,
        return_solver=True, dtype=torch.float32, device=CPU, **kw)
    assert solver2 is solver
    assert np.max(np.abs(tl2 - tl) / np.abs(tl)) < 1e-12
    assert rel_err(tQ2, tQ) < 1e-12
    assert np.allclose(te2, te, rtol=1e-6, atol=1e-15)


class _SpoiledFirstShift:
    """A batch solver whose solve at the first shift is twice the true one:
    the probe validation must send that shift to a host splu."""

    def __init__(self, inner):
        self.inner = inner

    def solve_pairs(self, Rre, Rim):
        xre, xim = self.inner.solve_pairs(Rre, Rim)
        xre = np.array(xre, dtype=np.float64)
        xim = np.array(xim, dtype=np.float64)
        xre[:, 0] *= 2.0
        xim[:, 0] *= 2.0
        return xre, xim


# a passed solver keeps the JAX package's meaning: on the chip backend it is
# probe-validated, so a shift whose solve fails goes to a host splu; on the
# host backend a solver factored at other shifts is refactored.  Either way
# the second call lands on the JAX package's pairs from the same inputs
@pytest.mark.parametrize("backend", ["host", "chip"])
def test_newton_refine_passed_solver_matches_jax(wep_pairs, backend):
    w = wep_pairs
    kw = dict(nsweeps=2, errmeasure=w["backward"], backend=backend,
              shift_rel=1e-8)
    if backend == "chip":
        kw.update(ir=3)
    tl, tQ, _, solver = trefine.newton_refine(
        w["mats"], w["fv"], w["lams"], w["Q"], return_solver=True,
        dtype=torch.float32, device=CPU, **kw)
    *_, jsolver = jrefine.newton_refine(
        w["jmats"], w["jfv"], w["lams"], w["Q"], return_solver=True,
        dtype=jnp.float32, **kw)
    stats = {}
    if backend == "chip":
        # the same starting pairs, the first shift's solve spoiled
        start, tbs, jbs = ((w["lams"], w["Q"]), _SpoiledFirstShift(solver),
                           _SpoiledFirstShift(jsolver))
    else:
        # the refined pairs: other shifts than the solver's
        start, tbs, jbs = (tl, tQ), solver, jsolver
    tl2, _, te2, solver2 = trefine.newton_refine(
        w["mats"], w["fv"], *start, bsolver=tbs, return_solver=True,
        dtype=torch.float32, device=CPU, stats=stats, **kw)
    jl2, _, je2 = jrefine.newton_refine(
        w["jmats"], w["jfv"], *start, bsolver=jbs, dtype=jnp.float32, **kw)
    if backend == "chip":
        assert solver2 is tbs
        assert stats == {"chip_shifts": 2, "host_fallback_shifts": 1}
    else:
        assert solver2 is not solver
        assert np.array_equal(solver2.sig, tl + 1j * 1e-8 * np.maximum(
            np.abs(tl), 1.0))
    assert np.all(te2 < 1e-9) and np.all(je2 < 1e-9), (te2, je2)
    assert np.max(np.abs(tl2 - jl2) / np.abs(jl2)) < 1e-9


def test_newton_refine_return_solver_on_no_pairs(wep_pairs):
    w = wep_pairs
    out = trefine.newton_refine(w["mats"], w["fv"], np.zeros(0),
                                w["Q"][:, :0], backend="host",
                                return_solver=True)
    jout = jrefine.newton_refine(w["jmats"], w["jfv"], np.zeros(0),
                                 w["Q"][:, :0], backend="host",
                                 return_solver=True)
    assert len(out) == len(jout) == 4
    assert out[3] is None and jout[3] is None
    assert out[0].shape == (0,) and out[2].shape == (0,)


def _mats(kind, n=600, m=3, seed=0):
    """Seeded scipy operands: banded (the DIA layout), general sparse (the
    CSR layout) or dense."""
    rng = np.random.default_rng(seed)
    if kind == "dia":
        offs = (-7, -1, 0, 1, 7)
        return [sp.diags([rng.standard_normal(n - abs(o)) for o in offs],
                         offs, shape=(n, n), format="csr")
                for _ in range(m)]
    if kind == "csr":
        return [sp.random(n, n, density=0.01, random_state=seed + i,
                          format="csr") for i in range(m)]
    return [rng.standard_normal((40, 40)) for _ in range(m)]


@pytest.mark.parametrize("kind, fmt, cls", [
    ("dia", None, "DiaTermBank"),
    ("csr", "csr", "SparseTermBank"),
    ("dense", "dense", "DenseTermBank")])
def test_bank_views_match_jax(kind, fmt, cls):
    """``term_dense``, ``combine_dense`` and (CSR) ``term_csr`` and
    ``to_dense_bank`` return the JAX package's matrices, as torch tensors on
    the bank's device."""
    mats = _mats(kind)
    tb = tsparse.make_term_bank(mats, fmt=fmt, device=CPU)
    jb = jsparse.make_term_bank(mats, fmt=fmt)
    assert type(tb).__name__ == type(jb).__name__ == cls
    w = np.array([0.5, -1.25 + 0.5j, 2.0])
    for i in range(len(mats)):
        td = tb.term_dense(i)
        assert isinstance(td, torch.Tensor) and td.device.type == "cpu"
        np.testing.assert_array_equal(td.numpy(),
                                      np.asarray(jb.term_dense(i)))
    tc = tb.combine_dense(w) if kind != "dense" else tb.combine(w)
    jc = jb.combine_dense(w) if kind != "dense" else jb.combine(w)
    assert rel_err(tc.numpy(), np.asarray(jc)) < 1e-15
    if kind == "csr":
        for i in range(len(mats)):
            csr = tb.term_csr(i)
            assert isinstance(csr, tsparse.CSR)
            np.testing.assert_array_equal(
                csr.to_dense().numpy(), np.asarray(jb.term_csr(i).to_dense()))
        dense = tb.to_dense_bank()
        jdense = jb.to_dense_bank()
        assert isinstance(dense, tsparse.DenseTermBank)
        np.testing.assert_array_equal(dense.A.numpy(), np.asarray(jdense.A))
        np.testing.assert_allclose(dense.fro_norms.numpy(),
                                   np.asarray(jdense.fro_norms), rtol=1e-14)


@pytest.mark.parametrize("align", [True, False])
def test_spmf_accepts_align_sparsity_patterns(align):
    """Accepted and ignored, as in the JAX package: the same bank and the
    same Mlincomb either way."""
    mats = _mats("csr", n=80)
    fv_t = [neptpu_torch.matfun.eye_like, lambda S: -S,
            neptpu_torch.matfun.expm]
    fv_j = [neptpu.matfun.eye_like, lambda S: -S, neptpu.matfun.expm]
    tnep = neptpu_torch.SPMF_NEP(mats, fv_t, align_sparsity_patterns=align,
                                 device=CPU)
    jnep = neptpu.SPMF_NEP(mats, fv_j, align_sparsity_patterns=align)
    V = np.random.default_rng(1).standard_normal((80, 2)) + 0j
    y = neptpu_torch.compute_Mlincomb(tnep, 0.3 - 0.2j, torch.as_tensor(V))
    jy = neptpu.compute_Mlincomb(jnep, 0.3 - 0.2j, jnp.asarray(V))
    assert rel_err(y.numpy(), np.asarray(jy)) < 1e-13


def test_coordinator_arguments_and_mesh_devices_two_processes():
    """Two processes wired by the JAX package's arguments,
    ``initialize_distributed(coordinator_address="127.0.0.1:PORT",
    num_processes=2, process_id=r)``, build ``make_mesh(devices=[cpu,
    cpu])``: a rows mesh of the JAX package's shape for two devices, each
    rank at its own index, a psum across both."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH",
                        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, worker, "coordinator", f"127.0.0.1:{port}",
         str(rank)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for rank in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    jmesh = jparallel.make_mesh(devices=jax.devices()[:2])
    shape = {"rows": jmesh.shape["rows"], "nodes": jmesh.shape["nodes"]}
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert (f"[rank {rank}] coordinator mesh world 2 shape {shape} rank "
                f"{rank} device cpu backend gloo psum 3.0") in out, out


def test_coordinator_arguments_map_and_clash():
    """Without a group: the JAX package's names map onto the torch ones
    (a bare ``host:port`` becomes ``tcp://``), and two names for one
    argument must agree."""
    from neptpu_torch.parallel import mesh as tmesh

    with pytest.raises(ValueError, match="disagree"):
        tmesh.initialize_distributed(num_processes=2, world_size=3,
                                     init_method="tcp://127.0.0.1:1",
                                     process_id=0, device=CPU)
    with pytest.raises(ValueError, match="disagree"):
        tmesh.initialize_distributed(coordinator_address="127.0.0.1:1",
                                     init_method="tcp://127.0.0.1:2",
                                     num_processes=1, process_id=0,
                                     device=CPU)
    import torch.distributed as dist

    started = not dist.is_initialized()
    try:
        with pytest.raises(ValueError, match="devices for a world"):
            tmesh.make_mesh(devices=[CPU, CPU, CPU], backend="gloo")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
