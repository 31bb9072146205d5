"""Port parity: the batched per-shift factorization ``BatchedShiftSMW`` and
the on-device (``chip``) backend of ``newton_refine``, against the JAX
package on the small waveguide of ``tests/test_refine.py`` (nx=29, nz=21),
on the CPU."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import CPU, backward_errmeasure, rel_err

import neptpu
import neptpu_torch
from neptpu_torch.interop import batched_shift_solver_from_arrays
from neptpu_torch.ops.partitioned import (BATCH_SIZES, BatchedShiftSMW,
                                          ShiftPlan, canonical_batch)
from neptpu_torch.solvers import refine as trefine
from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                            iar_real_spmf, spmf_fun_scalars)

jpart = importlib.import_module("neptpu.ops.partitioned")
jrefine = importlib.import_module("neptpu.solvers.refine")
jspmf = importlib.import_module("neptpu.solvers.spmf_real")

WEP = dict(nx=29, nz=21, benchmark_problem="JARLEBRING", neptype="SPMF")
SIGMA = -3 - 3.5j


@pytest.fixture(scope="module")
def wep_small():
    tnep = neptpu_torch.nep_gallery("waveguide", device=CPU, **WEP)
    mats, fv = collect_spmf_terms(tnep)
    jnep = neptpu.nep_gallery("waveguide", **WEP)
    jmats, jfv = jspmf.collect_spmf_terms(jnep)
    return dict(tnep=tnep, jnep=jnep, mats=mats, fv=fv, jmats=jmats, jfv=jfv,
                backward=backward_errmeasure(mats, fv, spmf_fun_scalars))


def _splu_solve(mats, fv, sigma, b):
    import scipy.sparse.linalg as spla

    w = spmf_fun_scalars(fv, sigma)
    M = sum(wi * A.astype(complex) for wi, A in zip(w, mats)).tocsc()
    return spla.splu(M).solve(b)


def _jax_state(obj):
    """``vars`` of a JAX BatchedShiftSMW with every array as numpy."""
    def conv(v):
        if isinstance(v, tuple) and v and hasattr(v[0], "shape"):
            return tuple(np.asarray(x) for x in v)
        return np.asarray(v) if hasattr(v, "shape") else v

    return {k: conv(v) for k, v in vars(obj).items()}


@pytest.mark.parametrize("route", ["native", "interop"])
def test_batched_shift_solver_exact_f64_matches_jax(wep_small, route):
    """Two shifts, float64 factors: each column solved against its own shift
    to 1e-10 of scipy splu (the tolerance of tests/test_refine.py) and of the
    JAX class."""
    w = wep_small
    n = w["mats"][0].shape[0]
    sigmas = np.array([-2 + 1j, -5 - 1j])
    jb = jpart.BatchedShiftSMW(w["jmats"], w["jfv"], sigmas,
                               dtype=jnp.float64)
    tb = (BatchedShiftSMW(w["mats"], w["fv"], sigmas, dtype=torch.float64,
                          device=CPU) if route == "native"
          else batched_shift_solver_from_arrays(_jax_state(jb), device=CPU))
    rng = np.random.default_rng(0)
    B = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    yre, yim = tb.solve_pairs(B.real, B.imag)
    Y = yre + 1j * yim
    jre, jim = jb.solve_pairs(B.real, B.imag)
    assert rel_err(Y, np.asarray(jre) + 1j * np.asarray(jim)) < 1e-10
    for j, s in enumerate(sigmas):
        assert rel_err(Y[:, j], _splu_solve(w["mats"], w["fv"], s,
                                            B[:, j])) < 1e-10
    with pytest.raises(ValueError, match="RHS columns"):
        tb.solve_pairs(B.real[:, :1], B.imag[:, :1])


@pytest.mark.parametrize("route", ["native", "interop"])
def test_mixed_precision_ir_solve_near_eigenvalue_matches_jax(wep_small,
                                                              route):
    """float32 factors + float64 iterative refinement, ~5e-6 off an
    eigenvalue: within 1e-6 of scipy splu (the tolerance tests/test_refine.py
    states for the JAX class) and within 1e-7 of the JAX class's own
    result (both refine the same float64 residual; the float32 factors
    differ in rounding)."""
    w = wep_small
    n = w["mats"][0].shape[0]
    sig = -2.87079276 - 4.38384634j + 1j * 5.4e-6
    rng = np.random.default_rng(1)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    xref = _splu_solve(w["mats"], w["fv"], sig, b)
    jb = jpart.BatchedShiftSMW(w["jmats"], w["jfv"], np.array([sig]),
                               dtype=jnp.float32, ir=3)
    tb = (BatchedShiftSMW(w["mats"], w["fv"], np.array([sig]),
                          dtype=torch.float32, ir=3, device=CPU)
          if route == "native"
          else batched_shift_solver_from_arrays(_jax_state(jb), device=CPU))
    yre, yim = tb.solve_pairs(b.real[:, None], b.imag[:, None])
    y = yre[:, 0] + 1j * yim[:, 0]
    assert rel_err(y, xref) < 1e-6
    jre, jim = jb.solve_pairs(b.real[:, None], b.imag[:, None])
    assert rel_err(y, np.asarray(jre)[:, 0] + 1j * np.asarray(jim)[:, 0]) < 1e-7


def test_batch_limit_and_canonical_sizes_match_jax(wep_small):
    w = wep_small
    plan = ShiftPlan(w["mats"], w["fv"])
    jplan = jpart.ShiftPlan(w["jmats"], w["jfv"])
    for p, budget in ((8, 6.0e9), (4, 1.0e8), (8, 1.0)):
        assert (trefine._refine_batch_limit(plan, p=p, budget_bytes=budget)
                == jrefine._refine_batch_limit(jplan, p=p,
                                               budget_bytes=budget))
    assert BATCH_SIZES == jpart.BATCH_SIZES
    for k in (1, 5, 11, 64, 65, 200):
        assert canonical_batch(k) == jpart.canonical_batch(k)


@pytest.fixture(scope="module")
def candidates(wep_small):
    """Rough pairs from a short float32 scan (backward error ~1e-2..1e-4)."""
    w = wep_small
    lams, Q = iar_real_spmf(w["tnep"], sigma=SIGMA, maxit=18, neigs=4,
                            tol=1e-2, dtype=torch.float32,
                            errmeasure=w["backward"], device=CPU)
    assert len(lams) >= 3
    return np.asarray(lams), np.asarray(Q)


# backward errors below 1e-10 from float32 factors (the floor
# tests/test_refine.py holds the JAX package to); the two packages' refined
# eigenvalues agree to rel 1e-9
@pytest.mark.parametrize("max_batch", [None, 2])
def test_newton_refine_chip_reaches_floor_and_matches_jax(wep_small,
                                                          candidates,
                                                          max_batch):
    w = wep_small
    lams, Q = candidates
    kw = dict(nsweeps=4, tol=1e-11, ir=3, shift_rel=1e-8, max_batch=max_batch)
    stats = {}
    tl, tQ, te = trefine.newton_refine(
        w["mats"], w["fv"], lams, Q, errmeasure=w["backward"],
        dtype=torch.float32, backend="chip", device=CPU, stats=stats, **kw)
    assert np.all(te < 1e-10), te
    # every shift of every chunk and pass was solved by the batched solver,
    # none by the host splu that takes over a shift failing validation
    assert stats["chip_shifts"] >= len(lams)
    assert stats["host_fallback_shifts"] == 0
    assert np.max(np.abs(tl - lams)) < 1e-2  # no pair wandered off
    jl, _, je = jrefine.newton_refine(
        w["jmats"], w["jfv"], lams, Q, errmeasure=w["backward"],
        dtype=jnp.float32, backend="chip", **kw)
    assert np.all(je < 1e-10), je
    assert np.max(np.abs(tl - jl) / np.abs(jl)) < 1e-9
    # and the host backend lands on the same eigenvalues
    hl, _, he = trefine.newton_refine(
        w["mats"], w["fv"], lams, Q, errmeasure=w["backward"],
        backend="host", nsweeps=4, tol=1e-11, shift_rel=1e-8, stats=stats)
    assert np.all(he < 1e-10)
    assert stats["host_fallback_shifts"] == 0  # the host backend counts none
    assert np.max(np.abs(tl - hl) / np.abs(hl)) < 1e-9


def test_newton_refine_without_errmeasure_and_empty_input(wep_small,
                                                          candidates):
    w = wep_small
    lams, Q = candidates
    tl, _, te = trefine.newton_refine(w["mats"], w["fv"], lams[:2], Q[:, :2],
                                      nsweeps=3, ir=3, backend="chip",
                                      device=CPU)
    # residual norms (no scaling): below 1e-7 of ||M|| ~ 1e4 after 3 sweeps
    assert np.all(te < 1e-7)
    out = trefine.newton_refine(w["mats"], w["fv"], np.zeros(0), Q[:, :0],
                                backend="chip", device=CPU)
    assert out[0].shape == (0,) and out[2].shape == (0,)
    with pytest.raises(ValueError, match="backend"):
        trefine.newton_refine(w["mats"], w["fv"], lams, Q, backend="tpu")


def test_resinv_refine_never_worse_and_matches_jax(wep_small):
    """The frozen-shift polisher reuses the scan's own factorization; it never
    degrades a pair, and from identical pairs both packages reach the same
    eigenvalues (rel 1e-6: float32 corrections of float64 residuals)."""
    w = wep_small
    lams, Q, info = iar_real_spmf(
        w["tnep"], sigma=SIGMA, maxit=18, neigs=4, tol=1e-2,
        dtype=torch.float32, errmeasure=w["backward"], return_info=True,
        return_solver=True, device=CPU)
    lams, Q = np.asarray(lams), np.asarray(Q)
    errs0 = np.array([w["backward"](lams[j], Q[:, j])
                      for j in range(len(lams))])
    tl, tQ, te = trefine.resinv_refine(w["mats"], w["fv"], info["solver"],
                                       lams, Q, nsweeps=3,
                                       errmeasure=w["backward"])
    assert np.all(te <= errs0 + 1e-16)
    assert np.any(te < errs0)
    np.testing.assert_allclose(np.linalg.norm(tQ, axis=0), 1.0, rtol=1e-12)
    jsolver = jpart.build_spmf_shift_solver(w["jmats"], w["jfv"], SIGMA,
                                            dtype=jnp.float32)
    jl, _, je = jrefine.resinv_refine(w["jmats"], w["jfv"], jsolver, lams, Q,
                                      nsweeps=3, errmeasure=w["backward"])
    assert np.max(np.abs(tl - jl) / np.abs(jl)) < 1e-6
