"""Port parity for the whole slice: problem -> complex-as-real IAR scan ->
Newton refinement, in both packages, as ``bench.py`` runs it — on the small
gun-structured fixture (one shift, host refinement) and on a small waveguide
(several shifts, host and on-device refinement)."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import (CPU, SMALL_GAMMA, SMALL_SIGMA,
                                backward_errmeasure, small_gun_like)

from neptpu.models.gallery.nlevp import _gun_from_matrices as jax_gun
from neptpu_torch.models.gallery.nlevp import _gun_from_matrices
from neptpu_torch.solvers.refine import newton_refine
from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                            iar_real_spmf,
                                            iar_real_spmf_multishift,
                                            spmf_fun_scalars)

jspmf = importlib.import_module("neptpu.solvers.spmf_real")
jrefine = importlib.import_module("neptpu.solvers.refine")


def _run(pkg, dtype, maxit, neigs, tol, **kw):
    ops = small_gun_like()
    if pkg == "jax":
        nep = jax_gun(*ops)
        mats, fv = jspmf.collect_spmf_terms(nep)
        meas = backward_errmeasure(mats, fv, jspmf.spmf_fun_scalars)
        lams, Q = jspmf.iar_real_spmf(nep, sigma=SMALL_SIGMA,
                                      gamma=SMALL_GAMMA, maxit=maxit,
                                      neigs=neigs, tol=tol, dtype=dtype,
                                      errmeasure=meas, **kw)
        refine = jrefine.newton_refine
    else:
        nep = _gun_from_matrices(*ops, device=CPU)
        mats, fv = collect_spmf_terms(nep)
        meas = backward_errmeasure(mats, fv, spmf_fun_scalars)
        lams, Q = iar_real_spmf(nep, sigma=SMALL_SIGMA, gamma=SMALL_GAMMA,
                                maxit=maxit, neigs=neigs, tol=tol,
                                dtype=dtype, errmeasure=meas, device=CPU,
                                **kw)
        refine = newton_refine
    lams, Q, errs = refine(mats, fv, np.array(lams, complex),
                           np.array(Q, complex), nsweeps=3, tol=1e-11,
                           errmeasure=meas, backend="host", shift_rel=1e-8)
    return np.asarray(lams), errs


def _nearest_rel(a, b):
    """For each value of ``a``, relative distance to the nearest of ``b``."""
    return np.array([np.min(np.abs(b - x)) / abs(x) for x in a])


@pytest.fixture(scope="module")
def jax_reference():
    # neigs above the converged count: every converged pair is returned, so
    # the two packages' sets are comparable (ordering ties between pairs of
    # equal residual must not decide membership)
    return _run("jax", jnp.float64, maxit=40, neigs=16, tol=1e-10)


def test_float64_slice_matches_jax_as_sets(jax_reference):
    jl, je = jax_reference
    tl, te = _run("torch", torch.float64, maxit=40, neigs=16, tol=1e-10)
    assert len(tl) == len(jl) >= 6
    assert np.all(te <= 1e-9) and np.all(je <= 1e-9)
    # refined to ~1e-13 backward error each: sets agree to rel 1e-9
    assert np.all(_nearest_rel(tl, jl) < 1e-9)
    assert np.all(_nearest_rel(jl, tl) < 1e-9)


def test_float32_slice_converges(jax_reference):
    """The card's dtype: float32 scan (explicit-inverse SPIKE + SMW with
    refinement), then host refinement to the float64 floor."""
    jl, _ = jax_reference
    tl, te = _run("torch", torch.float32, maxit=40, neigs=6, tol=1e-5,
                  check_error_every=20)
    assert len(tl) == 6
    assert np.all(te <= 1e-9)
    assert np.all(_nearest_rel(tl, jl) < 1e-9)


def test_multishift_matches_jax_as_sets():
    """Two shifts, shared bank, merged and deduplicated (f64): the same
    converged eigenvalues as the JAX package, to Krylov accuracy."""
    ops = small_gun_like()
    sigmas = [SMALL_SIGMA, SMALL_SIGMA + 40.0]
    kw = dict(gamma=SMALL_GAMMA, maxit=30, neigs=16, tol=1e-8)
    jnep = jax_gun(*ops)
    jmats, jfv = jspmf.collect_spmf_terms(jnep)
    jl, _ = jspmf.iar_real_spmf_multishift(
        jnep, sigmas, dtype=jnp.float64,
        errmeasure=backward_errmeasure(jmats, jfv, jspmf.spmf_fun_scalars),
        **kw)
    tnep = _gun_from_matrices(*ops, device=CPU)
    mats, fv = collect_spmf_terms(tnep)
    tl, _ = iar_real_spmf_multishift(
        tnep, sigmas, dtype=torch.float64, device=CPU,
        errmeasure=backward_errmeasure(mats, fv, spmf_fun_scalars), **kw)
    assert len(tl) == len(jl) >= 6
    # unrefined Ritz values at backward error < 1e-8 (rel 1e-7)
    assert np.all(_nearest_rel(tl, jl) < 1e-7)
    assert np.all(_nearest_rel(jl, tl) < 1e-7)


def test_chip_refine_backend_raises():
    """The chip backend factors on the card: with no device named and no card
    present it raises instead of moving to the CPU."""
    mats, fv = collect_spmf_terms(
        _gun_from_matrices(*small_gun_like(), device=CPU))
    Q = np.ones((mats[0].shape[0], 1), dtype=complex)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            newton_refine(mats, fv, np.array([SMALL_SIGMA]), Q,
                          backend="chip")
    # 'auto' resolves to the host backend below the 2n = 2e5 crossover
    lams, Q2, errs = newton_refine(mats, fv, np.array([SMALL_SIGMA]), Q,
                                   nsweeps=1, backend="auto")
    assert Q2.shape == Q.shape and np.isfinite(errs).all()


WEP = dict(nx=29, nz=21, benchmark_problem="JARLEBRING", neptype="SPMF")
WEP_SIGMAS = [-3 - 3.5j, -1.2 - 1.6j]


def _run_wep(pkg, backend):
    """Multishift float64 scan, then ``newton_refine`` with float32 factors
    on the chip backend (float64 refinement inside), as the wep phase of
    ``bench.py`` is laid out."""
    import neptpu
    import neptpu_torch

    kw = dict(maxit=30, neigs=12, tol=1e-8)
    rkw = dict(nsweeps=3, tol=1e-11, ir=3, shift_rel=1e-8, backend=backend)
    if pkg == "jax":
        nep = neptpu.nep_gallery("waveguide", **WEP)
        mats, fv = jspmf.collect_spmf_terms(nep)
        meas = backward_errmeasure(mats, fv, jspmf.spmf_fun_scalars)
        lams, Q = jspmf.iar_real_spmf_multishift(
            nep, WEP_SIGMAS, dtype=jnp.float64, errmeasure=meas, **kw)
        lams, Q, errs = jrefine.newton_refine(
            mats, fv, np.asarray(lams), np.asarray(Q), errmeasure=meas,
            dtype=jnp.float32, **rkw)
    else:
        nep = neptpu_torch.nep_gallery("waveguide", device=CPU, **WEP)
        mats, fv = collect_spmf_terms(nep)
        meas = backward_errmeasure(mats, fv, spmf_fun_scalars)
        lams, Q = iar_real_spmf_multishift(
            nep, WEP_SIGMAS, dtype=torch.float64, errmeasure=meas,
            device=CPU, **kw)
        lams, Q, errs = newton_refine(
            mats, fv, lams, Q, errmeasure=meas, dtype=torch.float32,
            device=CPU, **rkw)
    return np.asarray(lams), errs


# every pair refined to backward error <= 1e-9 in both packages and with both
# backends; the eigenvalue SETS agree to rel 1e-8 (nearest match — positions
# depend on residual ties)
@pytest.mark.parametrize("backend", ["host", "chip"])
def test_waveguide_slice_matches_jax_as_sets(backend):
    jl, je = _run_wep("jax", backend)
    tl, te = _run_wep("torch", backend)
    assert len(tl) == len(jl) >= 4
    assert np.all(te <= 1e-9) and np.all(je <= 1e-9)
    assert np.all(_nearest_rel(tl, jl) < 1e-8)
    assert np.all(_nearest_rel(jl, tl) < 1e-8)
