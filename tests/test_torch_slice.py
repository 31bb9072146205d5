"""Port parity for the whole slice on the small gun-structured fixture:
problem -> complex-as-real IAR scan -> host Newton refinement, in both
packages, as ``bench.py``'s gun_like phase runs it."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import (SMALL_GAMMA, SMALL_SIGMA, backward_errmeasure,
                                small_gun_like)

from neptpu.models.gallery.nlevp import _gun_from_matrices as jax_gun
from neptpu_torch.models.gallery.nlevp import _gun_from_matrices
from neptpu_torch.solvers.refine import newton_refine
from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                            iar_real_spmf, spmf_fun_scalars)

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
        nep = _gun_from_matrices(*ops)
        mats, fv = collect_spmf_terms(nep)
        meas = backward_errmeasure(mats, fv, spmf_fun_scalars)
        lams, Q = iar_real_spmf(nep, sigma=SMALL_SIGMA, gamma=SMALL_GAMMA,
                                maxit=maxit, neigs=neigs, tol=tol,
                                dtype=dtype, errmeasure=meas, **kw)
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
    from neptpu_torch.solvers.spmf_real import iar_real_spmf_multishift

    ops = small_gun_like()
    sigmas = [SMALL_SIGMA, SMALL_SIGMA + 40.0]
    kw = dict(gamma=SMALL_GAMMA, maxit=30, neigs=16, tol=1e-8)
    jnep = jax_gun(*ops)
    jmats, jfv = jspmf.collect_spmf_terms(jnep)
    jl, _ = jspmf.iar_real_spmf_multishift(
        jnep, sigmas, dtype=jnp.float64,
        errmeasure=backward_errmeasure(jmats, jfv, jspmf.spmf_fun_scalars),
        **kw)
    tnep = _gun_from_matrices(*ops)
    mats, fv = collect_spmf_terms(tnep)
    tl, _ = iar_real_spmf_multishift(
        tnep, sigmas, dtype=torch.float64,
        errmeasure=backward_errmeasure(mats, fv, spmf_fun_scalars), **kw)
    assert len(tl) == len(jl) >= 6
    # unrefined Ritz values at backward error < 1e-8 (rel 1e-7)
    assert np.all(_nearest_rel(tl, jl) < 1e-7)
    assert np.all(_nearest_rel(jl, tl) < 1e-7)


def test_chip_refine_backend_raises():
    mats, fv = collect_spmf_terms(_gun_from_matrices(*small_gun_like()))
    Q = np.ones((mats[0].shape[0], 1), dtype=complex)
    with pytest.raises(NotImplementedError, match="BatchedShiftSMW"):
        newton_refine(mats, fv, np.array([SMALL_SIGMA]), Q, backend="chip")
    # 'auto' resolves to the host backend below the 2n = 2e5 crossover
    lams, Q2, errs = newton_refine(mats, fv, np.array([SMALL_SIGMA]), Q,
                                   nsweeps=1, backend="auto")
    assert Q2.shape == Q.shape and np.isfinite(errs).all()
