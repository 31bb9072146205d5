"""Port parity: the shifted solve (host assembly, SPIKE/block-Thomas banded
solvers, SMW low-rank correction) on the small gun-structured fixture."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import (CPU, SMALL_SIGMA, rel_err, small_gun_like,
                                to_spec)

from neptpu.models.gallery.nlevp import _gun_from_matrices as jax_gun
from neptpu.ops import partitioned as jpart
from neptpu.solvers.spmf_real import collect_spmf_terms as jax_collect
from neptpu.solvers.spmf_real import spmf_fun_scalars
from neptpu_torch.interop import shift_solver_from_arrays
from neptpu_torch.models.gallery.nlevp import _gun_from_matrices
from neptpu_torch.ops import partitioned as tpart
from neptpu_torch.parallel.spike import interleave_complex_banded
from neptpu_torch.solvers.spmf_real import collect_spmf_terms


@pytest.fixture(scope="module")
def terms():
    ops = small_gun_like()
    return collect_spmf_terms(_gun_from_matrices(*ops, device=CPU)), jax_collect(
        jax_gun(*ops))


def _same_parts(a, b):
    strips, offs, Lc, Uc = a
    jstrips, joffs, jLc, jUc = b
    assert list(offs) == list(joffs)
    np.testing.assert_array_equal(strips, jstrips)
    np.testing.assert_array_equal(Lc, jLc)
    np.testing.assert_array_equal(Uc, jUc)


def test_host_assembly_matches_jax(terms):
    (mats, fv), (_, jfv) = terms
    parts = tpart.assemble_shift_parts(mats, fv, SMALL_SIGMA)
    jparts = jpart.assemble_shift_parts(mats, jfv, SMALL_SIGMA)
    _same_parts(parts, jparts)
    _same_parts(tpart.ShiftPlan(mats, fv).parts(SMALL_SIGMA),
                jpart.ShiftPlan(mats, jfv).parts(SMALL_SIGMA))
    split, jsplit = (mod.arrow_split(mats[0], 32) for mod in (tpart, jpart))
    assert abs(split[0] - jsplit[0]).max() == 0 and split[1] == jsplit[1] == []
    bb, jbb = (mod.band_border_split(mats[0], 32) for mod in (tpart, jpart))
    np.testing.assert_array_equal(bb[0], jbb[0])
    assert bb[1] == jbb[1]
    from neptpu.parallel.spike import interleave_complex_banded as jicb

    r, roffs = interleave_complex_banded(parts[0], parts[1])
    jr, jroffs = jicb(parts[0], parts[1])
    np.testing.assert_array_equal(r, jr)
    assert roffs == jroffs


def _dense_M(mats, fv, sigma):
    w = spmf_fun_scalars(fv, sigma)
    return sum(wi * A.astype(complex) for wi, A in zip(w, mats))


def _build(mod, kind, parts, to_dev):
    """InterleavedSMW over the named banded base, from identical host parts."""
    strips, offs, Lc, Uc = parts
    rstrips, roffs = interleave_complex_banded(strips, offs)
    kw = {"device": CPU} if mod is tpart else {}
    if kind == "thomas":
        base = mod.BlockTridiagSolver(rstrips, roffs, mode="lu", **kw)
    else:
        base = mod.PartitionedBandedSolver(rstrips, roffs,
                                           mode=kind.split("-")[1], **kw)
    Lh, Uh = tpart.complex_lowrank_to_half(Lc, Uc)
    return mod.InterleavedSMW(base, to_dev(Lh), to_dev(Uh))


# f64 everywhere; the factorizations differ in rounding only (rel 1e-10)
@pytest.mark.parametrize("kind", ["spike-inv", "spike-lu", "thomas"])
@pytest.mark.parametrize("route", ["native", "interop"])
def test_solve_pair_matches_jax(terms, kind, route):
    (mats, fv), _ = terms
    parts = tpart.assemble_shift_parts(mats, fv, SMALL_SIGMA)
    js = _build(jpart, kind, parts, jnp.asarray)
    ts = (_build(tpart, kind, parts, torch.from_numpy) if route == "native"
          else shift_solver_from_arrays(to_spec(js), device=CPU))
    n = mats[0].shape[0]
    rng = np.random.default_rng(21)
    zre, zim = rng.standard_normal((n, 3)), rng.standard_normal((n, 3))
    xre, xim = ts.solve_pair(torch.from_numpy(zre), torch.from_numpy(zim))
    jre, jim = js.solve_pair(jnp.asarray(zre), jnp.asarray(zim))
    x = xre.numpy() + 1j * xim.numpy()
    assert rel_err(x, np.asarray(jre) + 1j * np.asarray(jim)) < 1e-10
    # the residual of the shifted system itself
    f = zre + 1j * zim
    r = _dense_M(mats, fv, SMALL_SIGMA) @ x - f
    assert np.linalg.norm(r) / np.linalg.norm(f) < 1e-10


@pytest.mark.parametrize("dtype,base", [
    (torch.float64, "BlockTridiagSolver"),        # 'lu' + the 16x bias
    (torch.float32, "PartitionedBandedSolver")])  # 'inv', the card's path
def test_build_spmf_shift_solver_selects_like_jax(terms, dtype, base):
    (mats, fv), (_, jfv) = terms
    ts = tpart.build_spmf_shift_solver(mats, fv, SMALL_SIGMA, dtype=dtype,
                                       device=CPU)
    js = jpart.build_spmf_shift_solver(
        mats, jfv, SMALL_SIGMA,
        dtype=jnp.float64 if dtype == torch.float64 else jnp.float32)
    assert type(ts.base).__name__ == type(js.base).__name__ == base
    assert (ts.mode, ts.refine) == (js.mode, js.refine)
    n = mats[0].shape[0]
    f = np.random.default_rng(22).standard_normal(n) + 0j
    xre, xim = ts.solve_pair(torch.from_numpy(f.real.astype(np.float64)).to(
        dtype), torch.zeros(n, dtype=dtype))
    x = xre.double().numpy() + 1j * xim.double().numpy()
    r = _dense_M(mats, fv, SMALL_SIGMA) @ x - f
    # f32: explicit inverses + 2 refinement steps reach ~f32 accuracy
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert np.linalg.norm(r) / np.linalg.norm(f) < tol


def test_dense_block_lu_fallback_matches_jax(terms):
    """The dense real 2n x 2n block LU (the fallback for bulks that are
    neither banded nor arrow) against the JAX package's, f64 (rel 1e-10)."""
    import importlib

    from neptpu_torch.solvers.iar_real import DenseBlockLU
    from neptpu_torch.solvers.spmf_real import spmf_shift_block_lu

    jiar = importlib.import_module("neptpu.solvers.iar_real")
    jspmf = importlib.import_module("neptpu.solvers.spmf_real")
    (mats, fv), (_, jfv) = terms
    ts = DenseBlockLU(*spmf_shift_block_lu(mats, fv, SMALL_SIGMA,
                                           dtype=torch.float64, device=CPU))
    js = jiar.DenseBlockLU(*jspmf.spmf_shift_block_lu(
        mats, jfv, SMALL_SIGMA, dtype=jnp.float64))
    n = mats[0].shape[0]
    rng = np.random.default_rng(23)
    zre, zim = rng.standard_normal(n), rng.standard_normal(n)
    xre, xim = ts.solve_pair(torch.from_numpy(zre), torch.from_numpy(zim))
    jre, jim = js.solve_pair(jnp.asarray(zre), jnp.asarray(zim))
    x = xre.numpy() + 1j * xim.numpy()
    assert rel_err(x, np.asarray(jre) + 1j * np.asarray(jim)) < 1e-10
    r = _dense_M(mats, fv, SMALL_SIGMA) @ x - (zre + 1j * zim)
    assert np.linalg.norm(r) / np.linalg.norm(zre + 1j * zim) < 1e-10
