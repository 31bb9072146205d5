"""Port parity: the complex-as-real IAR scan step by step, and its host-side
coefficient tables, on the small gun-structured fixture."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import (CPU, SMALL_GAMMA, SMALL_SIGMA, BankSpy,
                                gallery_pair, rel_err, small_gun_like,
                                to_spec)

from neptpu.models.gallery.nlevp import _gun_from_matrices as jax_gun
from neptpu.ops.mixed import make_mixed_bank as jax_make_mixed_bank
from neptpu.ops.partitioned import build_spmf_shift_solver
from neptpu_torch.interop import (bank_from_arrays, carry_from_arrays,
                                  shift_solver_from_arrays)
from neptpu_torch.ops.mixed import make_mixed_bank
from neptpu_torch.models.gallery.nlevp import _gun_from_matrices
from neptpu_torch.solvers import iar_real as tiar
from neptpu_torch.solvers import spmf_real as tspmf

# the modules themselves (``neptpu.solvers`` re-exports same-named functions)
jiar = importlib.import_module("neptpu.solvers.iar_real")
jspmf = importlib.import_module("neptpu.solvers.spmf_real")

M_BASIS = 20


@pytest.fixture(scope="module")
def gun():
    ops = small_gun_like()
    mats, fv = tspmf.collect_spmf_terms(_gun_from_matrices(*ops, device=CPU))
    _, jfv = jspmf.collect_spmf_terms(jax_gun(*ops))
    return mats, fv, jfv


# host complex128 arithmetic on both sides, identical operation order
@pytest.mark.parametrize("scaled", [False, True])
def test_coefficient_tables_match_jax(gun, scaled):
    mats, fv, jfv = gun
    m = 40
    C = tspmf.spmf_coeff_table(fv, SMALL_SIGMA, SMALL_GAMMA, m, scaled=scaled)
    J = jspmf.spmf_coeff_table(jfv, SMALL_SIGMA, SMALL_GAMMA, m, scaled=scaled)
    for a, b in zip(C, J):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=0)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        assert (tspmf.finite_table_prefix(*C, dt)
                == jspmf.finite_table_prefix(*J, jdt))
        theta = tiar.auto_theta(*C, m, dt)
        assert abs(theta - jiar.auto_theta(*J, m, jdt)) <= 1e-14 * theta
        for a, b in zip(tiar.apply_theta(*C, theta),
                        jiar.apply_theta(*J, theta)):
            np.testing.assert_allclose(a, b, rtol=1e-14, atol=0)
    np.testing.assert_allclose(
        tspmf.spmf_fun_scalars(fv, SMALL_SIGMA),
        jspmf.spmf_fun_scalars(jfv, SMALL_SIGMA), rtol=1e-15)


def _matfun_table(fv, sigma, k):
    """The same derivatives through the matrix-function (Denman-Beavers)
    route instead of the closed-form rules."""
    from neptpu_torch.ops.matfun import fun_derivatives

    return np.stack([fun_derivatives(f, sigma, k).numpy() for f in fv])


def test_matrix_function_route_agrees_with_closed_form(gun):
    _, fv, _ = gun
    D = _matfun_table(fv, SMALL_SIGMA, 4)
    ref = np.stack([f.derivs(SMALL_SIGMA, 4) for f in fv])
    # Denman-Beavers sqrt on a Jordan block, complex128
    np.testing.assert_allclose(D, ref, rtol=1e-10, atol=1e-14 * abs(ref).max())


# f64 pairs on both sides from identical operands and state; 10 steps of
# Arnoldi amplify rounding differences mildly (rel 1e-10)
@pytest.mark.parametrize("scaled", [False, True])
def test_scan_chunk_reproduces_jax_hessenberg(gun, scaled):
    mats, _, jfv = gun
    m = M_BASIS
    Cre, Cim = jspmf.spmf_coeff_table(jfv, SMALL_SIGMA, SMALL_GAMMA, m,
                                      scaled=scaled)
    theta = 1.0
    if scaled:
        theta = jiar.auto_theta(Cre, Cim, m, jnp.float64)
        Cre, Cim = jiar.apply_theta(Cre, Cim, theta)
    jbank = jax_make_mixed_bank(mats, dtype=np.float64)
    jsolver = build_spmf_shift_solver(mats, jfv, SMALL_SIGMA,
                                      dtype=jnp.float64)
    n = mats[0].shape[0]
    v = np.ones(n)
    jargs = (jnp.asarray(Cre), jnp.asarray(Cim), jnp.asarray(0.0),
             jnp.asarray(0.0), jsolver)
    jkw = dict(scaled=scaled, inv_theta=jnp.asarray(1.0 / theta))
    carry = jiar._init_carry(m, jnp.asarray(v), jnp.zeros(n), jnp.float64)
    carry = jiar._scan_chunk(jbank, m, 5, jnp.asarray(1), carry, *jargs, **jkw)
    start = [np.asarray(x) for x in carry]
    jout = jiar._scan_chunk(jbank, m, 10, jnp.asarray(6), carry, *jargs, **jkw)

    tcarry = carry_from_arrays(*start, device=CPU)
    tout = tiar._scan_chunk(
        bank_from_arrays(to_spec(jbank), device=CPU), m, 10, 6, tcarry,
        torch.from_numpy(Cre), torch.from_numpy(Cim), 0.0, 0.0,
        shift_solver_from_arrays(to_spec(jsolver), device=CPU),
        scaled=scaled,
        inv_theta=1.0 / theta)
    Hre, Him = tout[2].numpy(), tout[3].numpy()
    assert rel_err(Hre, np.asarray(jout[2])) < 1e-10
    assert rel_err(Him, np.asarray(jout[3])) < 1e-10
    assert np.all(Hre[16:, :] == 0) and np.all(Hre[:, 15:] == 0)
    # the basis stays orthonormal (complex inner product)
    V = tout[0].reshape(m + 1, -1).numpy() + 1j * tout[1].reshape(
        m + 1, -1).numpy()
    G = V[:16].conj() @ V[:16].T
    np.testing.assert_allclose(G, np.eye(16), atol=1e-10)


# the scan holds its term weights term-major and hands them over as they
# are: every step gives the bank two contiguous (terms, n) operands, never a
# transposed view (which would cost a copy launch each on the card)
@pytest.mark.parametrize("kind", ["mixed", "dia"])
def test_scan_step_hands_the_bank_contiguous_term_major_operands(gun, kind):
    m = 6
    if kind == "mixed":
        mats, fv, _ = gun
        bank = make_mixed_bank(mats, dtype=np.float64, device=CPU)
        Cre, Cim = tspmf.spmf_coeff_table(fv, SMALL_SIGMA, SMALL_GAMMA, m)
        solver = tiar.as_pair_solver(tspmf.spmf_shift_block_lu(
            mats, fv, SMALL_SIGMA, dtype=torch.float64, device=CPU))
        gamma = 0.0
    else:
        tnep, _ = gallery_pair("dep_symm_double", 24)  # a DiaTermBank
        bank, gamma = tnep.bank, 1.5
        Cre, Cim = tiar.dep_coeff_table(tnep, -0.2 + 0.1j, gamma, m)
        solver = tiar.as_pair_solver(tiar.dep_shift_block_lu(
            tnep, -0.2 + 0.1j, dtype=torch.float64, device=CPU))
    n = bank.n
    spy = BankSpy(bank)
    one, zero = (torch.ones(n, dtype=torch.float64),
                 torch.zeros(n, dtype=torch.float64))
    out = tiar.iar_real_scan(spy, m, Cre, Cim, gamma, 0.0, one, zero, solver)
    assert spy.seen == [((bank.nterms, n), True)] * (2 * m)
    ref = tiar.iar_real_scan(bank, m, Cre, Cim, gamma, 0.0, one, zero, solver)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
