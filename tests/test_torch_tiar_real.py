"""Port parity: the complex-as-real tensor infinite Arnoldi (``tiar_real``)
step by step and as a whole, against the JAX package on the CPU in float64."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import (CPU, DEP_SIGMA as SIGMA, SMALL_GAMMA,
                                SMALL_SIGMA, BankSpy, conj_set_gap,
                                gallery_pair, rel_err, small_gun_like,
                                to_spec)

from neptpu.models.gallery.nlevp import _gun_from_matrices as jax_gun
from neptpu_torch.interop import (block_lu_from_arrays, carry_from_arrays,
                                  dep_from_arrays)
from neptpu_torch.models.gallery.nlevp import _gun_from_matrices
from neptpu_torch.solvers import iar_real as tiar
from neptpu_torch.solvers import tiar_real as ttiar

jiar = importlib.import_module("neptpu.solvers.iar_real")
jtiar = importlib.import_module("neptpu.solvers.tiar_real")

NAMES = ["Zre", "Zim", "are", "aim", "Hre", "Him"]


@pytest.fixture(scope="module")
def dep():
    tnep, jnep = gallery_pair("dep0_tridiag", 64)
    m, gamma = 16, 1.5
    Cre, Cim = jiar.dep_coeff_table(jnep, SIGMA, gamma, m)
    jlu, jpiv = jiar.dep_shift_block_lu(jnep, SIGMA, dtype=jnp.float64)
    return tnep, jnep, m, gamma, Cre, Cim, jlu, jpiv


# f64 pairs from identical operands and state, the JAX operation order kept;
# 10 steps amplify rounding mildly (rel 1e-10)
def test_tiar_real_steps_reproduce_jax_carry(dep):
    tnep, jnep, m, gamma, Cre, Cim, jlu, jpiv = dep
    n = 64
    jargs = (jnp.asarray(Cre), jnp.asarray(Cim), jnp.asarray(gamma),
             jnp.asarray(0.0), jlu, jpiv)
    carry = jtiar._tiar_init(m, jnp.ones(n), jnp.zeros(n), jnp.float64)
    carry = jtiar._tiar_chunk(jnep.bank, m, 3, jnp.asarray(1), carry, *jargs)
    start = [np.asarray(x) for x in carry]
    jout = jtiar._tiar_chunk(jnep.bank, m, 10, jnp.asarray(4), carry, *jargs)

    tdep = dep_from_arrays(to_spec(jnep.bank), np.asarray(jnep.tauv),
                           device=CPU)
    solver = block_lu_from_arrays(np.asarray(jlu), np.asarray(jpiv),
                                  device=CPU)
    tout = ttiar._tiar_chunk(tdep.bank, m, 10, 4,
                             carry_from_arrays(*start, device=CPU),
                             torch.from_numpy(Cre), torch.from_numpy(Cim),
                             gamma, 0.0, solver)
    for name, x, y in zip(NAMES, tout, jout):
        assert rel_err(x.numpy(), np.asarray(y)) < 1e-10, name
    # padding invariant: nothing beyond the 13 steps done
    assert np.all(tout[0].numpy()[:, 14:] == 0)
    assert np.all(tout[2].numpy()[:, 14:, :] == 0)
    Z = tout[0].numpy() + 1j * tout[1].numpy()
    np.testing.assert_allclose(Z[:, :14].conj().T @ Z[:, :14], np.eye(14),
                               atol=1e-12)


def test_tiar_real_scan_matches_jax_and_the_iar_hessenberg(dep):
    tnep, jnep, m, gamma, Cre, Cim, jlu, jpiv = dep
    n = 64
    one, zero = (torch.ones(n, dtype=torch.float64),
                 torch.zeros(n, dtype=torch.float64))
    lu, piv = tiar.dep_shift_block_lu(tnep, SIGMA, dtype=torch.float64,
                                      device=CPU)
    tout = ttiar.tiar_real_scan(tnep.bank, m, Cre, Cim, gamma, 0.0, one, zero,
                                lu, piv)
    jout = jtiar.tiar_real_scan(jnep.bank, m, jnp.asarray(Cre),
                                jnp.asarray(Cim), jnp.asarray(gamma),
                                jnp.asarray(0.0), jnp.ones(n), jnp.zeros(n),
                                jlu, jpiv)
    for name, x, y in zip(NAMES, tout, jout):
        assert rel_err(x.numpy(), np.asarray(y)) < 1e-10, name
    # TIAR and IAR build the same Hessenberg (same Krylov space, same
    # orthogonalization in exact arithmetic)
    iout = tiar.iar_real_scan(tnep.bank, m, Cre, Cim, gamma, 0.0, one, zero,
                              lu, piv)
    assert rel_err(tout[4].numpy(), iout[2].numpy()) < 1e-9
    assert rel_err(tout[5].numpy(), iout[3].numpy()) < 1e-9


# converged eigenvalues as sets modulo conjugation (the problem is real)
@pytest.mark.parametrize("every", [None, 10])
def test_tiar_real_eigenvalues_match_jax_and_iar_real(dep, every):
    tnep, jnep = dep[:2]
    args = dict(sigma=SIGMA, maxit=30, neigs=6, check_error_every=every)
    lj, _ = jtiar.tiar_real(jnep, dtype=jnp.float64, **args)
    lt, Q, info = ttiar.tiar_real(tnep, dtype=torch.float64, device=CPU,
                                  return_info=True, **args)
    assert len(lt) == len(lj) >= 3 and Q.shape == (64, len(lt))
    assert conj_set_gap(lt, lj) < 1e-9 and conj_set_gap(lj, lt) < 1e-9
    assert info["k_done"] == 30 and info["t_factorize"] > 0
    li, _ = tiar.iar_real(tnep, dtype=torch.float64, device=CPU, **args)
    assert conj_set_gap(lt, li) < 1e-9
    res = tiar._dep_host_resnorm(tnep)
    assert max(res(l, Q[:, i]) for i, l in enumerate(lt)) < 1e4 * 2.3e-16


def test_tiar_real_spmf_matches_jax():
    ops = small_gun_like(nx=16)
    tnep, jnep = _gun_from_matrices(*ops, device=CPU), jax_gun(*ops)
    args = dict(sigma=SMALL_SIGMA, gamma=SMALL_GAMMA, maxit=24, neigs=4,
                tol=1e-9)
    lj, _ = jtiar.tiar_real_spmf(jnep, dtype=jnp.float64, **args)
    lt, Q = ttiar.tiar_real_spmf(tnep, dtype=torch.float64, device=CPU,
                                 **args)
    assert len(lt) == len(lj) >= 2 and Q.shape[0] == tnep.n
    assert max(np.min(np.abs(np.asarray(lj) - x)) / abs(x) for x in lt) < 1e-9


# as in iar_real: the (terms, n) weights reach the bank as they are held
def test_tiar_step_hands_the_bank_contiguous_term_major_operands():
    tnep, _ = gallery_pair("dep_symm_double", 24)  # a DiaTermBank
    n, m, gamma = tnep.n, 8, 1.5
    Cre, Cim = tiar.dep_coeff_table(tnep, SIGMA, gamma, m)
    one, zero = (torch.ones(n, dtype=torch.float64),
                 torch.zeros(n, dtype=torch.float64))
    lu, piv = tiar.dep_shift_block_lu(tnep, SIGMA, dtype=torch.float64,
                                      device=CPU)
    spy = BankSpy(tnep.bank)
    out = ttiar.tiar_real_scan(spy, m, Cre, Cim, gamma, 0.0, one, zero, lu,
                               piv)
    assert spy.seen == [((tnep.bank.nterms, n), True)] * (2 * m)
    ref = ttiar.tiar_real_scan(tnep.bank, m, Cre, Cim, gamma, 0.0, one, zero,
                               lu, piv)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
