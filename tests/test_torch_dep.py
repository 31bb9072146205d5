"""Port parity: the delay eigenproblem (``DEP``), its gallery problems and
the DEP front end of the complex-as-real IAR scan, against the JAX package on
the CPU in float64/complex128; and the bfloat16 form of the DIA apply against
the TPU kernel in interpret mode."""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from torch_port_helpers import (CPU, DEP_SIGMA, conj_set_gap, gallery_pair,
                                rel_err, to_spec)

import neptpu
from neptpu.ops.dia import DiaTermBank as JaxDiaTermBank
from neptpu.ops.pallas_spmv import dia_lincomb_pallas
import neptpu_torch
from neptpu_torch.core.nep import compute_Mder, compute_Mlincomb, compute_MM
from neptpu_torch.interop import (block_lu_from_arrays, carry_from_arrays,
                                  dep_from_arrays)
from neptpu_torch.ops import dia_kernel
from neptpu_torch.ops.dia import DiaTermBank
from neptpu_torch.solvers import iar_real as tiar

jiar = importlib.import_module("neptpu.solvers.iar_real")

PROBLEMS = [("dep0", ()), ("dep0_tridiag", (64,)), ("dep_symm_double", (8,))]
SIGMA = DEP_SIGMA


def _dense(M):
    return M if isinstance(M, torch.Tensor) else M.to_dense()


# both sides assemble the same numpy matrices with the same generator
@pytest.mark.parametrize("name,args", PROBLEMS + [
    ("dep0_sparse", (30,)), ("dep1", ()), ("dep_double", ()),
    ("pep0", (12,)), ("pep0_sym", (12,)), ("pep0_sparse", (40,)),
    ("qep_fixed_eig", (4,))])
def test_gallery_operands_are_bit_equal(name, args):
    tnep, jnep = gallery_pair(name, *args)
    assert type(tnep.bank).__name__ == type(jnep.bank).__name__
    for A, B in zip(tnep.bank.host_csr_terms(), jnep.bank.host_csr_terms()):
        assert A.shape == B.shape and abs(A - B).max() == 0
    if hasattr(jnep, "tauv"):
        np.testing.assert_array_equal(tnep.tauv, np.asarray(jnep.tauv))


# complex128 on both sides; closed-form weights, sums in another order
@pytest.mark.parametrize("name,args", PROBLEMS)
@pytest.mark.parametrize("lam", [0.3, -0.4 + 0.2j])
def test_dep_compute_functions_match_jax(name, args, lam):
    tnep, jnep = gallery_pair(name, *args)
    n = tnep.n
    rng = np.random.default_rng(0)
    V = rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
    a = np.array([1.0, 0.5, -2.0, 0.25])
    for sd in (0, 1, 2):
        y = compute_Mlincomb(tnep, lam, torch.from_numpy(V), a, sd).numpy()
        yj = np.asarray(neptpu.compute_Mlincomb(
            jnep, lam, jnp.asarray(V), jnp.asarray(a), sd))
        assert rel_err(y, yj) < 1e-12
    for der in (0, 1, 2):
        M = _dense(compute_Mder(tnep, lam, der)).numpy()
        J = np.asarray(jnep.Mder_dense(lam, der))
        assert rel_err(M, J) < 1e-12
    S = torch.from_numpy(rng.standard_normal((3, 3)) + 0j)
    Z = compute_MM(tnep, S, torch.from_numpy(V[:, :3])).numpy()
    Zj = np.asarray(neptpu.compute_MM(jnep, jnp.asarray(S.numpy()),
                                      jnp.asarray(V[:, :3])))
    assert rel_err(Z, Zj) < 1e-12
    # a real point and real vectors stay real
    yr = compute_Mlincomb(tnep, 0.3, torch.from_numpy(V.real), a)
    assert yr.dtype == torch.float64


def test_dep_spmf_view_and_refusals():
    tnep, jnep = gallery_pair("dep0_tridiag", 64)
    lam = -0.3 + 0.1j
    np.testing.assert_allclose(tnep.fv_scalar(lam).numpy(),
                               np.asarray(jnep.fv_scalar(lam)), rtol=1e-14)
    Av = tnep.get_Av()
    assert len(Av) == 3 and Av[0].to_dense().equal(
        torch.eye(64, dtype=torch.float64))
    with pytest.raises(ValueError, match="real"):
        neptpu_torch.DEP([np.eye(2), np.eye(2)], [0.0, 1.0 + 1.0j],
                         device=CPU)
    with pytest.raises(ValueError, match="one delay per matrix"):
        neptpu_torch.DEP([np.eye(2)], [0.0, 1.0], device=CPU)
    with pytest.raises(ValueError, match="dep_symm_double"):
        neptpu_torch.nep_gallery("no_such_problem")


def test_dep_symm_double_builds_a_nine_diagonal_dia_bank():
    tnep = neptpu_torch.nep_gallery("dep_symm_double", 24, device=CPU)
    assert isinstance(tnep.bank, DiaTermBank) and tnep.bank.nterms == 2
    assert tnep.bank.offsets == (-25, -24, -23, -1, 0, 1, 23, 24, 25)
    # the scans' name for the pair apply
    rng = np.random.default_rng(1)
    Wre, Wim = (torch.from_numpy(rng.standard_normal((tnep.n, 2)))
                for _ in range(2))
    a = tnep.bank.lincomb_apply_split(Wre, Wim)
    b = tnep.bank.lincomb_apply_pair(Wre, Wim)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0], tnep.bank.lincomb_apply(Wre))


# host complex128 recurrences, identical operation order
@pytest.mark.parametrize("scaled", [False, True])
def test_dep_coeff_table_and_block_lu_match_jax(scaled):
    tnep, jnep = gallery_pair("dep0_tridiag", 64)
    C = tiar.dep_coeff_table(tnep, SIGMA, 1.5, 40, scaled=scaled)
    J = jiar.dep_coeff_table(jnep, SIGMA, 1.5, 40, scaled=scaled)
    for x, y in zip(C, J):
        np.testing.assert_allclose(x, y, rtol=1e-13, atol=0)
    lu, piv = tiar.dep_shift_block_lu(tnep, SIGMA, dtype=torch.float64,
                                      device=CPU)
    jlu, jpiv = jiar.dep_shift_block_lu(jnep, SIGMA, dtype=jnp.float64)
    assert rel_err(lu.numpy(), np.asarray(jlu)) < 1e-13
    np.testing.assert_array_equal(piv.numpy() - 1, np.asarray(jpiv))
    r = tiar._dep_host_resnorm(tnep)
    q = np.random.default_rng(2).standard_normal(64) + 0j
    assert abs(r(SIGMA, q) - jiar._dep_host_resnorm(jnep)(SIGMA, q)) < 1e-12


# f64 pairs from identical state; the identity term gre/gim is non-zero here
# (a DEP's -lam*I), 10 Arnoldi steps amplify rounding mildly (rel 1e-10)
def test_iar_real_steps_reproduce_jax_hessenberg():
    tnep, jnep = gallery_pair("dep0_tridiag", 64)
    m, n, gamma = 16, 64, 1.5
    Cre, Cim = jiar.dep_coeff_table(jnep, SIGMA, gamma, m)
    jlu, jpiv = jiar.dep_shift_block_lu(jnep, SIGMA, dtype=jnp.float64)
    jargs = (jnp.asarray(Cre), jnp.asarray(Cim), jnp.asarray(gamma),
             jnp.asarray(0.0), jiar.DenseBlockLU(jlu, jpiv))
    carry = jiar._init_carry(m, jnp.ones(n), jnp.zeros(n), jnp.float64)
    carry = jiar._scan_chunk(jnep.bank, m, 3, jnp.asarray(1), carry, *jargs)
    start = [np.asarray(x) for x in carry]
    jout = jiar._scan_chunk(jnep.bank, m, 10, jnp.asarray(4), carry, *jargs)

    tdep = dep_from_arrays(to_spec(jnep.bank), np.asarray(jnep.tauv),
                           device=CPU)
    solver = block_lu_from_arrays(np.asarray(jlu), np.asarray(jpiv),
                                  device=CPU)
    tout = tiar._scan_chunk(tdep.bank, m, 10, 4,
                            carry_from_arrays(*start, device=CPU),
                            torch.from_numpy(Cre), torch.from_numpy(Cim),
                            gamma, 0.0, solver)
    assert rel_err(tout[2].numpy(), np.asarray(jout[2])) < 1e-10
    assert rel_err(tout[3].numpy(), np.asarray(jout[3])) < 1e-10
    assert rel_err(tout[0].numpy(), np.asarray(jout[0])) < 1e-10
    # and the whole scan from the start vector
    full = tiar.iar_real_scan(tnep.bank, m, Cre, Cim, gamma, 0.0,
                              torch.ones(n, dtype=torch.float64),
                              torch.zeros(n, dtype=torch.float64),
                              *tiar.dep_shift_block_lu(
                                  tnep, SIGMA, dtype=torch.float64,
                                  device=CPU))
    jfull = jiar.iar_real_scan(jnep.bank, m, *jargs[:4], jnp.ones(n),
                               jnp.zeros(n), jlu, jpiv)
    assert rel_err(full[2].numpy(), np.asarray(jfull[2])) < 1e-10


# converged eigenvalues as sets modulo conjugation (the problem is real)
@pytest.mark.parametrize("kw", [dict(), dict(scaled=True),
                                dict(check_error_every=10)])
def test_iar_real_eigenvalues_match_jax(kw):
    tnep, jnep = gallery_pair("dep0_tridiag", 64)
    args = dict(sigma=SIGMA, maxit=30, neigs=6, **kw)
    lj, _ = jiar.iar_real(jnep, dtype=jnp.float64, **args)
    lt, Q, info = tiar.iar_real(tnep, dtype=torch.float64, device=CPU,
                                return_info=True, **args)
    assert len(lt) == len(lj) >= 3 and Q.shape == (64, len(lt))
    assert conj_set_gap(lt, lj) < 1e-9 and conj_set_gap(lj, lt) < 1e-9
    assert info["scaled"] == bool(kw.get("scaled", False))


def test_iar_real_reuses_a_factorization_and_takes_an_errmeasure():
    tnep, _ = gallery_pair("dep0_tridiag", 64)
    lu_piv = tiar.dep_shift_block_lu(tnep, SIGMA, dtype=torch.float64,
                                     device=CPU)
    calls = []

    def meas(lam, q):
        calls.append(lam)
        return tiar._dep_host_resnorm(tnep)(lam, q)

    a, _ = tiar.iar_real(tnep, sigma=SIGMA, maxit=30, dtype=torch.float64,
                         lu_piv=lu_piv, errmeasure=meas, device=CPU)
    b, _ = tiar.iar_real(tnep, sigma=SIGMA, maxit=30, dtype=torch.float64,
                         device=CPU)
    assert calls and conj_set_gap(a, b) < 1e-12
    # the float32 table of a long run overflows unless scaled: 'auto' scales
    with pytest.warns(UserWarning, match="truncating maxit"):
        tiar.iar_real(tnep, sigma=SIGMA, gamma=40.0, maxit=60, neigs=1,
                      dtype=torch.float32, scaled=False, device=CPU)
    _, _, info = tiar.iar_real(tnep, sigma=SIGMA, gamma=40.0, maxit=60,
                               neigs=1, dtype=torch.float32, device=CPU,
                               return_info=True)
    assert info["scaled"] and info["k_done"] == 60


# bf16 inputs: the twin forms each product exactly in float32, the TPU body
# rounds it to bf16 first (2^-9 of the product); with the float32 sums in
# another order both stay within 2^-7 of the row's sum |data W|
@pytest.mark.parametrize("offs", [[-26, -25, -1, 0, 1, 25, 26],
                                  [-9, -8, -7, -1, 0, 1, 7, 8, 9]])
def test_bf16_twin_matches_pallas_interpret(offs):
    n, m = 700, 3
    rng = np.random.default_rng(3)
    mats = [sp.diags([rng.standard_normal(n - abs(o)).astype(np.float32)
                      for o in offs], offs, shape=(n, n), format="csr")
            for _ in range(m)]
    W = rng.standard_normal((n, m)).astype(np.float32)
    jb = JaxDiaTermBank.from_matrices(mats, dtype=np.float32)
    tb = DiaTermBank.from_matrices(mats, dtype=np.float32,
                                   device=CPU).astype(torch.bfloat16)
    W16 = torch.from_numpy(W).to(torch.bfloat16)
    before = dia_kernel.DIA_SPMV.launches
    y = tb.lincomb_apply(W16)
    yre, yim = tb.lincomb_apply_pair(W16, W16.flip(0))
    assert dia_kernel.DIA_SPMV.launches == before
    assert y.dtype == yre.dtype == yim.dtype == torch.float32
    assert torch.equal(y, yre)
    assert torch.equal(yim, tb.lincomb_apply(W16.flip(0)))
    y_pal = np.asarray(dia_lincomb_pallas(
        jb.data.astype(jnp.bfloat16), jb.offsets,
        jnp.asarray(W).astype(jnp.bfloat16), block_rows=256, interpret=True))
    assert y_pal.dtype == np.float32
    room = sum(abs(A) @ np.abs(W[:, i]) for i, A in enumerate(mats))
    assert np.all(np.abs(y.numpy() - y_pal) <= 2.0**-7 * room)
    # and against the exact product of the rounded inputs
    d16 = tb.data.to(torch.float64).numpy()
    ref = dia_kernel.dia_lincomb_plain(
        torch.from_numpy(d16), tb.offsets,
        W16.to(torch.float64).T.contiguous()).numpy()
    assert np.all(np.abs(y.numpy() - ref) <= 2.0**-20 * room)
    assert dia_kernel.result_dtype(torch.bfloat16) == torch.float32
    assert dia_kernel.result_dtype(torch.float64) == torch.float64
