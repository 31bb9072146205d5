"""Port parity: the complex-dtype scans ``iar_jitted`` (padded IAR),
``tiar_jitted`` (TIAR on a delay problem) and ``tiar_jitted_spmf`` (TIAR on
an SPMF over the merged term bank) against the JAX package on the CPU."""
import numpy as np
import pytest
import torch

from torch_port_helpers import (CPU, DEP_SIGMA, conj_set_gap, gallery_pair,
                                rel_err, small_gun_like)

import neptpu
import neptpu_torch
from neptpu.models.gallery.nlevp import _gun_from_matrices as jgun
from neptpu.solvers.iar_jit import iar_jitted as j_iar_jitted
from neptpu.solvers.iar_jit import iar_scan_kernel as j_kernel
from neptpu.solvers.tiar_jit import tiar_jitted as j_tiar_jitted
from neptpu.solvers.tiar_jit import tiar_jitted_spmf as j_tiar_spmf
from neptpu_torch.models.gallery.nlevp import _gun_from_matrices as tgun
from neptpu_torch.solvers.iar_jit import iar_scan_kernel
from neptpu_torch.solvers.tiar_jit import tiar_scan_complex


def test_iar_jitted_matches_jax_on_dep0():
    """The same three pairs as the JAX package's padded IAR (and as the
    protocol ``iar``), modulo conjugation, within 1e-12."""
    tn, jn = gallery_pair("dep0")
    kw = dict(sigma=0.0, neigs=3, maxit=40, v=np.ones(5), tol=1e-10)
    lj, _, _ = j_iar_jitted(jn, **kw)
    lt, Qt, V = neptpu_torch.iar_jitted(tn, device=CPU, **kw)
    assert len(lt) == 3 and V.shape == (41, 41, 5)
    assert conj_set_gap(lt, np.asarray(lj)) < 1e-12
    li, _, _ = neptpu_torch.iar(tn, device=CPU, **kw)
    assert conj_set_gap(lt, li) < 1e-10
    for s in range(3):
        r = float(neptpu_torch.compute_resnorm(tn, lt[s], Qt[:, s]))
        assert r / float(torch.linalg.vector_norm(Qt[:, s])) < 1e-8


def test_iar_scan_kernel_matches_jax_steps():
    """The padded basis and Hessenberg after 8 steps, entry by entry:
    rel 1e-13."""
    import jax.numpy as jnp

    tn, jn = gallery_pair("dep0_tridiag", 32)
    sj = neptpu.ops.linsolve.create_linsolver(None, jn, jnp.asarray(DEP_SIGMA))
    st = neptpu_torch.create_linsolver(None, tn, DEP_SIGMA)
    v0 = np.random.default_rng(0).standard_normal(32)
    Vj, Hj = j_kernel(jn, 8, jnp.asarray(DEP_SIGMA), jnp.asarray(0.5 + 0j),
                      jnp.asarray(v0, dtype=complex), sj.lu)
    Vt, Ht = iar_scan_kernel(tn, 8, DEP_SIGMA, 0.5, torch.as_tensor(v0),
                             (st.lu, st.piv))
    assert rel_err(Ht.numpy(), np.asarray(Hj)) < 1e-13
    assert rel_err(Vt.numpy(), np.asarray(Vj)) < 1e-13


def test_tiar_jitted_matches_jax_on_dep0_tridiag():
    tn, jn = gallery_pair("dep0_tridiag", 64)
    kw = dict(sigma=-0.3, maxit=40, neigs=4, tol=1e-10, return_info=True)
    lj, _, ij = j_tiar_jitted(jn, **kw)
    lt, Qt, it = neptpu_torch.tiar_jitted(tn, device=CPU, **kw)
    assert it["nconv"] == ij["nconv"] >= 3
    assert conj_set_gap(lt, lj) < 1e-12 and conj_set_gap(lj, lt) < 1e-12
    l2, _, _ = neptpu_torch.tiar(tn, sigma=-0.3, maxit=40, neigs=8, tol=1e-9,
                                 device=CPU)
    assert conj_set_gap(lt, l2) < 1e-8
    for s in range(len(lt)):
        r = float(neptpu_torch.compute_resnorm(tn, lt[s],
                                               torch.as_tensor(Qt[:, s])))
        assert r < 1e-9


def test_tiar_scan_complex_carry_matches_jax():
    """The raw scan's carry (Z, a, H) after 10 steps: rel 1e-12."""
    import jax.numpy as jnp

    from neptpu.solvers.iar_real import dep_coeff_table as jtable
    from neptpu.solvers.tiar_jit import tiar_scan_complex as j_scan

    tn, jn = gallery_pair("dep0_tridiag", 32)
    Cre, Cim = jtable(jn, DEP_SIGMA, 1.0, 10)
    C = Cre + 1j * Cim
    M = np.array(jn.Mder_dense(DEP_SIGMA))
    import jax.scipy.linalg as jsl

    lu, piv = jsl.lu_factor(jnp.asarray(M))
    v0 = np.ones(32, dtype=complex)
    Zj, aj, Hj = j_scan(jn.bank, 10, jnp.asarray(C), jnp.asarray(1.0 + 0j),
                        jnp.asarray(v0), lu, piv)
    tl, tp = torch.linalg.lu_factor(torch.as_tensor(M))
    Zt, at, Ht = tiar_scan_complex(tn.bank, 10, torch.as_tensor(C), 1.0 + 0j,
                                   torch.as_tensor(v0), tl, tp)
    assert rel_err(Ht.numpy(), np.asarray(Hj)) < 1e-12
    assert rel_err(Zt.numpy(), np.asarray(Zj)) < 1e-12
    assert rel_err(at.numpy(), np.asarray(aj)) < 1e-12


@pytest.fixture(scope="module")
def small_gun():
    ops = small_gun_like(nx=12)
    return tgun(*ops, device=CPU), jgun(*ops)


@pytest.mark.parametrize("every", [None, 10])
def test_tiar_jitted_spmf_matches_jax_on_a_small_gun(small_gun, every):
    """The complex TIAR over the merged term bank on a gun-structured
    problem at n = 144: the same converged set as the JAX package's, modulo
    conjugation, within 1e-10, in chunks or in one run."""
    tn, jn = small_gun
    kw = dict(sigma=300 + 5j, gamma=150.0, maxit=30, neigs=4, tol=1e-8,
              return_info=True, check_error_every=every)
    lj, _, ij = j_tiar_spmf(jn, **kw)
    lt, Qt, it = neptpu_torch.tiar_jitted_spmf(tn, device=CPU, **kw)
    assert it["nconv"] == ij["nconv"] >= 4 and it["k_done"] == ij["k_done"]
    assert conj_set_gap(lt, lj) < 1e-10
    for s in range(len(lt)):
        r = float(neptpu_torch.compute_resnorm(tn, lt[s],
                                               torch.as_tensor(Qt[:, s])))
        assert r / float(np.linalg.norm(Qt[:, s])) < 1e-6


def test_tiar_jitted_spmf_applies_the_bank_to_the_complex_operand(small_gun):
    """A scan step hands the merged bank one complex ``(n, terms)``
    operand through ``lincomb_apply`` (split into the re/im pair inside the
    bank: one pair launch on the card)."""
    from neptpu_torch.ops.mixed import MixedTermBank

    tn, _ = small_gun
    seen = []
    orig = MixedTermBank.lincomb_apply

    def spy(self, W):
        seen.append((tuple(W.shape), W.dtype))
        return orig(self, W)

    MixedTermBank.lincomb_apply = spy
    try:
        neptpu_torch.tiar_jitted_spmf(tn, sigma=300 + 5j, gamma=150.0,
                                      maxit=6, neigs=1, device=CPU)
    finally:
        MixedTermBank.lincomb_apply = orig
    assert seen == [((tn.n, 4), torch.complex128)] * 6


@pytest.fixture(scope="module")
def deflated_pep0():
    """``pep0`` (n = 200) deflated by the pair the JAX package's
    ``iar_jitted`` finds first at sigma = 0, in both packages."""
    tn, jn = gallery_pair("pep0")
    lj, Qj, _ = j_iar_jitted(jn, sigma=0.0, neigs=1, maxit=30)
    lam, v = complex(np.asarray(lj)[0]), np.array(Qj)[:, 0]
    return (neptpu_torch.deflate_eigpair(tn, lam, torch.from_numpy(v)),
            neptpu.deflate_eigpair(jn, lam, v), lam)


def test_shift_tables_unwrap_delegating_problems(deflated_pep0):
    """A deflated SPMF's Mlincomb only calls its ``spmf``'s, so the scan's
    derivative tables are that sum's (no host work a step, so the card
    captures it); a projected problem delegates to its ``nep_proj``."""
    from neptpu_torch.solvers.iar_jit import _shift_tables

    dnep = deflated_pep0[0]
    alpha = np.array([0.5**j for j in range(6)], dtype=complex)
    got = _shift_tables(dnep, 0.1 + 0.2j, alpha, torch.device(CPU))
    ref = _shift_tables(dnep.spmf, 0.1 + 0.2j, alpha, torch.device(CPU))
    assert got is not None and got[1] == ref[1] == 0.0
    assert [b for b, _ in got[0]] == [b for b, _ in ref[0]]
    for (_, a), (_, b) in zip(got[0], ref[0]):
        assert torch.equal(a, b)
    proj = neptpu_torch.create_proj_NEP(dnep.spmf.nep1)
    assert _shift_tables(proj, 0.0, alpha, torch.device(CPU)) is None
    V = torch.eye(dnep.n, 3, dtype=torch.complex128)
    neptpu_torch.set_projectmatrices(proj, V, V)
    assert _shift_tables(proj, 0.0, alpha, torch.device(CPU)) is not None


def test_iar_jitted_on_a_deflated_pep_matches_jax(deflated_pep0):
    """``iar_jitted`` on the deflated problem converges to the JAX
    package's eigenvalue (the conjugate of the deflated one) within rel
    1e-8."""
    tn, jn, lam = deflated_pep0
    kw = dict(sigma=0.0, neigs=1, maxit=30)
    lj, _, _ = j_iar_jitted(jn, **kw)
    lt, Qt, _ = neptpu_torch.iar_jitted(tn, device=CPU, **kw)
    lj, lt = np.asarray(lj), np.asarray(lt)
    assert len(lt) == len(lj) == 1
    assert abs(lt[0] - lj[0]) < 1e-8 * abs(lj[0])
    assert abs(lt[0] - np.conj(lam)) < 1e-8 * abs(lam)
