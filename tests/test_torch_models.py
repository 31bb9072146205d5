"""Port parity: the compute protocol (Mder / Mlincomb / MM and their
conversions) of the gun-structured problem types — PEP + SPMF summed into an
SPMFSumNEP — and the gallery's full-size gun_like operands."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import CPU, SMALL_SIGMA, rel_err, small_gun_like

import neptpu
from neptpu.models.gallery.nlevp import _gun_from_matrices as jax_gun
from neptpu.solvers.spmf_real import collect_spmf_terms as jax_collect
import neptpu_torch
from neptpu_torch.core.nep import (compute_Mder, compute_Mlincomb, compute_MM,
                                   compute_resnorm, mlincomb_from_mder,
                                   mlincomb_from_mm)
from neptpu_torch.models.gallery.nlevp import _gun_from_matrices
from neptpu_torch.solvers.spmf_real import collect_spmf_terms


@pytest.fixture(scope="module")
def neps():
    ops = small_gun_like()
    return _gun_from_matrices(*ops, device=CPU), jax_gun(*ops)


def _dense(M):
    return M if isinstance(M, torch.Tensor) else M.to_dense()


# complex128 on both sides; the i*sqrt terms go through Denman-Beavers
# matrix square roots of Jordan blocks (rel 1e-11).  The point sits away
# from the second branch cut (lam - 108.8774^2 on the negative real axis),
# where that iteration loses digits in the higher derivatives.
@pytest.mark.parametrize("der", [0, 1, 2])
def test_mder_matches_jax(neps, der):
    tnep, jnep = neps
    lam = 2.0e4 + 100j
    M = _dense(compute_Mder(tnep, lam, der)).numpy()
    J = np.asarray(neptpu.compute_Mder(jnep, lam, der))
    assert rel_err(M, J) < 1e-11


def test_mlincomb_and_conversions_match_jax(neps):
    tnep, jnep = neps
    n = tnep.n
    rng = np.random.default_rng(31)
    V = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    a = np.array([1.0, 0.0, 0.5])
    y = compute_Mlincomb(tnep, SMALL_SIGMA, torch.from_numpy(V),
                         a=torch.from_numpy(a)).numpy()
    yj = np.asarray(neptpu.compute_Mlincomb(jnep, SMALL_SIGMA, jnp.asarray(V),
                                            a=jnp.asarray(a)))
    assert rel_err(y, yj) < 1e-11
    # the same sum through the MM and the Mder conversions
    for conv in (mlincomb_from_mm, mlincomb_from_mder):
        z = conv(tnep, SMALL_SIGMA, torch.from_numpy(V),
                 torch.from_numpy(a)).numpy()
        assert rel_err(z, yj) < 1e-11
    r = float(compute_resnorm(tnep, SMALL_SIGMA, torch.from_numpy(V[:, 0])))
    rj = float(neptpu.compute_resnorm(jnep, SMALL_SIGMA, jnp.asarray(V[:, 0])))
    assert abs(r - rj) < 1e-11 * rj


def test_mm_matches_jax(neps):
    tnep, jnep = neps
    rng = np.random.default_rng(32)
    S = np.diag([1200.0 + 3j, 1260.0 - 1j, 1300.0 + 0.5j])
    S[1, 0] = 0.7
    V = rng.standard_normal((tnep.n, 3)) + 0j
    Z = compute_MM(tnep, torch.from_numpy(S), torch.from_numpy(V)).numpy()
    Zj = np.asarray(neptpu.compute_MM(jnep, jnp.asarray(S), jnp.asarray(V)))
    assert rel_err(Z, Zj) < 1e-11


def test_full_size_gun_like_operands_match_jax():
    """The gallery reads the gun W1/W2 data by file path and builds the same
    four operands as the JAX package (n = 9956; host construction only)."""
    mats, fv = collect_spmf_terms(neptpu_torch.nep_gallery("gun_like", device=CPU))
    jmats, jfv = jax_collect(neptpu.nep_gallery("gun_like"))
    assert mats[0].shape == (9956, 9956) and len(mats) == len(jmats) == 4
    for A, B in zip(mats, jmats):
        assert abs(A - B).max() == 0
    for f, g in zip(fv, jfv):
        np.testing.assert_allclose(f.derivs(2e4 + 100j, 5),
                                   g.derivs(2e4 + 100j, 5), rtol=1e-15)


# f64 on both sides, sums reordered (rel 1e-13)
@pytest.mark.parametrize("fmt", ["dense", "csr", "dia"])
def test_term_banks_match_jax(fmt):
    from neptpu.ops.sparse import make_term_bank as jax_make_term_bank
    from neptpu_torch.ops.sparse import make_term_bank

    K, M, _, _ = small_gun_like(nx=12)
    mats = [K, -M, (0.5 * K + M).tocsr()]
    tb = make_term_bank(mats, fmt=fmt, device=CPU)
    jb = jax_make_term_bank(mats, fmt=fmt)
    assert type(tb).__name__ == type(jb).__name__
    n = K.shape[0]
    rng = np.random.default_rng(33)
    W = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    assert rel_err(tb.lincomb_apply(torch.from_numpy(W)).numpy(),
                   np.asarray(jb.lincomb_apply(jnp.asarray(W)))) < 1e-13
    w = np.array([1.5, -0.5 + 2j, 0.25])
    Mj = jb.combine(jnp.asarray(w))
    Mj = np.asarray(Mj.to_dense() if hasattr(Mj, "to_dense") else Mj)
    assert rel_err(_dense(tb.combine(torch.from_numpy(w))).numpy(), Mj) < 1e-13
    V = rng.standard_normal((n, 2))
    F = rng.standard_normal((3, 2, 2)) + 0j
    Z = tb.mm_apply(torch.from_numpy(V), torch.from_numpy(F)).numpy()
    Zj = np.asarray(jb.mm_apply(jnp.asarray(V), jnp.asarray(F)))
    assert rel_err(Z, Zj) < 1e-13
    for A, B in zip(tb.host_csr_terms(), jb.host_csr_terms()):
        assert abs(A - B).max() == 0


# a model forms its term weights term-major, D @ V^T, for a bank that takes
# them so: the DIA bank gets a contiguous (terms, n) operand (no transpose
# copy in front of the kernel), and the result is that of the row-major
# operand V @ D^T on the same bank (the same GEMM; f64, rel 1e-13)
@pytest.mark.parametrize("kind", ["pep", "spmf", "dep"])
@pytest.mark.parametrize("fmt", ["dia", "csr"])
def test_mlincomb_hands_a_dia_bank_term_major_weights(kind, fmt):
    from neptpu_torch.models.dep import DEP
    from neptpu_torch.models.pep import PEP
    from neptpu_torch.models.spmf import SPMF_NEP
    from neptpu_torch.ops.sparse import make_term_bank

    K, M, _, _ = small_gun_like(nx=12)
    mats = [K, -M, (0.5 * K + M).tocsr()]
    bank = make_term_bank(mats, fmt=fmt, device=CPU)
    nep = {"pep": lambda: PEP(None, bank=bank),
           "dep": lambda: DEP(None, tauv=(0.0, 0.5, 1.5), bank=bank),
           "spmf": lambda: SPMF_NEP(
               None, [lambda S: S, lambda S: S @ S,
                      lambda S: torch.eye(S.shape[0], dtype=S.dtype)],
               bank=bank)}[kind]()
    seen = []
    if fmt == "dia":
        apply_t = bank.lincomb_apply_t
        bank.lincomb_apply_t = lambda WT: (seen.append(WT), apply_t(WT))[1]
    else:
        assert not hasattr(bank, "lincomb_apply_t")
    rng = np.random.default_rng(34)
    V = torch.from_numpy(rng.standard_normal((bank.n, 3))
                         + 1j * rng.standard_normal((bank.n, 3)))
    y = nep.Mlincomb(0.3 + 0.2j, V, a=np.array([1.0, -0.5, 2.0]))
    if fmt == "dia":
        assert len(seen) == 1
        assert seen[0].shape == (3, bank.n) and seen[0].is_contiguous()
    # against the same model on the CSR bank of the same terms (row-major)
    csr = make_term_bank(mats, fmt="csr", device=CPU)
    other = type(nep).__new__(type(nep))
    other.__dict__.update(nep.__dict__, bank=csr)
    yo = other.Mlincomb(0.3 + 0.2j, V, a=np.array([1.0, -0.5, 2.0]))
    assert rel_err(y.numpy(), yo.numpy()) < 1e-13
