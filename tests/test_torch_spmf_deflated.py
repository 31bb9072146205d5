"""Port parity: the deflated complex-as-real SPMF scan (Effenberger
deflation inside the scan step: ``DeflationOps``, the deflated step and the
restarted ``iar_real_spmf_deflated``), against the JAX package on the CPU in
float64.

Tolerances: the operands of ``DeflationOps`` are the same complex128 host
algebra on both sides (1e-14); one deflated step is the same float64
arithmetic in another order (1e-12); the whole restarted run must take the
same sweeps and give eigenvalues within rel 1e-9 (conjugation-aware)."""
import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import (CPU, backward_errmeasure, conj_set_gap,
                                rel_err, small_gun_ops)

import neptpu
import neptpu_torch
from neptpu.models.gallery.nlevp import _i_sqrt_shifted as j_i_sqrt
from neptpu_torch.models.gallery.nlevp import _i_sqrt_shifted as t_i_sqrt
from neptpu_torch.ops.mixed import make_mixed_bank
from neptpu_torch.solvers import iar_real as tiar_real
from neptpu_torch.solvers import spmf_real as tspmf_real

# the JAX package's solvers/__init__ re-exports the function iar_real over
# its module's name
jiar_real = importlib.import_module("neptpu.solvers.iar_real")
jspmf_real = importlib.import_module("neptpu.solvers.spmf_real")

SIGMA = 30 + 1j


def _small_gun_pair(n=60):
    K, mM, W1, W2 = small_gun_ops(n)
    jnep = neptpu.SumNEP(neptpu.PEP([K, mM]),
                         neptpu.SPMF_NEP([W1, W2], [j_i_sqrt(0.0),
                                                    j_i_sqrt(9.0)]))
    tnep = neptpu_torch.SumNEP(
        neptpu_torch.PEP([K, mM], device=CPU),
        neptpu_torch.SPMF_NEP([W1, W2], [t_i_sqrt(0.0), t_i_sqrt(9.0)],
                              device=CPU))
    return tnep, jnep


def _pair(n, p=2, seed=3):
    """An invariant-pair-shaped (X, S): X orthonormal (n, p), S upper
    triangular with eigenvalues near sigma."""
    rng = np.random.default_rng(seed)
    X, _ = np.linalg.qr(rng.standard_normal((n, p))
                        + 1j * rng.standard_normal((n, p)))
    S = np.triu(rng.standard_normal((p, p)) + 1j * rng.standard_normal((p, p)))
    S[np.diag_indices(p)] = SIGMA + np.array([0.4 + 0.1j, -0.7 + 0.3j])[:p]
    return X, S


def test_deflation_ops_build_matches_jax():
    X, S = _pair(60)
    m, gt = 6, 0.7
    t = tiar_real.DeflationOps.build(X, S, SIGMA, gt, m, torch.float64,
                                     device=CPU)
    j = jiar_real.DeflationOps.build(X, S, SIGMA, gt, m, jnp.float64)
    assert t.p == j.p == 2
    for name in ("Tre", "Tim", "Xre", "Xim", "Pre", "Pim", "Gre", "Gim"):
        a = getattr(t, name).numpy()
        b = np.asarray(getattr(j, name))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-14 * max(np.abs(b).max(), 1.0), name
    assert t.max_abs_T() == pytest.approx(
        max(np.abs(np.asarray(j.Tre)).max(), np.abs(np.asarray(j.Tim)).max()))


def _carry_from(Vre, Vim, Hre, Him):
    return tuple(torch.from_numpy(np.array(x)) for x in (Vre, Vim, Hre, Him))


@pytest.mark.parametrize("k", [1, 3])
def test_deflated_step_matches_jax_step_fn(k):
    """One deflated scan step on the same carry: the port's in-place step
    against JAX's ``_step_fn(defl=...)`` in float64."""
    tnep, jnep = _small_gun_pair()
    mats, fv = tspmf_real.collect_spmf_terms(tnep)
    n, m, p = tnep.n, 6, 2
    X, S = _pair(n, p)
    gamma, theta = 1.0, 1.3
    Cre, Cim = tspmf_real.spmf_coeff_table(fv, SIGMA, gamma, m, scaled=True)
    Cre, Cim = tiar_real.apply_theta(Cre, Cim, theta)
    f0 = tspmf_real.spmf_fun_scalars(fv, SIGMA)
    Cre[:, 0], Cim[:, 0] = f0.real, f0.imag
    rng = np.random.default_rng(11)
    shape = (m + 1, m + 1, n + p)
    Vre = np.zeros(shape)
    Vim = np.zeros(shape)
    Vre[:k] = rng.standard_normal((k,) + shape[1:])
    Vim[:k] = rng.standard_normal((k,) + shape[1:])
    Hre = np.zeros((m + 1, m))
    Him = np.zeros((m + 1, m))
    # the same dense block LU of M(sigma) on both sides
    lu_t = tspmf_real.spmf_shift_block_lu(mats, fv, SIGMA,
                                          dtype=torch.float64, device=CPU)
    jmats, jfv = jspmf_real.collect_spmf_terms(jnep)
    lu_j = jspmf_real.spmf_shift_block_lu(jmats, jfv, SIGMA,
                                          dtype=jnp.float64)
    tbank = make_mixed_bank(mats, dtype=np.float64, device=CPU)
    from neptpu.ops.mixed import make_mixed_bank as jmake

    jbank = jmake(jmats, dtype=np.float64)
    tdefl = tiar_real.DeflationOps.build(X, S, SIGMA, gamma * theta, m,
                                         torch.float64, device=CPU)
    jdefl = jiar_real.DeflationOps.build(X, S, SIGMA, gamma * theta, m,
                                         jnp.float64)
    carry = _carry_from(Vre, Vim, Hre, Him)
    beta = tiar_real._step_fn(
        tbank, m, torch.from_numpy(Cre), torch.from_numpy(Cim), 0.0, 0.0,
        tiar_real.DenseBlockLU(*lu_t), torch.float64, scaled=True,
        inv_theta=1.0 / theta, defl=tdefl)(carry, torch.tensor(k))
    step = jiar_real._step_fn(
        jbank, m, jnp.asarray(Cre), jnp.asarray(Cim), 0.0, 0.0,
        jiar_real.DenseBlockLU(*lu_j), jnp.float64, scaled=True,
        inv_theta=1.0 / theta, defl=jdefl)
    jcarry, jbeta = step(tuple(jnp.asarray(x) for x in (Vre, Vim, Hre, Him)),
                         k)
    assert abs(float(beta) - float(jbeta)) <= 1e-12 * abs(float(jbeta))
    for a, b in zip(carry, jcarry):
        assert rel_err(a.numpy(), np.asarray(b)) < 1e-12


def test_effenberger_contraction_matches_deflated_mlincomb():
    """The port's in-scan extension ``v' = v + X t`` then the ordinary
    table contraction equals the deflated problem's ``Mlincomb`` (the JAX
    test ``test_deflation_ops_matches_reference_deflated_mlincomb``, in the
    port), and equals the JAX package's deflated ``Mlincomb``."""
    tnep, jnep = _small_gun_pair()
    mats, fv = tspmf_real.collect_spmf_terms(tnep)
    n = tnep.n
    rng = np.random.default_rng(5)
    lam0 = 30.1 + 0.2j
    x0 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x0 /= np.linalg.norm(x0)
    dnep = neptpu_torch.deflate_eigpair(tnep, lam0, torch.from_numpy(x0),
                                        mode=":Generic")
    X, S = np.asarray(dnep.V0), np.asarray(dnep.S0)
    p, m, gt = 1, 6, 0.7
    defl = tiar_real.DeflationOps.build(X, S, SIGMA, gt, m, torch.float64,
                                        device=CPU)
    U = np.zeros((m + 1, n + p), dtype=complex)
    U[1:] = (rng.standard_normal((m, n + p))
             + 1j * rng.standard_normal((m, n + p)))
    vpre, vpim = defl.extend(torch.from_numpy(U.real.copy()),
                             torch.from_numpy(U.imag.copy()))
    vp = vpre.numpy() + 1j * vpim.numpy()
    Cre, Cim = tspmf_real.spmf_coeff_table(fv, SIGMA, 1.0, m, scaled=True)
    C = Cre + 1j * Cim
    for j in range(m + 1):
        C[:, j] *= gt ** j
    C[:, 0] = tspmf_real.spmf_fun_scalars(fv, SIGMA)
    z = np.zeros(n, dtype=complex)
    for i, A in enumerate(mats):
        z += A @ (vp.T @ C[i])
    a = np.array([0.0] + [gt ** j / math.factorial(j)
                          for j in range(1, m + 1)])
    z_ref = dnep.Mlincomb(SIGMA, torch.from_numpy(U.T.copy()), a=a).numpy()
    assert np.linalg.norm(z - z_ref[:n]) < 1e-12 * np.linalg.norm(z_ref[:n])
    jd = neptpu.deflate_eigpair(jnep, lam0, x0, mode=":Generic")
    zj = np.asarray(jd.Mlincomb(SIGMA, jnp.asarray(U.T), a=jnp.asarray(a)))
    assert rel_err(z_ref, zj) < 1e-12


# (maxit, tol): the JAX package's own test arguments (16, 1e-7), and a
# shorter scan (10, 1e-6) whose deflated sweeps converge pairs
PROBE = (16, 1e-7)
SHORT = (10, 1e-6)


@pytest.fixture(scope="module", params=[PROBE, SHORT], ids=["probe", "short"])
def deflated_runs(request):
    """The whole restarted run in both packages."""
    maxit, tol = request.param
    tnep, jnep = _small_gun_pair()
    kw = dict(sigma=SIGMA, maxit=maxit, neigs=5, tol=tol,
              check_error_every=maxit // 2, return_info=True)
    t = tspmf_real.iar_real_spmf_deflated(tnep, dtype=torch.float64,
                                          device=CPU, **kw)
    j = jspmf_real.iar_real_spmf_deflated(jnep, dtype=jnp.float64, **kw)
    return request.param, tnep, t, j


def test_iar_real_spmf_deflated_matches_jax(deflated_runs):
    """The same sweeps, pairs and eigenvalues as the JAX package.

    A deflated sweep amplifies rounding: ``T`` grows like
    ``(gamma theta / |sigma - lam|)^k`` (max |T| ~ 1e19 at maxit 12 here),
    so the two packages' Hessenbergs part by ~30x a step from the last-bit
    differences of their BLAS.  With the probe's arguments the fourth pair
    converges at backward error ~1e-7 = tol in the JAX package's second
    sweep and in the port's fourth (``[3, 1, 0, ...]`` against
    ``[3, 0, 0, 1, ...]``): there the first sweep, the count and the
    eigenvalues are held (the marginal pair to its tolerance, rel 1e-6);
    the short scan's sweeps are held exactly."""
    args, tnep, (D, Q, info), (Dj, Qj, infoj) = deflated_runs
    sweeps, jsweeps = info["sweeps"], infoj["sweeps"]
    assert sweeps[0] == jsweeps[0] > 0
    assert sum(sweeps) == sum(jsweeps) == info["nconv"] == infoj["nconv"] >= 3
    assert len(sweeps) == len(jsweeps) and 0 in sweeps  # empty sweeps stay
    assert info["m_per_sweep"] == infoj["m_per_sweep"]
    assert info["theta"] == pytest.approx(infoj["theta"], rel=1e-12)
    assert len(info["max_abs_T"]) == len(sweeps)
    assert info["max_abs_T"][0] == 0.0 and max(info["max_abs_T"]) > 0
    gap = 1e-9 if args == SHORT else 1e-6
    if args == SHORT:
        assert sweeps == jsweeps
        assert sum(1 for s in sweeps[1:] if s) >= 2  # deflated sweeps converge
    assert conj_set_gap(D, np.asarray(Dj)) < gap
    assert conj_set_gap(np.asarray(Dj), D) < gap
    # never reconverged, and each pair solves the original problem to the
    # backward error the run was asked for
    mats, fv = tspmf_real.collect_spmf_terms(tnep)
    err = backward_errmeasure(mats, fv, tspmf_real.spmf_fun_scalars)
    for i in range(len(D)):
        for j in range(i + 1, len(D)):
            assert abs(D[i] - D[j]) > 1e-6
        assert err(complex(D[i]), Q[:, i]) < args[1]


def test_deflated_scan_keeps_the_bank_at_length_n(deflated_runs):
    """A deflated sweep hands the bank term-major operands of length n (the
    bank's own shape), while the basis has length n + p."""
    from torch_port_helpers import BankSpy

    _, tnep, _, _ = deflated_runs
    mats, fv = tspmf_real.collect_spmf_terms(tnep)
    n, m = tnep.n, 6
    X, S = _pair(n, 2)
    bank = BankSpy(make_mixed_bank(
        mats, dtype=np.float64, device=CPU))
    solver = tspmf_real.spmf_shift_block_lu(mats, fv, SIGMA,
                                            dtype=torch.float64, device=CPU)
    defl = tiar_real.DeflationOps.build(X, S, SIGMA, 1.0, m, torch.float64,
                                        device=CPU)
    Cre, Cim = tspmf_real.spmf_coeff_table(fv, SIGMA, 1.0, m, scaled=True)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n + 2) + 0j
    _, _, info = tiar_real.run_iar_real(
        bank, m, Cre, Cim, 0.0, v, solver, torch.float64, sigma=SIGMA,
        gamma=1.0, neigs=1, tol=np.inf, resnorm=lambda lam, q: 0.0,
        n=n + 2, scaled=True, defl=defl, device=CPU)
    assert info["k_done"] == m
    assert bank.seen == [((len(mats), n), True)] * (2 * m)


def test_deflated_waveguide_through_the_mixed_bank():
    """A small SPMF waveguide: its mixed bank (DIA main part plus low-rank
    boundary groups) carries the deflated scan's split apply, and the
    restarted run agrees with the JAX package's."""
    cfg = dict(nx=9, nz=7, benchmark_problem="JARLEBRING", neptype="SPMF")
    tnep = neptpu_torch.nep_gallery("waveguide", device=CPU, **cfg)
    jnep = neptpu.nep_gallery("waveguide", **cfg)
    kw = dict(sigma=-3 - 3.5j, maxit=30, neigs=3, tol=1e-8,
              check_error_every=10, return_info=True)
    D, Q, info = tspmf_real.iar_real_spmf_deflated(
        tnep, dtype=torch.float64, device=CPU, **kw)
    Dj, _, infoj = jspmf_real.iar_real_spmf_deflated(jnep, dtype=jnp.float64,
                                                     **kw)
    bank = make_mixed_bank(
        tspmf_real.collect_spmf_terms(tnep)[0], dtype=np.float64, device=CPU)
    assert type(bank).__name__ == "MixedTermBank"
    # one pair near this shift at n = 77; the deflated sweeps after it run
    # through the mixed bank and find nothing more
    assert info["sweeps"] == infoj["sweeps"] == [1, 0, 0, 0, 0]
    assert info["nconv"] == infoj["nconv"] == 1
    assert np.isfinite(info["max_abs_T"]).all()
    assert conj_set_gap(D, np.asarray(Dj)) < 1e-9


def test_iar_real_spmf_deflated_is_exported():
    assert neptpu_torch.iar_real_spmf_deflated is (
        tspmf_real.iar_real_spmf_deflated)
    assert neptpu_torch.DeflationOps is tiar_real.DeflationOps
