"""Port parity of the static-shape scan steps: the counterparts of the JAX
package's compiled scans (``_step_fn`` of ``iar_real``, ``_tiar_step_fn`` of
``tiar_real``, the ``tiar_jit`` step and the ``iar_jit`` scan), on the CPU in
float64 / complex128, and the pieces that let one step be captured as a CUDA
graph on the card (the step index as a tensor, the step runner).

Tolerances: a port step started from the JAX step's carry is the same
float64 / complex128 arithmetic in another order - basis and Hessenberg
within rel 1e-12 after every step.  The ``iar_jit`` scan is one jitted
program in the JAX package, so its port runs on alone and after step j is
held against the JAX scan's columns 0..j (later steps write no earlier
column), at rel 1e-12 over the 8 steps."""
import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from torch_port_helpers import (CPU, NoHostFunctions, NoScalarReads,
                                gallery_pair, small_gun_ops)

import neptpu
import neptpu_torch
from neptpu.models.gallery.nlevp import _i_sqrt_shifted as j_i_sqrt
from neptpu.ops.mixed import make_mixed_bank as j_make_mixed_bank
from neptpu_torch.interop import block_lu_from_arrays
from neptpu_torch.models.gallery.nlevp import _i_sqrt_shifted as t_i_sqrt
from neptpu_torch.ops.mixed import make_mixed_bank
from neptpu_torch.solvers import iar_jit as tiar_jit
from neptpu_torch.solvers import iar_real as tiar
from neptpu_torch.solvers import spmf_real as tspmf
from neptpu_torch.solvers import tiar_jit as ttiar_jit
from neptpu_torch.solvers import tiar_real as ttiar
from neptpu_torch.solvers.scan_graph import StepGraph, _eager_loop

# the modules themselves (``neptpu.solvers`` re-exports same-named functions)
jiar = importlib.import_module("neptpu.solvers.iar_real")
jtiar = importlib.import_module("neptpu.solvers.tiar_real")
jtiar_jit = importlib.import_module("neptpu.solvers.tiar_jit")
jiar_jit = importlib.import_module("neptpu.solvers.iar_jit")
jspmf = importlib.import_module("neptpu.solvers.spmf_real")

M = 8                      # basis size of every scan here
DEP_SHIFT, GAMMA = -1.0 + 0.3j, 1.0
GUN_SHIFT = 30 + 1j        # the small gun fixture's shift
TOL = 1e-12


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) <= tol * max(np.linalg.norm(b), 1e-300)


@pytest.fixture(scope="module")
def dep():
    """``dep_symm_double`` on an 8 x 8 grid (n = 64), both packages, with
    the JAX package's block LU of M(sigma) and its coefficient tables."""
    tnep, jnep = gallery_pair("dep_symm_double", 8)
    jlu, jpiv = jiar.dep_shift_block_lu(jnep, DEP_SHIFT, dtype=jnp.float64)
    return tnep, jnep, jlu, jpiv


def _iar_dep(dep, scaled):
    """(JAX step, port step, start carry) of the DEP complex-as-real IAR."""
    tnep, jnep, jlu, jpiv = dep
    Cre, Cim = jiar.dep_coeff_table(jnep, DEP_SHIFT, GAMMA, M, scaled=scaled)
    theta = 1.0
    if scaled:
        theta = jiar.auto_theta(Cre, Cim, M, jnp.float64)
        Cre, Cim = jiar.apply_theta(Cre, Cim, theta)
    gre = GAMMA * theta
    kw = dict(scaled=scaled, inv_theta=1.0 / theta)
    jstep = jiar._step_fn(jnep.bank, M, jnp.asarray(Cre), jnp.asarray(Cim),
                          gre, 0.0, jiar.DenseBlockLU(jlu, jpiv), jnp.float64,
                          **kw)
    tstep = tiar._step_fn(tnep.bank, M, torch.from_numpy(Cre),
                          torch.from_numpy(Cim), gre, 0.0,
                          block_lu_from_arrays(np.asarray(jlu),
                                               np.asarray(jpiv), device=CPU),
                          torch.float64, **kw)
    v = np.random.default_rng(1).standard_normal((2, tnep.n))
    carry = [np.asarray(x) for x in jiar._init_carry(
        M, jnp.asarray(v[0]), jnp.asarray(v[1]), jnp.float64)]
    return jstep, tstep, carry


@pytest.fixture(scope="module")
def gun():
    """The small gun-structured SPMF of the deflation tests (n = 60) in
    both packages: operands, banks and the dense block LU at its shift."""
    K, mM, W1, W2 = small_gun_ops(60)
    jnep = neptpu.SumNEP(neptpu.PEP([K, mM]),
                         neptpu.SPMF_NEP([W1, W2], [j_i_sqrt(0.0),
                                                    j_i_sqrt(9.0)]))
    tnep = neptpu_torch.SumNEP(
        neptpu_torch.PEP([K, mM], device=CPU),
        neptpu_torch.SPMF_NEP([W1, W2], [t_i_sqrt(0.0), t_i_sqrt(9.0)],
                              device=CPU))
    mats, fv = tspmf.collect_spmf_terms(tnep)
    jmats, jfv = jspmf.collect_spmf_terms(jnep)
    jlu, jpiv = jspmf.spmf_shift_block_lu(jmats, jfv, GUN_SHIFT,
                                          dtype=jnp.float64)
    return (mats, fv, make_mixed_bank(mats, dtype=np.float64, device=CPU),
            j_make_mixed_bank(jmats, dtype=np.float64), jlu, jpiv)


def _iar_deflated(gun):
    """(JAX step, port step, start carry) of the deflated theta-scaled scan
    (basis n + p, bank and solve at n)."""
    mats, fv, tbank, jbank, jlu, jpiv = gun
    n, p = mats[0].shape[0], 2
    Cre, Cim = tspmf.spmf_coeff_table(fv, GUN_SHIFT, GAMMA, M, scaled=True)
    theta = 1.3
    Cre, Cim = tiar.apply_theta(Cre, Cim, theta)
    f0 = tspmf.spmf_fun_scalars(fv, GUN_SHIFT)
    Cre[:, 0], Cim[:, 0] = f0.real, f0.imag
    rng = np.random.default_rng(3)
    X, _ = np.linalg.qr(rng.standard_normal((n, p))
                        + 1j * rng.standard_normal((n, p)))
    S = np.diag(GUN_SHIFT + np.array([0.4 + 0.1j, -0.7 + 0.3j]))
    S[0, 1] = 0.2 - 0.1j
    tdefl = tiar.DeflationOps.build(X, S, GUN_SHIFT, GAMMA * theta, M,
                                    torch.float64, device=CPU)
    jdefl = jiar.DeflationOps.build(X, S, GUN_SHIFT, GAMMA * theta, M,
                                    jnp.float64)
    kw = dict(scaled=True, inv_theta=1.0 / theta)
    jstep = jiar._step_fn(jbank, M, jnp.asarray(Cre), jnp.asarray(Cim), 0.0,
                          0.0, jiar.DenseBlockLU(jlu, jpiv), jnp.float64,
                          defl=jdefl, **kw)
    tstep = tiar._step_fn(tbank, M, torch.from_numpy(Cre),
                          torch.from_numpy(Cim), 0.0, 0.0,
                          block_lu_from_arrays(np.asarray(jlu),
                                               np.asarray(jpiv), device=CPU),
                          torch.float64, defl=tdefl, **kw)
    v = rng.standard_normal((2, n + p))
    carry = [np.asarray(x) for x in jiar._init_carry(
        M, jnp.asarray(v[0]), jnp.asarray(v[1]), jnp.float64)]
    return jstep, tstep, carry


def _tiar_dep(dep):
    """(JAX step, port step, start carry) of the complex-as-real TIAR."""
    tnep, jnep, jlu, jpiv = dep
    Cre, Cim = jiar.dep_coeff_table(jnep, DEP_SHIFT, GAMMA, M)
    jstep = jtiar._tiar_step_fn(jnep.bank, M, jnp.asarray(Cre),
                                jnp.asarray(Cim), GAMMA, 0.0, jlu, jpiv,
                                jnp.float64)
    tstep = ttiar._tiar_step_fn(
        tnep.bank, M, torch.from_numpy(Cre), torch.from_numpy(Cim), GAMMA,
        0.0, block_lu_from_arrays(np.asarray(jlu), np.asarray(jpiv),
                                  device=CPU), torch.float64)
    v = np.random.default_rng(2).standard_normal((2, tnep.n))
    carry = [np.asarray(x) for x in jtiar._tiar_init(
        M, jnp.asarray(v[0]), jnp.asarray(v[1]), jnp.float64)]
    return jstep, tstep, carry


def _complex_lu(jnep):
    """The JAX package's dense complex LU of the DEP's M(sigma), and the
    same factors with torch's 1-based pivots."""
    lu, piv = jsl.lu_factor(jnp.asarray(np.asarray(jnep.Mder_dense(
        DEP_SHIFT)), dtype=jnp.complex128))
    return (lu, piv, torch.from_numpy(np.array(lu)),
            torch.from_numpy(np.asarray(piv).astype(np.int32) + 1))


def _tiar_complex(dep):
    """(JAX step, port step, start carry) of the complex TIAR."""
    tnep, jnep, _, _ = dep
    Cre, Cim = jiar.dep_coeff_table(jnep, DEP_SHIFT, GAMMA, M)
    C = Cre + 1j * Cim
    jlu, jpiv, tlu, tpiv = _complex_lu(jnep)
    jstep = jtiar_jit._step_fn(jnep.bank, M, jnp.asarray(C),
                               jnp.asarray(complex(GAMMA)), jlu, jpiv,
                               jnp.complex128)
    tstep = ttiar_jit._step_fn(tnep.bank, M, torch.from_numpy(C),
                               complex(GAMMA), tlu, tpiv, torch.complex128)
    v = np.random.default_rng(4).standard_normal(tnep.n) + 0.5j
    carry = [np.asarray(x) for x in jtiar_jit._init(
        M, jnp.asarray(v), jnp.complex128)]
    return jstep, tstep, carry


def _steps_match(jstep, tstep, carry):
    """Each port step from the JAX carry before that step; every carry
    array within rel ``TOL`` of the JAX step's after it."""
    jstep = jax.jit(jstep)
    jc = tuple(jnp.asarray(x) for x in carry)
    for k in range(1, M + 1):
        tc = tuple(torch.from_numpy(np.array(x)) for x in jc)
        tbeta = tstep(tc, torch.tensor(k))
        jc, jbeta = jstep(jc, jnp.asarray(k))
        assert _close(tbeta.numpy(), np.asarray(jbeta)), k
        for i, (a, b) in enumerate(zip(tc, jc)):
            assert _close(a.numpy(), np.asarray(b)), (k, i)


@pytest.mark.parametrize("scaled", [False, True])
def test_iar_real_step_matches_jax_step_fn(dep, scaled):
    _steps_match(*_iar_dep(dep, scaled))


def test_deflated_iar_real_steps_match_jax_step_fn(gun):
    _steps_match(*_iar_deflated(gun))


def test_tiar_real_step_matches_jax_tiar_step_fn(dep):
    _steps_match(*_tiar_dep(dep))


def test_complex_tiar_step_matches_jax_step_fn(dep):
    _steps_match(*_tiar_complex(dep))


def _iar_jit_parts(dep):
    """The port's padded-IAR step and start carry, and the JAX package's
    whole scan ``(V, H)`` over the same factors."""
    tnep, jnep, _, _ = dep
    jlu, jpiv, tlu, tpiv = _complex_lu(jnep)
    v0 = np.random.default_rng(5).standard_normal(tnep.n) + 0j
    jV, jH = jiar_jit.iar_scan_kernel(
        jnep, M, jnp.asarray(DEP_SHIFT), jnp.asarray(complex(GAMMA)),
        jnp.asarray(v0), (jlu, jpiv))
    alpha = np.array([GAMMA**j for j in range(M + 1)], dtype=complex)
    cdt = torch.complex128
    step = tiar_jit._step_fn(
        M, tiar_jit._shift_lincomb(tnep, DEP_SHIFT, alpha,
                                   torch.device(CPU)),
        tlu, tpiv, cdt, torch.device(CPU))
    V = torch.zeros((M + 1, M + 1, tnep.n), dtype=cdt)
    V[0, 0] = torch.from_numpy(v0 / np.linalg.norm(v0))
    H = torch.zeros((M + 1, M), dtype=cdt)
    return step, (V, H), np.asarray(jV), np.asarray(jH)


def test_iar_jit_steps_match_the_jax_scan(dep):
    step, (V, H), jV, jH = _iar_jit_parts(dep)
    for k in range(1, M + 1):
        step((V, H), torch.tensor(k))
        assert _close(V[:k + 1].numpy(), jV[:k + 1]), k
        assert _close(H[:, :k].numpy(), jH[:, :k]), k
        assert not V[k + 1:].any() and not H[:, k:].any()


def _small_gun_nep():
    K, mM, W1, W2 = small_gun_ops(60)
    return neptpu_torch.SumNEP(
        neptpu_torch.PEP([K, mM], device=CPU),
        neptpu_torch.SPMF_NEP([W1, W2], [t_i_sqrt(0.0), t_i_sqrt(9.0)],
                              device=CPU))


# a DEP's table is the host table of its own Mlincomb (bit for bit); a PEP
# plus SPMF sum's SPMF table is made over all the coefficients and then
# masked, where its Mlincomb substitutes the masked ones before the
# matrix-function trick (rel 1e-12), and so is a deflated DEP's (its
# Mlincomb only calls its inner SPMF sum's); a problem with no table form
# goes through its own Mlincomb (bit for bit)
@pytest.mark.parametrize("kind,tol", [("dep", 0.0), ("pep+spmf", 1e-12),
                                      ("deflated", 1e-12), ("mder", 0.0)])
def test_iar_jit_shift_lincomb_equals_the_problems_mlincomb(dep, kind, tol):
    """The padded IAR step's Mlincomb at its fixed shift, with the step's
    masks (orders 1..k live), against the problem's ``Mlincomb`` with the
    masked coefficients."""
    if kind == "pep+spmf":
        nep, sigma = _small_gun_nep(), GUN_SHIFT
    else:
        nep, sigma = dep[0], DEP_SHIFT
        if kind == "mder":
            nep = neptpu_torch.Mder_NEP(
                nep.n, lambda lam, der, d=nep: d.Mder_dense(lam, der))
        if kind == "deflated":
            v = np.random.default_rng(5).standard_normal(nep.n)
            nep = neptpu_torch.deflate_eigpair(nep, -0.3, torch.from_numpy(v))
            assert tiar_jit._delegate(nep) is nep.spmf
    alpha = np.array([0.7**j for j in range(M + 1)], dtype=complex)
    apply = tiar_jit._shift_lincomb(nep, sigma, alpha, torch.device(CPU))
    rng = np.random.default_rng(6)
    Y = torch.from_numpy(rng.standard_normal((nep.n, M + 1))
                         + 1j * rng.standard_normal((nep.n, M + 1)))
    jblk = torch.arange(M + 1)
    for k in (1, 4, M):
        live = (jblk >= 1) & (jblk <= k)
        ref = neptpu_torch.compute_Mlincomb(
            nep, sigma, Y, torch.from_numpy(np.where(live.numpy(), alpha,
                                                     0.0)))
        assert _close(apply(Y, live).numpy(), ref.numpy(), max(tol, 0.0)), k


@pytest.fixture(scope="module")
def mesh1():
    """A world of one gloo rank in this process and its CPU mesh (the
    sharded steps' collectives return at once at one rank)."""
    import torch.distributed as dist

    from neptpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    mesh = make_mesh(rows=1, device=CPU)
    yield mesh
    dist.destroy_process_group()


def _sharded_step(kind, mesh):
    """The sharded DEP step (``dep0_tridiag``, n = 512, the DIA bank a
    sharded bank needs) or the sharded mixed step (the small gun), with its
    start carry."""
    from neptpu_torch.parallel.mixed_sharded import mixed_scan_inputs
    from neptpu_torch.solvers.iar_sharded import (dep_scan_inputs,
                                                  sharded_carry,
                                                  sharded_step_fn)

    m = M
    if kind == "iar_sharded":
        nep = neptpu_torch.nep_gallery("dep0_tridiag", 512, device=CPU)
        inputs, _ = dep_scan_inputs(nep, mesh, DEP_SHIFT, GAMMA, m, None,
                                    torch.float64, "rows")
    else:
        K, mM, W1, W2 = small_gun_ops()
        nep = neptpu_torch.SumNEP(
            neptpu_torch.PEP([K, mM], device=CPU),
            neptpu_torch.SPMF_NEP([W1, W2], [t_i_sqrt(0.0), t_i_sqrt(9.0)],
                                  device=CPU))
        mats, fv = tspmf.collect_spmf_terms(nep)
        inputs, setup = mixed_scan_inputs(mats, fv, mesh, GUN_SHIFT, GAMMA,
                                          m, None, torch.float64, "rows")
        m = setup["steps"]
    return (sharded_step_fn(m, *inputs[:7], mesh, "rows"),
            sharded_carry(m, *inputs[7:], mesh, "rows"))


def _port_step(kind, dep, gun, request):
    if kind in ("iar_sharded", "iar_spmf_sharded"):
        return _sharded_step(kind, request.getfixturevalue("mesh1"))
    if kind == "iar_jit":
        step, carry, _, _ = _iar_jit_parts(dep)
        return step, carry
    _, tstep, carry = {
        "iar_real": lambda: _iar_dep(dep, False),
        "iar_real_scaled": lambda: _iar_dep(dep, True),
        "iar_real_deflated": lambda: _iar_deflated(gun),
        "tiar_real": lambda: _tiar_dep(dep),
        "tiar_jit": lambda: _tiar_complex(dep)}[kind]()
    return tstep, tuple(torch.from_numpy(np.array(x)) for x in carry)


@pytest.mark.parametrize("kind", ["iar_real", "iar_real_scaled",
                                  "iar_real_deflated", "tiar_real",
                                  "tiar_jit", "iar_jit", "iar_sharded",
                                  "iar_spmf_sharded"])
def test_scan_steps_never_read_the_step_index_on_the_host(dep, gun, kind,
                                                          request):
    """Each step, called with ``k`` a tensor, neither turns ``k`` (or any
    tensor) into a Python number nor uploads host data: on the card it can
    be captured once and replayed for every ``k``.  The sharded steps run on
    a one-rank mesh, their collectives included."""
    step, carry = _port_step(kind, dep, gun, request)
    k = torch.ones((), dtype=torch.int64)
    for _ in range(3):
        with NoHostFunctions(), NoScalarReads():
            step(carry, k)
            k.add_(1)
    assert int(k) == 4 and bool(carry[-1][:, 2].any())


def test_step_graph_on_the_cpu_is_the_eager_loop(dep):
    """On the CPU the runner calls the step once a step and advances the
    index after it; the scan's info says so, inside the eager comparator's
    block too."""
    _, tstep, carry = _iar_dep(dep, False)
    ref = tuple(torch.from_numpy(np.array(x)) for x in carry)
    for k in range(1, 6):
        tstep(ref, torch.tensor(k))
    out = tuple(torch.from_numpy(np.array(x)) for x in carry)
    k = torch.ones((), dtype=torch.int64)
    with StepGraph(tstep, out, k) as run:
        run.advance(2)
        run.advance(3)
    assert int(k) == 6 and run.stats() == {
        "graphed": False, "eager_steps": 5, "replays": 0, "capture_s": 0.0}
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    tnep = dep[0]
    kw = dict(sigma=DEP_SHIFT, maxit=M, neigs=2, dtype=torch.float64,
              check_error_every=4, return_info=True, device=CPU)
    info = neptpu_torch.iar_real(tnep, **kw)[2]
    with _eager_loop():
        info2 = neptpu_torch.iar_real(tnep, **kw)[2]
    assert info["graph"] == info2["graph"]
    assert info["graph"]["eager_steps"] == info["k_done"]
    np.testing.assert_array_equal(info["hessenberg"], info2["hessenberg"])


def test_term_matrices_equal_the_jax_package(gun):
    """``term_matrices``: the host CSR mirrors of every term of a bank, as
    the JAX package's."""
    mats, _, tbank, jbank, _, _ = gun
    for a, b, A in zip(tspmf.term_matrices(tbank),
                       jspmf.term_matrices(jbank), mats):
        assert abs(sp.csr_matrix(a) - sp.csr_matrix(b)).max() == 0
        assert abs(sp.csr_matrix(a) - A).max() <= 1e-14 * abs(A).max()
