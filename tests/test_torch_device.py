"""The port's device rule: an entry point called with ``device=None`` runs on
the card, and where there is none it raises — it never moves to the CPU on
its own.  (The parity tests pass ``device="cpu"`` at every call.)"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from torch_port_helpers import CPU, SMALL_SIGMA, small_gun_like

import neptpu_torch
from neptpu_torch import config
from neptpu_torch.models.gallery.nlevp import _gun_from_matrices
from neptpu_torch.ops.dia import DiaTermBank
from neptpu_torch.ops.mixed import make_mixed_bank
from neptpu_torch.ops.partitioned import (BatchedShiftSMW,
                                          build_spmf_shift_solver)
from neptpu_torch.ops.sparse import CSR, make_term_bank
from neptpu_torch.solvers.iar_real import dep_shift_block_lu
from neptpu_torch.solvers.refine import newton_refine
from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                            iar_real_spmf,
                                            iar_real_spmf_multishift,
                                            spmf_shift_block_lu)


@pytest.fixture(scope="module")
def gun():
    nep = _gun_from_matrices(*small_gun_like(nx=12), device=CPU)
    return (nep,) + tuple(collect_spmf_terms(nep))


def _calls(gun):
    nep, mats, fv = gun
    K, M, W1, W2 = small_gun_like(nx=12)
    q = np.ones((nep.n, 1), dtype=complex)
    return {
        "nep_gallery_gun_like": lambda d: neptpu_torch.nep_gallery(
            "gun_like", device=d),
        "nep_gallery_waveguide": lambda d: neptpu_torch.nep_gallery(
            "waveguide", nx=5, nz=3, neptype="SPMF", device=d),
        "nep_gallery_waveguide_native": lambda d: neptpu_torch.nep_gallery(
            "waveguide", nx=11, nz=7, neptype="WEP", device=d),
        "wep_fd_from_arrays": lambda d: _wep_from_parts(d),
        "iar_jitted": lambda d: neptpu_torch.iar_jitted(
            DEP_CPU(), sigma=-0.2, maxit=4, neigs=1, device=d),
        "tiar_jitted": lambda d: neptpu_torch.tiar_jitted(
            DEP_CPU(), sigma=-0.2, maxit=4, neigs=1, device=d),
        "tiar_jitted_spmf": lambda d: neptpu_torch.tiar_jitted_spmf(
            nep, sigma=SMALL_SIGMA, gamma=600.0, maxit=4, neigs=1, device=d),
        "CSR.from_scipy": lambda d: CSR.from_scipy(K, device=d),
        "PEP": lambda d: neptpu_torch.PEP([K, M], device=d),
        "SPMF_NEP": lambda d: neptpu_torch.SPMF_NEP(
            [W1, W2], list(nep.get_fv())[2:], device=d),
        "make_term_bank": lambda d: make_term_bank([K, M], device=d),
        "make_term_bank_dense": lambda d: make_term_bank(
            [K.toarray(), M.toarray()], device=d),
        "make_mixed_bank": lambda d: make_mixed_bank(mats, device=d),
        "DiaTermBank.from_matrices": lambda d: DiaTermBank.from_matrices(
            [K, M], device=d),
        "build_spmf_shift_solver": lambda d: build_spmf_shift_solver(
            mats, fv, SMALL_SIGMA, dtype=torch.float64, device=d),
        "spmf_shift_block_lu": lambda d: spmf_shift_block_lu(
            mats, fv, SMALL_SIGMA, dtype=torch.float64, device=d),
        "iar_real_spmf": lambda d: iar_real_spmf(
            nep, sigma=SMALL_SIGMA, gamma=600.0, maxit=4, neigs=1,
            dtype=torch.float64, device=d),
        "iar_real_spmf_multishift": lambda d: iar_real_spmf_multishift(
            nep, [SMALL_SIGMA], gamma=600.0, maxit=4, neigs=1,
            dtype=torch.float64, device=d),
        "BatchedShiftSMW": lambda d: BatchedShiftSMW(
            mats, fv, [SMALL_SIGMA], dtype=torch.float64, device=d),
        "newton_refine_chip": lambda d: newton_refine(
            mats, fv, [SMALL_SIGMA], q, nsweeps=1, backend="chip", device=d),
        "tiar_real_spmf": lambda d: neptpu_torch.tiar_real_spmf(
            nep, sigma=SMALL_SIGMA, gamma=600.0, maxit=4, neigs=1,
            dtype=torch.float64, device=d),
        "DEP": lambda d: neptpu_torch.DEP([K, M], [0.0, 1.0], device=d),
        **{f"nep_gallery_{g}": (lambda d, g=g: neptpu_torch.nep_gallery(
            g, device=d)) for g in GALLERY_NAMES},
        **{name: (lambda d, name=name: getattr(neptpu_torch, name)(
            DEP_CPU(), sigma=-0.2, maxit=4, neigs=1, device=d))
           for name in ("iar_real", "tiar_real")},
        **{name: (lambda d, name=name: _partial(getattr(neptpu_torch, name))(
            DEP_CPU(), sigma=-0.2, maxit=4, neigs=1, device=d))
           for name in ("iar", "tiar")},
        **{name: (lambda d, name=name: _partial(getattr(neptpu_torch, name))(
            DEP_CPU(), lam=-0.29, maxit=5, device=d)) for name in NEWTONS},
        "dep_shift_block_lu": lambda d: dep_shift_block_lu(
            DEP_CPU(), -0.2, dtype=torch.float64, device=d),
        "jd_betcke": lambda d: _partial(neptpu_torch.jd_betcke)(
            DEP_CPU(), neigs=1, maxit=3, device=d),
        "jd_effenberger": lambda d: _partial(neptpu_torch.jd_effenberger)(
            DEP_CPU(), maxit=3, device=d),
        "nlar": lambda d: _partial(neptpu_torch.nlar)(
            DEP_CPU(), neigs=1, maxit=3, device=d),
        "mslp": lambda d: _partial(neptpu_torch.mslp)(
            DEP_CPU(), maxit=2, device=d),
        "sgiter": lambda d: _partial(neptpu_torch.sgiter)(
            DEP_CPU(), 1, maxit=2, device=d),
        **{name: (lambda d, name=name: _partial(getattr(neptpu_torch, name))(
            DEP_CPU(), DEP_CPU(), lam=-0.29, maxit=2, device=d))
           for name in ("rfi", "rfi_b")},
        "LowRankFactorizedNEP": lambda d: neptpu_torch.LowRankFactorizedNEP(
            [np.ones((9, 1))], [np.ones((9, 1))],
            [neptpu_torch.matfun.eye_like], device=d),
        "iar_real_spmf_deflated": lambda d: neptpu_torch.iar_real_spmf_deflated(
            nep, sigma=SMALL_SIGMA, gamma=600.0, maxit=4, neigs=1,
            restarts=1, dtype=torch.float64, device=d),
        "DeflationOps.build": lambda d: neptpu_torch.DeflationOps.build(
            np.ones((4, 1)), 0.5 * np.eye(1), 1.0, 1.0, 2, torch.float64,
            device=d),
        "iar_chebyshev": lambda d: _partial(neptpu_torch.iar_chebyshev)(
            DEP_CPU(), maxit=4, neigs=1, device=d),
        "ilan": lambda d: _partial(neptpu_torch.ilan)(
            DEP_CPU(), maxit=3, neigs=1, device=d),
        "infbilanczos": lambda d: _partial(neptpu_torch.infbilanczos)(
            DEP_CPU(), DEP_CPU(), maxit=3, neigs=1, device=d),
        "blocknewton": lambda d: _partial(neptpu_torch.blocknewton)(
            DEP_CPU(), maxit=1, device=d),
        "broyden": lambda d: neptpu_torch.broyden(
            neptpu_torch.nep_gallery("dep0", device=CPU), pmax=1, maxit=5,
            device=d),
        "REP": lambda d: neptpu_torch.REP([np.eye(3), np.eye(3)], [1.0],
                                          [2.0], device=d),
        "interpolate_pep": lambda d: neptpu_torch.interpolate_pep(
            neptpu_torch.Mder_NEP(3, lambda lam, der: np.eye(3) * lam),
            [0.0, 1.0], device=d),
        "nleigs": lambda d: neptpu_torch.nleigs(
            PEP_CPU(), maxit=4, minit=2, maxdgr=5, v=np.ones(2), device=d),
        "AAAeigs": lambda d: _partial(neptpu_torch.AAAeigs)(
            PEP_CPU(), np.exp(2j * np.pi * np.arange(20) / 20), neigs=1,
            maxit=2, device=d),
        "contour_beyn": lambda d: neptpu_torch.contour_beyn(
            PEP_CPU(), N=8, k=1, sanity_check=False, device=d),
        "contour_block_SS": lambda d: neptpu_torch.contour_block_SS(
            PEP_CPU(), N=8, k=1, K=1, device=d),
        "build_pencil": lambda d: neptpu_torch.build_pencil(
            neptpu_torch.CORKPencil.from_nep(
                PEP_CPU(), neptpu_torch.IarCorkLinearization(d=3)),
            device=d),
    }


GALLERY_NAMES = ["dep0", "dep0_sparse", "dep0_tridiag", "pep0", "pep0_sym",
                 "pep0_sparse", "qep_fixed_eig", "dep1", "dep_symm_double",
                 "dep_double", "dep_distributed",
                 "nlevp_native_loaded_string", "real_quadratic", "qdep0",
                 "qdep1", "neuron0", "beam", "sine", "schrodinger_movebc",
                 "nlevp_native_cd_player", "nlevp_native_fiber",
                 "nlevp_native_hadeler", "nlevp_native_pdde_stability",
                 "periodicdde", "bem_fichera", "orr_sommerfeld"]
NEWTONS = ["newton", "augnewton", "resinv", "quasinewton", "newtonqr",
           "implicitdet"]


def _wep_from_parts(device):
    """A native waveguide carried over from the parts of a CPU one."""
    from neptpu_torch.interop import wep_fd_from_arrays

    w = neptpu_torch.nep_gallery("waveguide", nx=11, nz=7, neptype="WEP",
                                 device=CPU)
    return wep_fd_from_arrays(dict(
        nx=w.nx, nz=w.nz, hx=w.hx, hz=w.hz, Dxx=w.Dxx.numpy(),
        Dzz=w.Dzz.numpy(), Dz=w.Dz.numpy(), C1=w.C1, C2T=w.C2T,
        K=w.K.numpy(), k_bar=w.k_bar, Km=1.0, Kp=2.0), device=device)


def DEP_CPU():
    """A small delay problem that lives on the CPU."""
    return neptpu_torch.nep_gallery("dep0_tridiag", 40, device=CPU)


def PEP_CPU():
    """A small quadratic problem that lives on the CPU."""
    return neptpu_torch.PEP([np.array([[1.0, 3], [5, 6]]),
                             np.array([[3.0, 4], [6, 6]]), np.eye(2)],
                            device=CPU)


def _partial(solver):
    """A protocol solver whose early stop (too few steps to converge) counts
    as having run."""
    def run(*args, **kw):
        try:
            return solver(*args, **kw)
        except neptpu_torch.NoConvergenceException:
            return None
    return run


ENTRY_POINTS = ["nep_gallery_gun_like", "nep_gallery_waveguide", "PEP",
                "SPMF_NEP", "make_term_bank", "make_term_bank_dense",
                "make_mixed_bank", "DiaTermBank.from_matrices",
                "build_spmf_shift_solver", "spmf_shift_block_lu",
                "iar_real_spmf", "iar_real_spmf_multishift",
                "BatchedShiftSMW", "newton_refine_chip", "tiar_real_spmf",
                "DEP", "iar_real", "tiar_real", "iar", "tiar",
                "dep_shift_block_lu", "jd_betcke", "jd_effenberger",
                "nlar", "mslp", "sgiter", "rfi", "rfi_b",
                "LowRankFactorizedNEP", "iar_real_spmf_deflated",
                "DeflationOps.build", "iar_chebyshev", "ilan",
                "infbilanczos", "blocknewton", "broyden", "REP",
                "interpolate_pep", "nleigs", "AAAeigs", "contour_beyn",
                "contour_block_SS", "build_pencil",
                "nep_gallery_waveguide_native", "wep_fd_from_arrays",
                "iar_jitted", "tiar_jitted", "tiar_jitted_spmf",
                "CSR.from_scipy"] + NEWTONS + [
                    f"nep_gallery_{g}" for g in GALLERY_NAMES]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_device_none_raises_without_a_card(gun, name):
    call = _calls(gun)[name]
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(None)
    call(CPU)  # and the same call runs when the CPU is asked for


def test_solver_refuses_a_problem_on_another_device():
    """A protocol solver runs where its problem lives: asked for another
    device it raises instead of moving anything."""
    from neptpu_torch.solvers.common import nep_device, solver_device

    nep = DEP_CPU()
    assert nep_device(nep) == torch.device("cpu")
    assert solver_device(nep, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="operands are on cpu"):
        solver_device(nep, "meta")
    with pytest.raises(ValueError, match="operands are on cpu"):
        neptpu_torch.resinv(nep, lam=-0.29, device="meta")


def test_resolve_device_prefers_the_callers_objects(gun):
    nep, mats, fv = gun
    assert config.resolve_device("cpu") == torch.device("cpu")
    assert config.resolve_device(None, like=nep.nep1.bank) == torch.device(
        "cpu")
    assert config.resolve_device("meta", like=nep.nep1.bank).type == "meta"
    # a scan handed a CPU bank stays there without being told
    bank = make_mixed_bank(mats, dtype=np.float64, device=CPU)
    lams, Q = iar_real_spmf(nep, sigma=SMALL_SIGMA, gamma=600.0, maxit=4,
                            neigs=1, dtype=torch.float64, bank=bank)
    assert Q.shape[0] == nep.n
    # problems built from a problem live where it does: a Chebyshev
    # interpolant, a deflated and a projected problem of a CPU delay problem
    dep = DEP_CPU()
    assert neptpu_torch.ChebPEP(dep, 5).bank.device.type == "cpu"
    dnep = neptpu_torch.deflate_eigpair(dep, -0.3, torch.ones(dep.n))
    assert dnep.V0_t.device.type == "cpu"
    assert dnep.spmf.nep1.bank.device.type == "cpu"
    # and so do its transformations
    assert neptpu_torch.shift_and_scale(dep, shift=0.1).bank.device.type == (
        "cpu")
    assert neptpu_torch.taylor_expansion_pep(dep, 2).bank.device.type == "cpu"
    assert neptpu_torch.interpolate_pep(dep, [0.0, 1.0]).bank.device.type == (
        "cpu")
    pnep = neptpu_torch.create_proj_NEP(dnep, 3)
    pnep.set_projectmatrices(torch.eye(dnep.n, 2), torch.eye(dnep.n, 2))
    assert pnep.W.device.type == "cpu" and pnep.bank.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            config.default_device()
