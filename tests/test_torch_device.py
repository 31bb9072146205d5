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
from neptpu_torch.ops.sparse import make_term_bank
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
    }


ENTRY_POINTS = ["nep_gallery_gun_like", "nep_gallery_waveguide", "PEP",
                "SPMF_NEP", "make_term_bank", "make_term_bank_dense",
                "make_mixed_bank", "DiaTermBank.from_matrices",
                "build_spmf_shift_solver", "spmf_shift_block_lu",
                "iar_real_spmf", "iar_real_spmf_multishift",
                "BatchedShiftSMW", "newton_refine_chip"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_device_none_raises_without_a_card(gun, name):
    call = _calls(gun)[name]
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(None)
    call(CPU)  # and the same call runs when the CPU is asked for


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
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            config.default_device()
