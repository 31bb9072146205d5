"""Port tests that need an NVIDIA GPU (marker ``cuda``; they skip without
one).  This file imports no JAX, so it runs on the card's machine, which has
none:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: the suite's conftest configures JAX).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from torch_port_helpers import (SMALL_GAMMA, SMALL_SIGMA, backward_errmeasure,
                                rel_err, small_gun_like)

from neptpu_torch.models.gallery.nlevp import _gun_from_matrices
from neptpu_torch.ops import dia_kernel
from neptpu_torch.ops.dia import DiaTermBank
from neptpu_torch.solvers.refine import newton_refine
from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                            iar_real_spmf, spmf_fun_scalars)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _mats(offs, n, m, seed=3):
    rng = np.random.default_rng(seed)
    return [sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                     shape=(n, n), format="csr") for _ in range(m)]


# tolerances: a few roundings of the data dtype per row, sums reordered
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("offs", [[-26, -25, -1, 0, 1, 25, 26],
                                  list(range(-12, 13))])
def test_kernel_matches_twin_and_cpu(cuda, dtype, rtol, offs):
    mats = _mats(offs, 700, 3)
    tb = DiaTermBank.from_matrices(mats, dtype=dtype, device=cuda)
    W = torch.from_numpy(np.random.default_rng(4).standard_normal((700, 3)))
    before = dia_kernel.DIA_SPMV.launches
    y = tb.lincomb_apply(W.to(device=cuda, dtype=dtype))
    torch.cuda.synchronize()
    assert dia_kernel.DIA_SPMV.launches == before + 1
    y_cpu = DiaTermBank.from_matrices(mats, dtype=dtype).lincomb_apply(
        W.to(dtype))
    assert rel_err(y.cpu().numpy(), y_cpu.numpy()) < rtol
    # a complex operand is two real launches
    yc = tb.lincomb_apply((W + 2j * W).to(cuda))
    assert dia_kernel.DIA_SPMV.launches == before + 3
    assert rel_err(yc.cpu().numpy(), (y_cpu + 2j * y_cpu).numpy()) < rtol


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bf16_and_strided(cuda):
    data = torch.zeros((2, 3, 10), dtype=torch.bfloat16, device=cuda)
    offs = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        dia_kernel.dia_lincomb(data, offs, torch.zeros((10, 2),
                                                       dtype=torch.bfloat16,
                                                       device=cuda))
    data = torch.zeros((2, 3, 10), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dia_kernel.dia_lincomb(data, offs, torch.zeros((2, 10), device=cuda).T)


@pytest.mark.cuda
def test_small_slice_on_the_card_matches_cpu(cuda):
    """float32 scan on the card vs. float64 on the CPU, both refined on the
    host: the same eigenvalues to rel 1e-9."""
    ops = small_gun_like()
    out = {}
    # the CPU reference returns every converged pair (neigs above the count)
    for dev, dt, neigs, tol, every in ((cuda, torch.float32, 6, 1e-5, 20),
                                       ("cpu", torch.float64, 16, 1e-10,
                                        None)):
        nep = _gun_from_matrices(*ops, device=dev)
        mats, fv = collect_spmf_terms(nep)
        meas = backward_errmeasure(mats, fv, spmf_fun_scalars)
        lams, Q = iar_real_spmf(nep, sigma=SMALL_SIGMA, gamma=SMALL_GAMMA,
                                maxit=40, neigs=neigs, tol=tol, dtype=dt,
                                errmeasure=meas, check_error_every=every,
                                device=dev)
        lams, Q, errs = newton_refine(mats, fv, lams, Q, nsweeps=3,
                                      tol=1e-11, errmeasure=meas,
                                      backend="host")
        assert len(lams) >= 6 and np.all(errs <= 1e-9)
        out[str(dt)] = lams
    a, b = out["torch.float32"], out["torch.float64"]
    assert all(np.min(np.abs(b - x)) / abs(x) < 1e-9 for x in a)
