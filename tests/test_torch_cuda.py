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

from torch_port_helpers import (CPU, SMALL_GAMMA, SMALL_SIGMA, backward_errmeasure,
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
    y_cpu = DiaTermBank.from_matrices(mats, dtype=dtype,
                                      device=CPU).lincomb_apply(
        W.to(dtype))
    assert rel_err(y.cpu().numpy(), y_cpu.numpy()) < rtol
    # a complex operand is one launch of the re/im pair kernel
    yc = tb.lincomb_apply((W + 2j * W).to(cuda))
    assert dia_kernel.DIA_SPMV.launches == before + 2
    assert dia_kernel.DIA_SPMV.counts["dia_lincomb_pair"] >= 1
    assert rel_err(yc.cpu().numpy(), (y_cpu + 2j * y_cpu).numpy()) < rtol


# the pair kernel sums each output in the single kernel's order: equal to two
# single launches bit for bit, and within a few roundings of the twin
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_pair_kernel_matches_twin_and_two_singles(cuda, dtype, rtol):
    mats = _mats([-26, -25, -1, 0, 1, 25, 26], 700, 3)
    tb = DiaTermBank.from_matrices(mats, dtype=dtype, device=cuda)
    rng = np.random.default_rng(5)
    Wre = torch.from_numpy(rng.standard_normal((700, 3))).to(cuda, dtype)
    Wim = torch.from_numpy(rng.standard_normal((700, 3))).to(cuda, dtype)
    before = dict(dia_kernel.DIA_SPMV.counts)
    yre, yim = tb.lincomb_apply_pair(Wre, Wim)
    torch.cuda.synchronize()
    assert dia_kernel.DIA_SPMV.counts["dia_lincomb_pair"] == (
        before["dia_lincomb_pair"] + 1)
    assert dia_kernel.DIA_SPMV.counts["dia_lincomb"] == before["dia_lincomb"]
    assert torch.equal(yre, tb.lincomb_apply(Wre))
    assert torch.equal(yim, tb.lincomb_apply(Wim))
    WreT, WimT = Wre.T.contiguous(), Wim.T.contiguous()
    pre, pim = dia_kernel.dia_lincomb_pair_plain(tb.data, tb.offsets, WreT,
                                                 WimT)
    assert rel_err(yre.cpu().numpy(), pre.cpu().numpy()) < rtol
    assert rel_err(yim.cpu().numpy(), pim.cpu().numpy()) < rtol
    # the term-major entries are the same launch
    tre, tim = tb.lincomb_apply_pair_t(WreT, WimT)
    assert torch.equal(tre, yre) and torch.equal(tim, yim)
    with pytest.raises(TypeError):
        dia_kernel.dia_lincomb_pair(tb.data, tb.offsets, WreT,
                                    WimT.to(torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        dia_kernel.dia_lincomb_pair(tb.data, tb.offsets, WreT, Wim.T)
    with pytest.raises(ValueError, match="term-major"):
        dia_kernel.dia_lincomb_pair(tb.data, tb.offsets, WreT, Wim)


@pytest.mark.cuda
def test_chip_refine_backend_on_the_card_matches_host(cuda):
    """``newton_refine(backend="chip")`` on the card (float32 factors +
    float64 refinement) against the host backend: the same eigenvalues to rel
    1e-9, backward errors at the float64 floor."""
    import neptpu_torch

    nep = neptpu_torch.nep_gallery("waveguide", nx=29, nz=21,
                                   benchmark_problem="JARLEBRING",
                                   neptype="SPMF", device=cuda)
    mats, fv = collect_spmf_terms(nep)
    meas = backward_errmeasure(mats, fv, spmf_fun_scalars)
    lams, Q = iar_real_spmf(nep, sigma=-3 - 3.5j, maxit=18, neigs=4,
                            tol=1e-2, dtype=torch.float32, errmeasure=meas,
                            device=cuda)
    out = {b: newton_refine(mats, fv, lams, Q, nsweeps=4, tol=1e-11, ir=3,
                            errmeasure=meas, backend=b, device=cuda)
           for b in ("chip", "host")}
    assert np.all(out["chip"][2] < 1e-10) and np.all(out["host"][2] < 1e-10)
    assert np.max(np.abs(out["chip"][0] - out["host"][0])
                  / np.abs(out["host"][0])) < 1e-9


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bf16_and_strided(cuda):
    """bfloat16 is taken when data and operands share it (mixed dtypes and
    float16 are refused); a strided operand is refused in every dtype."""
    data = torch.zeros((2, 3, 10), dtype=torch.bfloat16, device=cuda)
    offs = (-1, 0, 1)
    y = dia_kernel.dia_lincomb(data, offs, torch.zeros(
        (2, 10), dtype=torch.bfloat16, device=cuda))
    assert y.dtype == torch.float32 and y.shape == (10,)
    with pytest.raises(TypeError):
        dia_kernel.dia_lincomb(data, offs, torch.zeros((2, 10), device=cuda))
    with pytest.raises(TypeError):
        dia_kernel.dia_lincomb(data.to(torch.float16), offs, torch.zeros(
            (2, 10), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        dia_kernel.dia_lincomb(data, offs, torch.zeros(
            (10, 2), dtype=torch.bfloat16, device=cuda).T)
    data = torch.zeros((2, 3, 10), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dia_kernel.dia_lincomb(data, offs, torch.zeros((10, 2), device=cuda).T)
    with pytest.raises(ValueError, match="CUDA"):
        dia_kernel.dia_lincomb(data, offs, torch.zeros((2, 10)))


# the delay problem's bank shape (dep_symm_double: 2 terms, nine offsets)
DEP_OFFS = [-101, -100, -99, -1, 0, 1, 99, 100, 101]


# bf16 bank and operands, float32 sums and result: kernel and twin both sum
# exact float32 products, in another order (a few float32 roundings per row)
@pytest.mark.cuda
@pytest.mark.parametrize("offs,n,m", [([-26, -25, -1, 0, 1, 25, 26], 700, 3),
                                      (DEP_OFFS, 10_000, 2),
                                      (list(range(-12, 13)), 700, 3)])
def test_bf16_kernels_match_their_twins(cuda, offs, n, m):
    tb = DiaTermBank.from_matrices(_mats(offs, n, m), dtype=np.float32,
                                   device=cuda).astype(torch.bfloat16)
    rng = np.random.default_rng(6)
    Wre = torch.from_numpy(rng.standard_normal((n, m))).to(cuda,
                                                           torch.bfloat16)
    Wim = torch.from_numpy(rng.standard_normal((n, m))).to(cuda,
                                                           torch.bfloat16)
    before = dict(dia_kernel.DIA_SPMV.entry_counts)
    y = tb.lincomb_apply(Wre)
    yre, yim = tb.lincomb_apply_pair(Wre, Wim)
    torch.cuda.synchronize()
    after = dia_kernel.DIA_SPMV.entry_counts
    # a bf16 CUDA operand launches the bf16 kernels, never the twin
    assert after["dia_lincomb_bf16"] == before["dia_lincomb_bf16"] + 1
    assert after["dia_lincomb_pair_bf16"] == (
        before["dia_lincomb_pair_bf16"] + 1)
    assert y.dtype == yre.dtype == yim.dtype == torch.float32
    assert torch.equal(y, yre) and torch.equal(yim, tb.lincomb_apply(Wim))
    pre, pim = dia_kernel.dia_lincomb_pair_plain(
        tb.data, tb.offsets, Wre.T.contiguous(), Wim.T.contiguous())
    assert pre.dtype == torch.float32
    assert rel_err(yre.cpu().numpy(), pre.cpu().numpy()) < 1e-5
    assert rel_err(yim.cpu().numpy(), pim.cpu().numpy()) < 1e-5
    # a float32 operand on a bf16 bank promotes to the float32 kernel
    yf = tb.lincomb_apply(Wre.to(torch.float32))
    assert yf.dtype == torch.float32
    assert rel_err(yf.cpu().numpy(), pre.cpu().numpy()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_kernels_at_the_dep_shape(cuda, dtype, rtol):
    tb = DiaTermBank.from_matrices(_mats(DEP_OFFS, 10_000, 2), dtype=dtype,
                                   device=cuda)
    rng = np.random.default_rng(7)
    Wre = torch.from_numpy(rng.standard_normal((10_000, 2))).to(cuda, dtype)
    Wim = torch.from_numpy(rng.standard_normal((10_000, 2))).to(cuda, dtype)
    yre, yim = tb.lincomb_apply_split(Wre, Wim)
    assert torch.equal(yre, tb.lincomb_apply(Wre))
    pre, pim = dia_kernel.dia_lincomb_pair_plain(
        tb.data, tb.offsets, Wre.T.contiguous(), Wim.T.contiguous())
    assert rel_err(yre.cpu().numpy(), pre.cpu().numpy()) < rtol
    assert rel_err(yim.cpu().numpy(), pim.cpu().numpy()) < rtol


# narrow and generic body, offsets by value and from a device array, one row
# per thread and (bfloat16, n >= 2^17 a multiple of 8) packed rows: within a
# few roundings of the twin, the pair equal to two singles, and the same bits
# with one row per thread as with packed rows (each row is summed in one fixed
# order) - an operand that is not 16-byte aligned takes one row per thread
PACKED_N = (1 << 17) + 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12),
                                        (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("offs,n,m", [
    ([-37, -36, -3, -2, -1, 0, 1, 2, 4, 7, 36, 38], 37, 3),
    (DEP_OFFS, 10_000, 2), ([-26, -25, -1, 0, 1, 25, 26], 4096, 4),
    ([-2, 0, 3], 1000, 1), (list(range(-12, 13)), 704, 3),
    (list(range(-150, 150)), 640, 2), ([-5, -1, 0, 1, 6], 808, 5),
    ([-PACKED_N, -363, -362, -8, -3, -1, 0, 1, 2, 5, 16, 361, PACKED_N - 1],
     PACKED_N, 4),
    (DEP_OFFS, PACKED_N, 2), (DEP_OFFS, PACKED_N + 4, 3)])
def test_term_major_kernels_narrow_generic_and_packed(cuda, dtype, rtol, offs,
                                                      n, m):
    gen = torch.Generator(device=cuda).manual_seed(8)
    data = torch.randn((m, len(offs), n), generator=gen, device=cuda).to(dtype)
    WreT = torch.randn((m, n), generator=gen, device=cuda).to(dtype)
    WimT = torch.randn((m, n), generator=gen, device=cuda).to(dtype)
    launcher = dia_kernel.DiaLauncher(data, offs)
    assert launcher.vec == (8 if dtype == torch.bfloat16 and n == PACKED_N
                            else 1)
    pre, pim = dia_kernel.dia_lincomb_pair_plain(data, offs, WreT, WimT)
    before = dia_kernel.DIA_SPMV.launches
    y = launcher.single(WreT)
    yre, yim = launcher.pair(WreT, WimT)
    torch.cuda.synchronize()
    assert dia_kernel.DIA_SPMV.launches == before + 2
    assert y.dtype == dia_kernel.result_dtype(dtype)
    assert torch.equal(y, yre)
    assert torch.equal(yim, launcher.single(WimT))
    for got, ref in ((yre, pre), (yim, pim)):
        assert float((got - ref).abs().max()) <= rtol * float(ref.abs().max())
    if launcher.vec > 1:
        shifted = []
        for WT in (WreT, WimT):
            big = torch.zeros(m * n + 1, dtype=dtype, device=cuda)
            shifted.append(big[1:].view(m, n))
            shifted[-1].copy_(WT)
        assert torch.equal(launcher.single(shifted[0]), yre)
        y1re, y1im = launcher.pair(*shifted)
        assert torch.equal(y1re, yre) and torch.equal(y1im, yim)


# the generic body (more than 16 offsets or more than 4 terms) in both
# regimes: odd n, m = 5...8, more offsets than ride by value, clusters that
# are not all staged, n past GENERIC_WIDE_ROWS; within a few roundings of the
# twin, the pair equal to two singles bit for bit, and the same bits from an
# operand one element off its alignment (bfloat16 windows then move through
# registers instead of as aligned pairs)
GENERIC_CASES = [
    (tuple(range(-20, 21)), 1201, 2),
    ((-81, -80, -79, -1, 0, 1, 79, 80, 81), 6000, 5),
    ((-81, -80, -79, -1, 0, 1, 79, 80, 81), 6000, 6),
    (tuple(range(-10, 9)), 1201, 7),
    (tuple(range(-2000, 2000, 100)), 5000, 8),
    (tuple(range(-150, 150)), 1200, 1),
    (tuple(range(-300, 300, 2)), 5001, 2),
    ((3,), 700, 5),
    (tuple(sorted(a * 1000 + b * 30 + c for a in (-1, 0, 1)
                  for b in (-1, 0, 1) for c in (-1, 0, 1))), 70_001, 2),
    ((-265, -264, -263, -1, 0, 1, 263, 264, 265), 70_000, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12),
                                        (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("offs,n,m", GENERIC_CASES)
def test_generic_body_matches_twin(cuda, dtype, rtol, offs, n, m):
    gen = torch.Generator(device=cuda).manual_seed(9)
    data = torch.randn((m, len(offs), n), generator=gen, device=cuda).to(dtype)
    WreT = torch.randn((m, n), generator=gen, device=cuda).to(dtype)
    WimT = torch.randn((m, n), generator=gen, device=cuda).to(dtype)
    launcher = dia_kernel.DiaLauncher(data, offs)
    assert launcher.generic
    before = dict(dia_kernel.DIA_SPMV.generic_counts)
    y = launcher.single(WreT)
    yre, yim = launcher.pair(WreT, WimT)
    torch.cuda.synchronize()
    entry = launcher._entries
    after = dia_kernel.DIA_SPMV.generic_counts
    assert after[entry["dia_lincomb"]] == before[entry["dia_lincomb"]] + 1
    assert after[entry["dia_lincomb_pair"]] == (
        before[entry["dia_lincomb_pair"]] + 1)
    assert torch.equal(y, yre) and torch.equal(yim, launcher.single(WimT))
    pre, pim = dia_kernel.dia_lincomb_pair_plain(data, offs, WreT, WimT)
    for got, ref in ((yre, pre), (yim, pim)):
        assert float((got - ref).abs().max()) <= rtol * float(ref.abs().max())
    shifted = []
    for WT in (WreT, WimT):
        big = torch.zeros(m * n + 1, dtype=dtype, device=cuda)
        shifted.append(big[1:].view(m, n))
        shifted[-1].copy_(WT)
    assert torch.equal(launcher.single(shifted[0]), yre)
    s_re, s_im = launcher.pair(*shifted)
    assert torch.equal(s_re, yre) and torch.equal(s_im, yim)


# the order of the sums is the plan's, not the launch shape's: the other
# regime (GENERIC_WIDE_ROWS moved across n) and no staged windows give the
# same bits
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_generic_body_bits_do_not_depend_on_the_launch_shape(cuda, dtype,
                                                             monkeypatch):
    offs, n, m = (-81, -80, -79, -1, 0, 1, 79, 80, 81), 6000, 5
    gen = torch.Generator(device=cuda).manual_seed(10)
    data = torch.randn((m, len(offs), n), generator=gen, device=cuda).to(dtype)
    WreT = torch.randn((m, n), generator=gen, device=cuda).to(dtype)
    WimT = torch.randn((m, n), generator=gen, device=cuda).to(dtype)
    first = dia_kernel.DiaLauncher(data, offs)
    ref = first.pair(WreT, WimT)
    plan = dia_kernel.generic_plan
    monkeypatch.setattr(dia_kernel, "generic_plan",
                        lambda *a, **k: plan(*a, **k, stage=False))
    bare = dia_kernel.DiaLauncher(data, offs)
    monkeypatch.setattr(dia_kernel, "GENERIC_WIDE_ROWS", 1000)
    other = dia_kernel.DiaLauncher(data, offs)
    assert first.plan.split and not other.plan.split
    assert bare.plan.window == 0 and first.plan.window > 0
    for launcher in (bare, other):
        got = launcher.pair(WreT, WimT)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# a launch the C side refuses raises at the call: a plan whose windows
# overflow the block's shared memory, a row width it was not built for, and
# a wide bank without its device arrays
@pytest.mark.cuda
def test_generic_launch_errors_raise(cuda):
    data = torch.zeros((5, 9, 4096), device=cuda)
    offs = (-65, -64, -63, -1, 0, 1, 63, 64, 65)
    WT = torch.zeros((5, 4096), device=cuda)
    launcher = dia_kernel.DiaLauncher(data, offs)
    launcher._bank.clusters.window = 10**6
    with pytest.raises(RuntimeError, match="launch failed"):
        launcher.single(WT)
    launcher = dia_kernel.DiaLauncher(data, offs)
    launcher._bank.gvec = 3
    with pytest.raises(RuntimeError, match="launch failed"):
        launcher.pair(WT, WT)
    wide = tuple(range(-150, 150))
    launcher = dia_kernel.DiaLauncher(torch.zeros((1, 300, 1200), device=cuda),
                                      wide)
    launcher._bank.pos_dev = None
    with pytest.raises(RuntimeError, match="launch failed"):
        launcher.single(torch.zeros((1, 1200), device=cuda))


# the wrappers launch on the current stream, do not synchronise and read
# nothing back: ten pair launches captured into a CUDA graph replay to the
# eager result, and each captured launch is counted once
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_pair_launches_capture_into_a_cuda_graph(cuda, dtype):
    tb = DiaTermBank.from_matrices(_mats(DEP_OFFS, 10_000, 2),
                                   dtype=np.float32, device=cuda).astype(dtype)
    gen = torch.Generator(device=cuda).manual_seed(9)
    WreT = torch.randn((2, 10_000), generator=gen, device=cuda).to(dtype)
    WimT = torch.randn((2, 10_000), generator=gen, device=cuda).to(dtype)
    eager = tb.lincomb_apply_pair_t(WreT, WimT)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tb.lincomb_apply_pair_t(WreT, WimT)
    torch.cuda.current_stream().wait_stream(side)
    before = dict(dia_kernel.DIA_SPMV.counts)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [tb.lincomb_apply_pair_t(WreT, WimT) for _ in range(10)]
    assert dia_kernel.DIA_SPMV.counts["dia_lincomb_pair"] == (
        before["dia_lincomb_pair"] + 10)
    assert dia_kernel.DIA_SPMV.counts["dia_lincomb"] == before["dia_lincomb"]
    for _ in range(2):
        for yre, yim in outs:
            yre.zero_()
            yim.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for yre, yim in outs:
            assert torch.equal(yre, eager[0]) and torch.equal(yim, eager[1])


# the scan hands the bank its (terms, n) weights as it holds them: no copy
# or gather kernel for the operand of the pair launch
@pytest.mark.cuda
def test_scan_operand_reaches_the_kernel_without_a_copy(cuda):
    from torch.profiler import ProfilerActivity, profile

    tb = DiaTermBank.from_matrices(_mats(DEP_OFFS, 10_000, 2),
                                   dtype=np.float32, device=cuda)
    WreT = torch.randn((2, 10_000), device=cuda)
    WimT = torch.randn((2, 10_000), device=cuda)
    tb.lincomb_apply_split_t(WreT, WimT)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tb.lincomb_apply_split_t(WreT, WimT)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    assert len(kernels) == 1 and "dia_lincomb_pair" in kernels[0], kernels


@pytest.mark.cuda
def test_deflated_dep_applies_through_the_pair_kernel(cuda):
    """A deflated delay problem's compute_Mlincomb on the card: its padded
    DIA bank is one float64 pair launch, and the result equals the CPU
    run's (the plain twin and the same factor terms)."""
    import neptpu_torch

    rng = np.random.default_rng(6)
    v = rng.standard_normal(576) + 1j * rng.standard_normal(576)
    V = rng.standard_normal((577, 2)) + 1j * rng.standard_normal((577, 2))
    out = []
    for dev in (cuda, CPU):
        nep = neptpu_torch.nep_gallery("dep_symm_double", 24, device=dev)
        dnep = neptpu_torch.deflate_eigpair(nep, -1.0,
                                            torch.from_numpy(v).to(dev))
        dia_kernel.DIA_SPMV.reset_counts()
        out.append(neptpu_torch.compute_Mlincomb(
            dnep, -1.0 + 0.01j, torch.from_numpy(V).to(dev),
            np.array([1.0, 0.5])).cpu())
        torch.cuda.synchronize()
        if dev == cuda:
            assert dia_kernel.DIA_SPMV.entry_counts[
                "dia_lincomb_pair_f64"] == 1
    assert dia_kernel.DIA_SPMV.launches == 0  # the CPU run launched nothing
    assert rel_err(out[0].numpy(), out[1].numpy()) < 1e-12


@pytest.mark.cuda
def test_dep_scan_and_protocol_on_the_card(cuda):
    """A small delay problem on the card: one float32 pair launch per
    ``iar_real``/``tiar_real`` step, and the protocol solvers' Mlincomb
    through the float64 pair kernel, against the CPU run."""
    import neptpu_torch

    # residual tolerance 1e-8 (absolute; the operator's entries are ~1e4)
    kw = dict(sigma=-1.0, maxit=40, tol=1e-8, dtype=torch.float64)
    # the CPU reference: every pair the float64 scan converges in 40 steps
    before = dia_kernel.DIA_SPMV.launches
    ref, _ = neptpu_torch.iar_real(
        neptpu_torch.nep_gallery("dep_symm_double", 24, device=CPU),
        neigs=40, device=CPU, **kw)
    assert len(ref) >= 6 and dia_kernel.DIA_SPMV.launches == before
    nep = neptpu_torch.nep_gallery("dep_symm_double", 24, device=cuda)
    dia_kernel.DIA_SPMV.reset_counts()
    l1, Q1, info = neptpu_torch.iar_real(nep, neigs=6, return_info=True,
                                         device=cuda, **kw)
    assert dia_kernel.DIA_SPMV.entry_counts["dia_lincomb_pair_f64"] >= (
        info["k_done"]) == 40
    l2, _ = neptpu_torch.tiar_real(nep, neigs=6, device=cuda, **kw)
    l3, Q3, _ = neptpu_torch.tiar(nep, sigma=-1.0, maxit=30, neigs=3,
                                  v=np.ones(nep.n), device=cuda)
    lam, v = neptpu_torch.resinv(nep, lam=l1[0] * (1 + 1e-3), v=Q1[:, 0],
                                 device=cuda)
    assert dia_kernel.DIA_SPMV.counts["dia_lincomb"] == 0
    assert v.is_cuda and Q3.is_cuda and len(l1) == len(l2) == 6
    # each is an eigenvalue the CPU run found (modulo conjugation)
    for x in list(l1) + list(l2) + list(l3) + [lam]:
        assert min(np.min(np.abs(ref - x)),
                   np.min(np.abs(ref - np.conj(x)))) / abs(x) < 1e-8


@pytest.mark.cuda
def test_small_slice_on_the_card_matches_cpu(cuda):
    """float32 scan on the card vs. float64 on the CPU, both refined on the
    host: the same eigenvalues to rel 1e-9."""
    ops = small_gun_like()
    out = {}
    # the CPU reference returns every converged pair (neigs above the count)
    for dev, dt, neigs, tol, every in ((cuda, torch.float32, 6, 1e-5, 20),
                                       (CPU, torch.float64, 16, 1e-10,
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


def _deflated_step_inputs(device, dtype):
    """A small gun-structured problem's bank, shifted solver, scaled table
    and an invariant pair of two, ready for one deflated scan step."""
    from neptpu_torch.ops.mixed import make_mixed_bank
    from neptpu_torch.solvers.iar_real import (DeflationOps, apply_theta,
                                               as_pair_solver)
    from neptpu_torch.solvers.spmf_real import (spmf_coeff_table,
                                                spmf_shift_block_lu)

    nep = _gun_from_matrices(*small_gun_like(nx=24), device=device)
    mats, fv = collect_spmf_terms(nep)
    n, m, p = nep.n, 8, 2
    bank = make_mixed_bank(mats, dtype=np.dtype(str(dtype)[6:]),
                           device=device)
    solver = as_pair_solver(spmf_shift_block_lu(mats, fv, SMALL_SIGMA,
                                                dtype=dtype, device=device))
    Cre, Cim = spmf_coeff_table(fv, SMALL_SIGMA, SMALL_GAMMA, m, scaled=True)
    Cre, Cim = apply_theta(Cre, Cim, 0.8)
    f0 = spmf_fun_scalars(fv, SMALL_SIGMA)
    Cre[:, 0], Cim[:, 0] = f0.real, f0.imag
    rng = np.random.default_rng(7)
    X, _ = np.linalg.qr(rng.standard_normal((n, p))
                        + 1j * rng.standard_normal((n, p)))
    S = np.diag(SMALL_SIGMA + np.array([3000.0 + 2j, -4500.0 + 1j]))
    defl = DeflationOps.build(X, S, SMALL_SIGMA, SMALL_GAMMA * 0.8, m, dtype,
                              device=device)
    from neptpu_torch.solvers.iar_real import _init_carry

    v0 = rng.standard_normal((2, n + p))
    carry = _init_carry(m, *(torch.from_numpy(v).to(device=device,
                                                     dtype=dtype)
                             for v in v0), dtype)
    table = [torch.from_numpy(C).to(device=device, dtype=dtype)
             for C in (Cre, Cim)]
    return bank, solver, table, defl, carry, m


@pytest.mark.cuda
def test_deflated_scan_step_on_the_card(cuda):
    """The first deflated step of a scan (basis n + p, the bank at n) on the
    card makes exactly one float32 pair launch and equals the same step on
    the CPU."""
    from neptpu_torch.solvers.iar_real import _step_fn

    out = {}
    for device in (cuda, torch.device(CPU)):
        bank, solver, (Cre, Cim), defl, carry, m = _deflated_step_inputs(
            device, torch.float32)
        dia_kernel.DIA_SPMV.reset_counts()
        _step_fn(bank, m, Cre, Cim, 0.0, 0.0, solver, torch.float32,
                 scaled=True, inv_theta=1.25, defl=defl)(
            carry, torch.ones((), dtype=torch.int64, device=device))
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert dia_kernel.DIA_SPMV.entry_counts == {
                **{k: 0 for k in dia_kernel.DIA_SPMV.entry_counts},
                "dia_lincomb_pair_f32": 1}
        out[device.type] = [c.cpu().numpy() for c in carry]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert rel_err(a, b) < 1e-4


@pytest.mark.cuda
def test_ilan_bmult_on_the_card(cuda):
    """``ilan``'s rank-q delay Bmult through the DIA bank on the card (pair
    launches, one per column) equals the CPU."""
    from neptpu_torch import DEP, nep_gallery
    from neptpu_torch.solvers.ilan import (_bmult, _fdh_tables,
                                           symmetrizer_coefficients)

    mats = nep_gallery("dep_symm_double", 30, device=CPU).bank.host_csr_terms()
    m, k, sigma, gamma = 12, 10, -1.0, 1.0
    G = symmetrizer_coefficients(m)
    Qn = np.random.default_rng(8).standard_normal((900, m + 1)) * (1 + 1j)
    Z = {}
    for device in (cuda, torch.device(CPU)):
        nep = DEP(None, tauv=[0.0, 2.0], bank=DiaTermBank.from_matrices(
            mats, device=device))
        F = _fdh_tables(nep, m, sigma, gamma)
        before = dia_kernel.DIA_SPMV.counts["dia_lincomb_pair"]
        Z[device.type] = _bmult(nep, k, torch.from_numpy(Qn).to(device), G,
                                F, sigma, gamma).cpu().numpy()
        if device.type == "cuda":
            assert dia_kernel.DIA_SPMV.counts["dia_lincomb_pair"] > before
    assert rel_err(Z["cuda"], Z["cpu"]) < 1e-12


def _small_gun_pair(device):
    K, M, W1, W2 = small_gun_like()
    return _gun_from_matrices(K, M, W1, W2, device=device)


@pytest.mark.cuda
def test_rknep_weighted_apply_is_one_pair_launch(cuda):
    """NLEIGS's matrix-free divided difference ``sum_i c_i A_i x`` on the
    card equals the CPU plain twin (float64, rel 1e-12) and launches the
    pair kernel once, on the polynomial part's DIA bank (the square roots'
    terms are a CSR bank)."""
    from neptpu_torch.solvers.rk.rknep import get_rk_nep

    rng = np.random.default_rng(6)
    c = rng.standard_normal(4) + 1j * rng.standard_normal(4)
    x = rng.standard_normal(576) + 1j * rng.standard_normal(576)
    y_cpu = get_rk_nep(_small_gun_pair(CPU)).apply_weighted(
        c, torch.as_tensor(x))
    P = get_rk_nep(_small_gun_pair(cuda))
    dia_kernel.DIA_SPMV.reset_counts()
    y = P.apply_weighted(c, torch.as_tensor(x, device=cuda))
    torch.cuda.synchronize()
    assert dia_kernel.DIA_SPMV.entry_counts["dia_lincomb_pair_f64"] == 1
    assert dia_kernel.DIA_SPMV.launches == 1
    assert rel_err(y.cpu().numpy(), y_cpu.numpy()) < 1e-12


@pytest.mark.cuda
def test_aaa_operator_apply_is_one_pair_launch(cuda):
    """AAAeigs's operator apply ``sum_i P_i W[:, i]`` (``W = Q u_c``) on the
    card equals the CPU plain twin (float64, rel 1e-12) with one pair launch
    on the DIA bank."""
    from neptpu_torch.solvers.aaa import _operator_apply

    rng = np.random.default_rng(7)
    W = rng.standard_normal((576, 4)) + 1j * rng.standard_normal((576, 4))
    out = {}
    for dev in (CPU, cuda):
        nep = _small_gun_pair(dev)
        apply = _operator_apply(nep, nep.nep1, nep.nep2, [0, 1])
        dia_kernel.DIA_SPMV.reset_counts()
        out[str(dev)] = apply(torch.as_tensor(W, device=dev))
    torch.cuda.synchronize()
    assert dia_kernel.DIA_SPMV.entry_counts["dia_lincomb_pair_f64"] == 1
    assert dia_kernel.DIA_SPMV.launches == 1
    assert rel_err(out["cuda"].cpu().numpy(), out["cpu"].numpy()) < 1e-12


@pytest.mark.cuda
def test_rational_family_on_the_card(cuda):
    """NLEIGS, AAAeigs and Beyn on the small gun-structured problem on the
    card give the CPU run's eigenvalues (rel 1e-10); Beyn factors its nodes
    as stacked LUs."""
    from neptpu_torch import (AAAeigs, StandardSPMFErrmeasure, contour_beyn,
                              nleigs)
    from neptpu_torch.models.gallery.nlevp import GUN_SIGMA2
    from neptpu_torch.solvers import contour

    K, M, W1, W2 = small_gun_like()
    K = (4 * K).tocsr()
    box = [14900 - 10j, 14900 + 10j, 15060 + 10j, 15060 - 10j]
    nodes = [14930 + 2j, 15010 + 2j]
    Z = (np.linspace(14900, 15060, 41)[None, :]
         + 1j * np.linspace(-10, 10, 11)[:, None]).ravel()
    res = {}
    for dev in (CPU, cuda):
        nep = _gun_from_matrices(K, M, W1, W2, device=dev)
        contour.BATCHED_LU.update(chunks=0, nodes=0)
        res[str(dev)] = [
            nleigs(nep, box, Xi=GUN_SIGMA2**2 - np.logspace(-8, 8, 10000),
                   nodes=nodes, tol=1e-10, errmeasure=StandardSPMFErrmeasure,
                   device=dev)[0],
            AAAeigs(nep, Z, neigs=6, shifts=nodes, tol=1e-10,
                    errmeasure=StandardSPMFErrmeasure, device=dev)[0],
            contour_beyn(nep, sigma=14960 + 1.5j, radius=(45.0, 10.0), N=64,
                         neigs=6, k=8, chunk=8, device=dev,
                         errmeasure=StandardSPMFErrmeasure)[0]]
        assert contour.BATCHED_LU == {"chunks": 8, "nodes": 64}
    for a, b in zip(res["cuda"], res["cpu"]):
        assert len(a) == len(b) > 0
        for x in a:
            assert np.min(np.abs(b - x)) <= 1e-10 * abs(x)


@pytest.mark.cuda
def test_native_wep_solvers_on_the_card_match_cpu(cuda):
    """The native waveguide's three Schur-complement solvers and the SMW
    preconditioner on the card (cuFFT, cuSOLVER LU) against the same on the
    CPU."""
    import neptpu_torch as nt
    from neptpu_torch.models.gallery import waveguide as tw

    spec = dict(nx=25, nz=21, benchmark_problem="TAUSCH", neptype="WEP")
    sigma = -3 - 3.5j
    gpu = nt.nep_gallery("waveguide", device=cuda, **spec)
    cpu = nt.nep_gallery("waveguide", device=CPU, **spec)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(gpu.n) + 1j * rng.standard_normal(gpu.n)
    for kind in (":factorized", ":backslash"):
        xg = nt.WEPLinSolverCreator(kind).create(gpu, sigma).solve(
            torch.as_tensor(b, device=cuda))
        xc = nt.WEPLinSolverCreator(kind).create(cpu, sigma).solve(
            torch.as_tensor(b))
        assert xg.device.type == "cuda"
        assert rel_err(xg.cpu().numpy(), xc.numpy()) < 1e-12
    pg = tw.wep_generate_preconditioner(gpu, 7, sigma)
    pc = tw.wep_generate_preconditioner(cpu, 7, sigma)
    v = torch.as_tensor(b[: 25 * 21])
    assert rel_err(pg(v.to(cuda)).cpu().numpy(), pc(v).numpy()) < 1e-12
    sg = tw.WEPGMRESLinSolver(gpu, sigma, preconditioner=pg, reltol=1e-10)
    xg = sg.solve(torch.as_tensor(b, device=cuda))
    r = gpu.Mlincomb(sigma, xg).cpu().numpy()
    assert rel_err(r, b) < 1e-8 and sg.info == [0]


@pytest.mark.cuda
def test_complex_scans_on_the_card_match_cpu(cuda):
    """iar_jitted and tiar_jitted on a delay problem, tiar_jitted_spmf on a
    small gun (one f64 pair launch a step) on the card, against the CPU."""
    import neptpu_torch as nt

    # five pairs converge to ~1e-15 and the next to 1.6e-11: asking for five
    # takes the same five on both devices (a best four of the five is a tie
    # that rounding breaks either way)
    for name in ("iar_jitted", "tiar_jitted"):
        out = []
        for dev in (cuda, CPU):
            dep = nt.nep_gallery("dep0_tridiag", 64, device=dev)
            out.append(getattr(nt, name)(dep, sigma=-0.3, maxit=30,
                                         neigs=5, tol=1e-10, device=dev)[0])
        assert len(out[0]) == len(out[1]) == 5
        assert np.max(np.abs(np.sort_complex(out[0])
                             - np.sort_complex(out[1]))) < 1e-10
    # at nx = 24 the main bank is a DIA bank (at nx = 12 a CSR one)
    ops = small_gun_like(nx=24)
    kw = dict(sigma=SMALL_SIGMA, gamma=SMALL_GAMMA, maxit=30, neigs=4,
              tol=1e-8)
    before = dia_kernel.DIA_SPMV.entry_counts["dia_lincomb_pair_f64"]
    lg, _ = nt.tiar_jitted_spmf(_gun_from_matrices(*ops, device=cuda),
                                device=cuda, **kw)
    launched = (dia_kernel.DIA_SPMV.entry_counts["dia_lincomb_pair_f64"]
                - before)
    lc, _ = nt.tiar_jitted_spmf(_gun_from_matrices(*ops, device=CPU),
                                device=CPU, **kw)
    assert launched == 30 and len(lg) == len(lc) >= 4
    assert np.max(np.abs(np.sort_complex(lg) - np.sort_complex(lc))) < 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_window_apply_matches_twin(cuda, dtype, rtol):
    """Kernel B1 on a rank's window (the block's bank zero-padded by its
    halos, the operand ``[halo_prev; W_d; halo_next]``): one pair launch,
    against the plain twin on the same window and the serial apply's rows."""
    from neptpu_torch.parallel.halo import _window_bank, window_operand

    offs, n, m, blk, lo = [-101, -100, -1, 0, 1, 100, 101], 1000, 2, 250, 1
    mats = _mats(offs, n, m)
    full = DiaTermBank.from_matrices(mats, dtype=dtype, device=cuda)
    win = _window_bank(full.data[:, :, lo * blk:(lo + 1) * blk].contiguous(),
                       full.offsets, 101, 101)
    g = torch.Generator(device=cuda).manual_seed(0)
    Wre = torch.randn((m, n), generator=g, device=cuda, dtype=dtype)
    Wim = torch.randn((m, n), generator=g, device=cuda, dtype=dtype)
    ops = [window_operand(W[:, blk:2 * blk], W[:, blk - 101:blk],
                          W[:, 2 * blk:2 * blk + 101]) for W in (Wre, Wim)]
    assert tuple(win.data.shape) == (m, len(offs), blk + 202)
    before = dict(dia_kernel.DIA_SPMV.entry_counts)
    yre, yim = win.lincomb_apply_pair_t(*ops)
    torch.cuda.synchronize()
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert (dia_kernel.DIA_SPMV.entry_counts[f"dia_lincomb_pair_{sfx}"]
            == before[f"dia_lincomb_pair_{sfx}"] + 1)
    pre, pim = dia_kernel.dia_lincomb_pair_plain(win.data, win.offsets, *ops)
    assert rel_err(yre.cpu().numpy(), pre.cpu().numpy()) < rtol
    assert rel_err(yim.cpu().numpy(), pim.cpu().numpy()) < rtol
    ref = full.lincomb_apply_t(Wre)[blk:2 * blk]
    assert rel_err(yre[101:101 + blk].cpu().numpy(), ref.cpu().numpy()) < rtol


@pytest.mark.cuda
def test_iar_real_sharded_one_rank_nccl(cuda):
    """``iar_real_sharded`` on a one-rank NCCL mesh: one float64 pair
    launch a step on the rank's block, the steps replayed as one captured
    graph, the eigenvalues of the serial ``iar_real`` on the card."""
    import torch.distributed as dist

    import neptpu_torch as nt
    from neptpu_torch.parallel import make_mesh
    from neptpu_torch.solvers.iar_sharded import iar_real_sharded

    dep = nt.nep_gallery("dep0_tridiag", 512, device=cuda)
    kw = dict(sigma=-0.2 + 0.1j, maxit=40, neigs=4, tol=1e-6,
              dtype=torch.float64)
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device=cuda)
        assert mesh.backend == "nccl" and not mesh.host_staged
        before = dia_kernel.DIA_SPMV.entry_counts["dia_lincomb_pair_f64"]
        lam, Q, info = iar_real_sharded(dep, mesh, return_info=True, **kw)
        launched = (dia_kernel.DIA_SPMV.entry_counts["dia_lincomb_pair_f64"]
                    - before)
    finally:
        dist.destroy_process_group()
    lam_s, _ = nt.iar_real(dep, device=cuda, **kw)
    assert launched == 40 and info["bulk"] == (2, 3, 512)
    assert info["graph"]["graphed"] and info["graph"]["replays"] == 39
    assert len(lam) == len(lam_s) >= 4
    assert np.max(np.abs(np.sort_complex(lam) - np.sort_complex(lam_s))) \
        < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_bulk_boundary_apply_matches_the_window_apply(cuda, dtype, rtol):
    """A rank's split apply - one B1 pair launch on its block, then the
    boundary corrections from the two strips - against the one-launch
    window form on the same strips, on the card."""
    from neptpu_torch.parallel.halo import (_add_boundary, _block_bank,
                                            _boundary_plan, _window_bank,
                                            window_operand)

    offs, n, m, blk, h = [-101, -100, -1, 0, 1, 100, 101], 1000, 2, 250, 101
    full = DiaTermBank.from_matrices(_mats(offs, n, m), dtype=dtype,
                                     device=cuda)
    data = full.data[:, :, blk:2 * blk].contiguous()
    g = torch.Generator(device=cuda).manual_seed(0)
    Ws = [torch.randn((m, n), generator=g, device=cuda, dtype=dtype)
          for _ in range(2)]
    mine = [W[:, blk:2 * blk].contiguous() for W in Ws]
    prev = torch.cat([W[:, blk - h:blk] for W in Ws])
    nxt = torch.cat([W[:, 2 * blk:2 * blk + h] for W in Ws])
    sfx = "f32" if dtype == torch.float32 else "f64"
    before = dict(dia_kernel.DIA_SPMV.entry_counts)
    ys = _block_bank(data, offs).lincomb_apply_pair_t(*mine)
    _add_boundary(ys, _boundary_plan(data, offs, h, h), prev, nxt)
    torch.cuda.synchronize()
    assert (dia_kernel.DIA_SPMV.entry_counts[f"dia_lincomb_pair_{sfx}"]
            == before[f"dia_lincomb_pair_{sfx}"] + 1)
    win = _window_bank(data, offs, h, h).lincomb_apply_pair_t(
        *[window_operand(W[:, blk:2 * blk], W[:, blk - h:blk],
                         W[:, 2 * blk:2 * blk + h]) for W in Ws])
    for y, w, W in zip(ys, win, Ws):
        assert rel_err(y.cpu().numpy(), w[h:h + blk].cpu().numpy()) < rtol
        ref = full.lincomb_apply_t(W)[blk:2 * blk]
        assert rel_err(y.cpu().numpy(), ref.cpu().numpy()) < rtol


@pytest.mark.cuda
def test_nccl_collectives_capture_into_a_graph(cuda):
    """At one NCCL rank, ``all_reduce`` and ``all_gather_into_tensor`` of a
    tensor made in the graph, captured once after a warm-up on the capture
    stream, replay exactly on new inputs (three replays); so does the
    Mesh's NCCL ``all_gather``."""
    import torch.distributed as dist

    from neptpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device=cuda)
        x = torch.zeros(1000, dtype=torch.float64, device=cuda)

        def body():
            y = x * 2.0
            dist.all_reduce(y)
            out = torch.empty(1000, dtype=x.dtype, device=cuda)
            dist.all_gather_into_tensor(out, y)
            return y, out

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            y, out = body()
        for i in range(3):
            x.copy_(torch.arange(1000, dtype=x.dtype, device=cuda) + i)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(y, 2.0 * x) and torch.equal(out, 2.0 * x)
        graph.reset()
        assert torch.equal(mesh.all_gather(x, "rows"), x[None])
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["dep", "gun"])
def test_sharded_scan_one_rank_graph_equals_the_eager_loop(cuda, scan):
    """The sharded scans on a one-rank NCCL mesh: the steps replayed as one
    captured graph (m - 1 replays after the warm-up step) against the eager
    comparator - the same launches, the Hessenberg within rel 1e-12 and the
    same eigenvalues (float64)."""
    import torch.distributed as dist

    import neptpu_torch as nt
    from neptpu_torch.parallel import make_mesh
    from neptpu_torch.parallel.mixed_sharded import iar_real_spmf_sharded
    from neptpu_torch.solvers.iar_sharded import iar_real_sharded

    m = 30
    kw = dict(maxit=m, neigs=m, tol=np.inf, dtype=torch.float64,
              return_info=True)
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device=cuda)
        if scan == "dep":
            nep = nt.nep_gallery("dep0_tridiag", 512, device=cuda)
            runs = _graph_and_eager(lambda: iar_real_sharded(
                nep, mesh, sigma=-0.2 + 0.1j, **kw))
        else:
            nep = _gun_from_matrices(*small_gun_like(nx=24), device=cuda)
            runs = _graph_and_eager(lambda: iar_real_spmf_sharded(
                nep, mesh, sigma=SMALL_SIGMA, gamma=SMALL_GAMMA, **kw))
    finally:
        dist.destroy_process_group()
    (graph, n_graph), (eager, n_eager) = runs
    (lg, _, ig), (le, _, ie) = graph, eager
    steps = ig.get("steps", m)
    assert n_graph == n_eager
    assert n_graph["dia_lincomb_pair_f64"] == sum(n_graph.values()) == steps
    assert ig["graph"]["graphed"] and ig["graph"]["why"] is None
    assert ig["graph"]["replays"] == steps - 1
    assert ie["graph"] == {"graphed": False, "eager_steps": steps,
                           "replays": 0, "capture_s": 0.0,
                           "why": "eager comparator"}
    assert rel_err(ig["hessenberg"], ie["hessenberg"]) < 1e-12
    lg, le = np.sort_complex(lg), np.sort_complex(le)
    assert len(lg) == len(le) > 0
    assert np.max(np.abs(lg - le) / np.abs(le)) < 1e-10


@pytest.mark.cuda
def test_iar_jitted_on_a_deflated_problem_is_graphed(cuda, monkeypatch):
    """``iar_jitted`` on ``pep0`` deflated by its first pair - a problem
    whose Mlincomb only calls its inner SPMF's - is captured on the card
    (29 replays a scan) and gives the CPU run's eigenvalue (rel 1e-8)."""
    import neptpu_torch as nt
    from neptpu_torch.solvers import iar_jit, scan_graph

    made = []

    class Recorded(scan_graph.StepGraph):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(iar_jit, "StepGraph", Recorded)
    lams = {}
    for dev in (cuda, CPU):
        nep = nt.nep_gallery("pep0", device=dev)
        kw = dict(sigma=0.0, neigs=1, maxit=30, device=dev)
        l0, Q0, _ = nt.iar_jitted(nep, **kw)
        dnep = nt.deflate_eigpair(nep, complex(l0[0]), Q0[:, 0])
        lams[str(dev)] = complex(nt.iar_jitted(dnep, **kw)[0][0])
    card = [run.stats() for run in made[:2]]
    assert all(st["graphed"] and st["replays"] == 29 for st in card)
    assert abs(lams["cuda"] - lams[CPU]) < 1e-8 * abs(lams[CPU])


def _graph_and_eager(run):
    """``run()`` as the graph path, then inside the eager comparator: both
    results and the kernel launches each made."""
    from neptpu_torch.solvers.scan_graph import _eager_loop

    out = []
    for eager in (False, True):
        before = dia_kernel.DIA_SPMV.snapshot()
        if eager:
            with _eager_loop():
                res = run()
        else:
            res = run()
        torch.cuda.synchronize()
        out.append((res, dia_kernel.DIA_SPMV.launches_since(before)[1]))
    return out


# graph replay runs the eager loop's kernels on the same data: the same
# Hessenberg to rounding (rel 1e-6 float32, 1e-12 float64 / complex128), the
# same steps and launches, and the same Ritz values (every one of them:
# ``tol`` 1e300 counts each as converged, so the pairs compared do not
# depend on a residual at the tolerance)
@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["iar_real", "tiar_real", "iar_real_spmf",
                                  "iar_real_spmf_f64", "deflated",
                                  "tiar_jitted", "tiar_jitted_spmf",
                                  "iar_jitted"])
def test_graph_replay_equals_the_eager_loop(cuda, scan):
    import neptpu_torch as nt

    dep = nt.nep_gallery("dep_symm_double", 24, device=cuda)
    gun = _gun_from_matrices(*small_gun_like(nx=24), device=cuda)
    m = 30
    every = dict(tol=1e300, neigs=m, check_error_every=10, return_info=True,
                 device=cuda)
    dkw = dict(every, sigma=-1.0 + 0.2j, maxit=m)
    gkw = dict(every, sigma=SMALL_SIGMA, gamma=SMALL_GAMMA, maxit=m)
    mats, fv = collect_spmf_terms(gun)
    runs = {
        "iar_real": lambda: nt.iar_real(dep, dtype=torch.float32, **dkw),
        "tiar_real": lambda: nt.tiar_real(dep, dtype=torch.float32, **dkw),
        "iar_real_spmf": lambda: iar_real_spmf(gun, dtype=torch.float32,
                                               **gkw),
        # float64: the SPIKE solver's 'lu' mode (triangular solves)
        "iar_real_spmf_f64": lambda: iar_real_spmf(gun, dtype=torch.float64,
                                                   **gkw),
        "deflated": lambda: nt.iar_real_spmf_deflated(
            gun, sigma=SMALL_SIGMA, gamma=SMALL_GAMMA, maxit=15, neigs=6,
            tol=1e-10, restarts=3, check_error_every=10,
            dtype=torch.float64, return_info=True, device=cuda,
            errmeasure=backward_errmeasure(mats, fv, spmf_fun_scalars)),
        "tiar_jitted": lambda: nt.tiar_jitted(dep, **dkw),
        "tiar_jitted_spmf": lambda: nt.tiar_jitted_spmf(gun, **gkw),
        "iar_jitted": lambda: nt.iar_jitted(
            dep, sigma=-1.0 + 0.2j, maxit=m, neigs=m, tol=1e300,
            device=cuda)}
    (graph, n_graph), (eager, n_eager) = _graph_and_eager(runs[scan])
    assert n_graph == n_eager and sum(n_graph.values()) > 0
    f32 = scan in ("iar_real", "tiar_real", "iar_real_spmf")
    tol = 1e-6 if f32 else 1e-12
    if scan == "iar_jitted":
        (lg, _, Vg), (le, _, Ve) = graph, eager
        assert rel_err(Vg.cpu().numpy(), Ve.cpu().numpy()) < tol
    elif scan == "deflated":
        (lg, _, ig), (le, _, ie) = graph, eager
        assert ig["sweeps"] == ie["sweeps"]
        assert ig["k_done_sweeps"] == ie["k_done_sweeps"]
        for a, b, ga, gb in zip(ig["hessenberg_sweeps"],
                                ie["hessenberg_sweeps"], ig["graph_sweeps"],
                                ie["graph_sweeps"]):
            assert rel_err(a, b) < tol
            assert ga["graphed"] and not gb["graphed"]
    else:
        (lg, _, ig), (le, _, ie) = graph, eager
        assert ig["k_done"] == ie["k_done"] == m
        assert ig["graph"]["graphed"] and not ie["graph"]["graphed"]
        assert ig["graph"]["replays"] == m - 1
        assert ig["graph"]["eager_steps"] == 1
        assert rel_err(ig["hessenberg"], ie["hessenberg"]) < tol
    lg, le = np.sort_complex(np.asarray(lg)), np.sort_complex(np.asarray(le))
    assert len(lg) == len(le) > 0
    assert np.max(np.abs(lg - le) / np.abs(le)) < (1e-5 if f32 else 1e-10)


@pytest.mark.cuda
def test_launch_counters_count_replays(cuda):
    """A graphed ``iar_real`` on a DIA bank: one float64 pair launch a
    step in the counts - the warm-up step's own, then the captured launch
    once per replay (the capture itself counts none)."""
    import neptpu_torch as nt

    dep = nt.nep_gallery("dep_symm_double", 24, device=cuda)
    dia_kernel.DIA_SPMV.reset_counts()
    _, _, info = nt.iar_real(dep, sigma=-1.0, maxit=25, neigs=25,
                             tol=np.inf, dtype=torch.float64,
                             errmeasure=lambda lam, q: 0.0,
                             return_info=True, device=cuda)
    assert info["k_done"] == 25 and info["graph"]["replays"] == 24
    assert dia_kernel.DIA_SPMV.entry_counts == {
        **{k: 0 for k in dia_kernel.DIA_SPMV.entry_counts},
        "dia_lincomb_pair_f64": 25}
    assert info["graph"]["capture_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,dtype", [((), 64, torch.complex128),
                                           ((), 3000, torch.float32),
                                           ((16,), 100, torch.float64),
                                           ((16,), 1245, torch.float64)])
def test_lu_solve_under_capture_equals_the_eager_solve(cuda, batch, n,
                                                       dtype):
    """``torch.linalg.lu_solve``, the scans' shifted solves, captured into a
    CUDA graph and replayed equals the eager solve at each of its paths:
    cuSOLVER's getrs (n = 64), the triangular solves (n = 3000), a batch
    (16 x 100) and a batch above 512 rows (16 x 1245, the SPIKE blocks of
    gun_like in float64, where PyTorch takes MAGMA's batched trsm)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    A = torch.randn(batch + (n, n), dtype=dtype, device=cuda, generator=g)
    A = A + n * torch.eye(n, dtype=dtype, device=cuda)
    B = torch.randn(batch + (n, 1), dtype=dtype, device=cuda, generator=g)
    lu, piv = torch.linalg.lu_factor(A)
    ref = torch.linalg.lu_solve(lu, piv, B)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        torch.linalg.lu_solve(lu, piv, B)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        X = torch.linalg.lu_solve(lu, piv, B)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(X, ref)


@pytest.mark.cuda
def test_a_step_that_reads_the_host_fails_to_capture_and_raises(cuda):
    """A step that reads its index on the host (``.item()``) runs its
    eager warm-up step, then its capture raises: the runner keeps no graph,
    runs no further step and leaves the launch counts as they were."""
    from neptpu_torch.solvers.scan_graph import StepGraph

    bank = DiaTermBank.from_matrices(_mats([-1, 0, 1], 500, 2),
                                     dtype=torch.float32, device=cuda)
    W = torch.ones((2, 500), dtype=torch.float32, device=cuda)
    out = torch.zeros(500, dtype=torch.float32, device=cuda)

    def step(carry, k):
        yre, _ = bank.lincomb_apply_pair_t(W * float(k.item()), W)
        carry[0].add_(yre)

    k = torch.ones((), dtype=torch.int64, device=cuda)
    dia_kernel.DIA_SPMV.reset_counts()
    run = StepGraph(step, (out,), k)
    with pytest.raises(RuntimeError):
        run.advance(3)
    torch.cuda.synchronize()
    assert run.graph is None and run.replays == 0 and run.eager_steps == 1
    assert dia_kernel.DIA_SPMV.counts["dia_lincomb_pair"] == 1
    assert int(k) == 2
    run.close()
