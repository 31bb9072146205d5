"""The chip refinement backend's operands, filled on the device: the operands
``BatchedShiftSMW`` builds from a plan's device form (one weight contraction
and fixed scatters, all shifts of a batch at once) equal those of the host
assembly ``ShiftPlan.parts`` + ``interleave_complex_banded`` +
``complex_lowrank_to_half`` + ``_pad_strips``; and the device form is built
only where a batch uses the plan, once, which the counter
``nt.refine.chip.upload_bytes`` shows.  CPU, port only."""
import numpy as np
import pytest
import torch

from torch_port_helpers import CPU, small_gun_like

import neptpu_torch
from neptpu_torch import trace
from neptpu_torch.models.gallery.nlevp import _gun_from_matrices
from neptpu_torch.ops.partitioned import (BatchedShiftSMW, ShiftPlan,
                                          _assemble_DBC, _pad_strips,
                                          complex_lowrank_to_half)
from neptpu_torch.parallel.spike import interleave_complex_banded
from neptpu_torch.solvers import refine as trefine
from neptpu_torch.solvers.spmf_real import collect_spmf_terms, spmf_fun_scalars

WEP = dict(nx=29, nz=21, benchmark_problem="JARLEBRING", neptype="SPMF")
WEP_SIGMAS = np.array([-3 - 3.5j, -2 + 1j, -5 - 1j])
GUN_SIGMAS = np.array([1250 + 5j, 900 + 40j])
UPLOAD = "nt.refine.chip.upload_bytes"


def _problem(case):
    """``(mats, fv, sigmas)`` of a plan case."""
    if case == "gun_band":
        nep = _gun_from_matrices(*small_gun_like(nx=12), device=CPU)
        return collect_spmf_terms(nep) + (GUN_SIGMAS,)
    nep = neptpu_torch.nep_gallery("waveguide", device=CPU, **WEP)
    mats, fv = collect_spmf_terms(nep)
    if case == "wep_no_zeros":
        mats = [A.tocsr().copy() for A in mats]
        for A in mats:
            A.eliminate_zeros()
    return mats, fv, WEP_SIGMAS


@pytest.fixture(scope="module", params=["wep_arrow", "wep_no_zeros",
                                        "gun_band"])
def case(request):
    mats, fv, sigmas = _problem(request.param)
    plan = ShiftPlan(mats, fv)
    # the structure each case stands for
    kind = request.param
    assert plan.ok
    assert (plan.m > 0) == (kind != "gun_band")
    assert (len(plan.lr) > 0) == (kind != "wep_arrow")
    return dict(kind=kind, mats=mats, fv=fv, sigmas=sigmas, plan=plan)


def _host_operands(plan, sigmas, p):
    """The host assembly, shift by shift: padded strips (float64), the
    float64 band at the block-tridiagonal width and the SMW halves."""
    rs, Lt, Ut = [], [], []
    for sg in sigmas:
        strips, offs, Lc, Uc = plan.parts(sg)
        rstrips, roffs = interleave_complex_banded(strips, offs)
        rs.append(rstrips)
        if Lc is None:
            Lc = np.zeros((plan.n, 1), dtype=complex)
            Uc = np.zeros((plan.n, 1), dtype=complex)
        Lh, Uh = complex_lowrank_to_half(Lc, Uc)
        Lt.append(Lh)
        Ut.append(Uh)
    n2 = rs[0].shape[1]
    offsets = tuple(int(o) for o in roffs)
    b = max(max(abs(o) for o in offsets), 1)
    blk = -(-n2 // p)
    while blk < b:
        p = max(p // 2, 1)
        blk = -(-n2 // p)
    nblk = -(-n2 // b)
    band = np.zeros((len(rs), len(offsets), nblk * b))
    band[:, :, :n2] = np.stack(rs)
    return dict(offsets=offsets, p=p, blk=blk, bt=b, nblk=nblk,
                strips=np.stack([_pad_strips(r, offsets, p * blk)
                                 for r in rs]),
                band=band, Lh=np.stack(Lt), Uh=np.stack(Ut))


def _close(got, want):
    """Same shape, and within 1e-15 of ``want``'s largest entry."""
    got = np.asarray(torch.as_tensor(got).to(torch.float64))
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-15 * np.max(np.abs(want))


@pytest.mark.parametrize("branch", ["ir", "plain64", "plain32"])
def test_device_filled_operands_match_the_host_assembly(case, branch):
    """Every operand of a batch, in the three branches the solver builds:
    float32 strips with the float64 band and halves (``ir``), float64 or
    float32 strips and halves without it."""
    plan, sigmas = case["plan"], case["sigmas"]
    ref = _host_operands(plan, sigmas, 8)
    ir = 3 if branch == "ir" else 0
    dtype = torch.float64 if branch == "plain64" else torch.float32
    form = plan.on_device(torch.device(CPU))
    layout, strips, band, Lh, Uh = form.batch(sigmas, 8, ir, dtype)
    assert form.offsets == ref["offsets"]
    assert layout == (ref["p"], ref["blk"], ref["bt"], ref["nblk"])
    assert strips.dtype == dtype
    want = ref["strips"].astype(np.float32 if dtype == torch.float32
                                else np.float64)
    _close(strips, want)
    width = ref["nblk"] * ref["bt"]
    assert band.shape[-1] >= (width if ir else ref["p"] * ref["blk"])
    assert not band[..., 2 * plan.n:].any()
    _close(band[..., :min(width, band.shape[-1])],
           ref["band"][..., :min(width, band.shape[-1])])
    _close(Lh, ref["Lh"])
    _close(Uh, ref["Uh"])
    if case["kind"] == "wep_no_zeros":
        # the zero-free bulk leaves the border rows' diagonal empty: the
        # partition blocks are singular, there and on the host alike
        return
    bs = BatchedShiftSMW(case["mats"], case["fv"], sigmas, dtype=dtype, p=8,
                         plan=plan, ir=ir, device=CPU)
    if ir:
        stored = (bs.base.strips, bs.Lh64, bs.Uh64)
        assert bs.btdims == (ref["nblk"], ref["bt"])
        DBC = _assemble_DBC(torch.from_numpy(ref["band"]), form.offsets,
                            ref["nblk"], ref["bt"], ref["bt"], ref["bt"])
        for got, want in zip((bs.D64, bs.B64, bs.C64), DBC):
            _close(got, want)
    else:
        stored = (bs.smw.base.strips, bs.smw.Lh, bs.smw.Uh)
    for got, want in zip(stored, (strips, Lh.to(dtype) if not ir else Lh,
                                  Uh.to(dtype) if not ir else Uh)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_plan_form_is_uploaded_once_and_each_batch_sends_its_weights():
    mats, fv, sigmas = _problem("wep_arrow")
    plan = ShiftPlan(mats, fv)
    with trace.collect() as c:
        BatchedShiftSMW(mats, fv, sigmas, plan=plan, ir=3, device=CPU)
    first = c.counters()[UPLOAD]
    form = plan.on_device(torch.device(CPU))
    weights = len(sigmas) * len(fv) * 16
    # the union data's nonzeros and their places, the scatter maps, and the
    # weights; never a dense operand (the halves alone are larger)
    assert first == form.nbytes + weights
    assert first < 2 * len(sigmas) * 2 * plan.n * form.R * 8
    with trace.collect() as c:
        BatchedShiftSMW(mats, fv, sigmas[:2], plan=plan, ir=3, device=CPU)
    assert c.counters()[UPLOAD] == 2 * len(fv) * 16
    assert plan.on_device(torch.device(CPU)) is form


def test_host_refinement_builds_no_device_form():
    """``backend="auto"`` takes the host at a small gun-like problem: its
    plan is built, but no batch asks for its device form."""
    mats, fv, sigmas = _problem("gun_band")
    plan = ShiftPlan(mats, fv)
    n = plan.n
    rng = np.random.default_rng(3)
    Q = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    with trace.collect() as c:
        trefine.newton_refine(mats, fv, sigmas, Q, nsweeps=1, plan=plan,
                              backend="auto", device=CPU)
    assert UPLOAD not in c.counters()
    assert c.counters()["nt.refine.factorizations"] == len(sigmas)
    assert plan._on_device == {}
    with trace.collect() as c:
        trefine.newton_refine(mats, fv, sigmas, Q, nsweeps=1, plan=plan,
                              backend="chip", device=CPU)
    assert c.counters()[UPLOAD] > 0 and len(plan._on_device) == 1
