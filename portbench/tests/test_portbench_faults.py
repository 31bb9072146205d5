"""``correct`` comes out false when the timed path is broken underneath,
once for each fault the cells can have, and under the control: the harness
drives a whole run on the CPU (its look for a card skipped) at a size a
test holds.  The cells have no batch mean and no exchange between chips;
the refinement's batch of pairs stands for the batch.  In the refined cell
the refinement repairs an eigenvalue the scan altered, so there the answer
is altered where the refinement produces it."""
import numpy as np
import pytest
import torch

import neptpu_torch
import tiny
from neptpu_torch.solvers import iar_real, spmf_real
from portbench.harness import run_cell


@pytest.fixture
def root(tmp_path):
    return tiny.checkout(tmp_path)


def run(root, cell, **kw):
    rc, res = run_cell(root, cell, 17, 0.2, 0, device="cpu", **kw)
    assert rc == 0
    return res


@pytest.mark.parametrize("cell", tiny.TINY)
def test_sound_run_is_correct(root, cell):
    res = run(root, cell)
    assert res["correct"] and res["failed"] == 0


@pytest.mark.parametrize("cell", tiny.TINY)
def test_step_that_returns_its_state_unchanged(root, cell, monkeypatch):
    def frozen_step_fn(*args, **kwargs):
        def step(carry, k):
            return torch.ones((), dtype=carry[0].dtype,
                              device=carry[0].device)
        return step

    monkeypatch.setattr(iar_real, "_step_fn", frozen_step_fn)
    res = run(root, cell)
    assert not res["correct"]
    assert res["checks"]["short_share"]["value"] == 1.0


def test_answer_altered_where_the_scan_produces_it(root, monkeypatch):
    real = iar_real.run_iar_real

    def altered(*args, **kwargs):
        lams, Q, info = real(*args, **kwargs)
        return lams * (1 + 1e-3), Q, info

    monkeypatch.setattr(iar_real, "run_iar_real", altered)
    monkeypatch.setattr(spmf_real, "run_iar_real", altered)
    res = run(root, "tiny.ritz")
    assert not res["correct"]
    assert res["checks"]["backward_max"]["value"] > \
        res["checks"]["backward_max"]["limit"] or \
        res["checks"]["short_share"]["value"] == 1.0


def test_answer_altered_where_the_refinement_produces_it(root, monkeypatch):
    real = neptpu_torch.newton_refine

    def altered(*args, **kwargs):
        lams, Q, errs = real(*args, **kwargs)
        return lams * (1 + 1e-3), Q, errs

    monkeypatch.setattr(neptpu_torch, "newton_refine", altered)
    res = run(root, "tiny.refined")
    assert not res["correct"]
    assert res["checks"]["backward_max"]["value"] > 1e-9


def test_half_of_the_refinement_batch_left_out(root, monkeypatch):
    real = neptpu_torch.newton_refine

    def half(mats, fv, lams, Q, **kwargs):
        h = len(lams) // 2
        lr, Qr, er = real(mats, fv, lams[:h], Q[:, :h], **kwargs)
        rest = kwargs["errmeasure"].batch(lams[h:], Q[:, h:])
        return (np.concatenate([lr, lams[h:]]), np.hstack([Qr, Q[:, h:]]),
                np.concatenate([er, rest]))

    monkeypatch.setattr(neptpu_torch, "newton_refine", half)
    res = run(root, "tiny.refined")
    assert not res["correct"]
    assert res["checks"]["short_share"]["value"] == 1.0


@pytest.mark.parametrize("cell", tiny.TINY)
def test_control_shifted_solver_in_bfloat16(root, cell):
    res = run(root, cell, control="bf16_factor")
    assert not res["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.TINY)
def test_control_on_the_card(root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernel B1 has no CPU "
                    "mode")
    from portbench.harness import run_cell as run_on

    for control, correct in ((None, True), ("bf16_factor", False)):
        rc, res = run_on(root, cell, 17, 0.5, 0, device="cuda",
                         control=control)
        assert rc == 0 and res["correct"] is correct
