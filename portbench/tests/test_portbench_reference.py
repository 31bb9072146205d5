"""The plain references build the same problems as the port's gallery: the
same term matrices, and the same M(lam) x at a few points.  The test may
import the port; the references may not."""
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp

from portbench.harness import load_module

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BASE)


def config(name, **override):
    with open(os.path.join(BASE, "configs", f"{name}.json")) as fh:
        return dict(json.load(fh), **override)


def reference(name):
    return load_module(os.path.join(BASE, "reference", f"{name}.py"),
                       "reference")


def port_terms(cfg):
    import neptpu_torch as nt
    from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                                spmf_fun_scalars)

    nep = nt.nep_gallery(cfg["gallery"], *cfg["gallery_args"], device="cpu")
    mats, fv = collect_spmf_terms(nep)
    return mats, lambda lam: spmf_fun_scalars(fv, lam)


def apply(mats, w, x):
    return sum(wi * (A @ x) for wi, A in zip(w, mats))


@pytest.mark.parametrize("name, override, lams", [
    ("gun_like", {}, [2e4 + 100j, 1.5e4 + 3j, 11854.0 - 2j]),
    ("dep_symm_double", {}, [-1.0, -0.7 + 0.4j]),
    ("dep_symm_double", {"grid": 12, "gallery_args": [12], "n": 144},
     [-1.3 + 0.1j]),
])
def test_reference_is_the_gallery_problem(name, override, lams):
    cfg = config(name, **override)
    ref = reference(name).build(cfg, REPO)
    mats, fvals = port_terms(cfg)
    assert ref.n == mats[0].shape[0] == cfg["n"]
    x = np.random.default_rng(0).standard_normal(ref.n) + 0j
    for lam in lams:
        ours = apply(ref.mats, ref.weights(np.array([lam]))[:, 0], x)
        theirs = apply(mats, fvals(lam), x)
        assert np.linalg.norm(ours - theirs) <= 1e-13 * np.linalg.norm(theirs)
    # the same matrices, term by term, up to the sign the port's PEP gives M
    signs = [1, -1, 1, 1] if name == "gun_like" else [1, 1, 1]
    for s, A, B in zip(signs, ref.mats, mats):
        assert abs(s * A - sp.csr_matrix(B)).max() <= 1e-12 * abs(A).max()


def test_backward_error_is_scale_free_and_vector_normalised():
    ref = reference("dep_symm_double").build(config(
        "dep_symm_double", grid=12), REPO)
    rng = np.random.default_rng(1)
    Q = rng.standard_normal((ref.n, 3)) + 1j * rng.standard_normal((ref.n, 3))
    lams = np.array([-1.0, -0.5 + 0.2j, 0.3j])
    e = ref.backward(lams, Q)
    assert np.allclose(ref.backward(lams, 7.0 * Q), e, rtol=1e-14)
    assert np.allclose([ref.backward(lams[j:j + 1], Q[:, j:j + 1])[0]
                        for j in range(3)], e, rtol=1e-14)
