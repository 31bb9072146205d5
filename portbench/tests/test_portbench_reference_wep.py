"""The waveguide's plain reference builds the same problem as the port's
gallery: the same M(lam) x at a few points, and the same term matrices.  The
test may import the port; the reference may not."""
import numpy as np
import pytest
import scipy.sparse as sp

from portbench.tests.test_portbench_reference import (REPO, apply, config,
                                                      port_terms, reference)


@pytest.mark.parametrize("override, lams", [
    ({}, [-3.0 - 3.5j]),
    ({"nx": 21, "nz": 11, "n": 253,
      "gallery_args": [21, 11, "JARLEBRING", "SPMF"]},
     [-3.0 - 3.5j, 0.7 + 2.2j, -1.5 - 0.4j]),
])
def test_wep_reference_is_the_gallery_problem(override, lams):
    cfg = config("wep", **override)
    ref = reference("wep").build(cfg, REPO)
    mats, fvals = port_terms(cfg)
    assert ref.n == mats[0].shape[0] == cfg["n"]
    assert len(ref.mats) == len(mats) == 3 + 2 * cfg["gallery_args"][1]
    x = np.random.default_rng(0).standard_normal(ref.n) + 0j
    for lam in lams:
        ours = apply(ref.mats, ref.weights(np.array([lam]))[:, 0], x)
        theirs = apply(mats, fvals(lam), x)
        assert np.linalg.norm(ours - theirs) <= 1e-13 * np.linalg.norm(theirs)
    # the three polynomial terms are the same matrices
    for A, B in zip(ref.mats[:3], mats[:3]):
        assert abs(A - sp.csr_matrix(B)).max() <= 1e-12 * abs(A).max()
