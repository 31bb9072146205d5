"""The generator's shift sequence: a function of the traffic file and the
seed alone; every seed sweeps the same grid, in another order."""
import itertools
import json
import os

import pytest

from portbench.traffic import grid, shift_stream, warmup_shift

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "traffic")
MIXES = ["gun_sweep_refined", "gun_sweep_ritz", "dep_sweep_ritz"]


def load(name):
    with open(os.path.join(TRAFFIC, f"{name}.json")) as fh:
        return json.load(fh)


def take(traffic, seed, n):
    return list(itertools.islice(shift_stream(traffic, seed), n))


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, -5])
def test_sequence_repeats_for_a_seed(mix, seed):
    t = load(mix)
    assert take(t, seed, 70) == take(t, seed, 70)
    assert take(t, seed, 70) != take(t, seed + 1, 70)


@pytest.mark.parametrize("mix", MIXES)
def test_every_block_sweeps_the_same_grid(mix):
    t = load(mix)
    lo, hi = t["shift"]["real"]
    pts = grid(t)
    n = t["shift"]["points"]
    assert len(set(pts)) == n
    assert all(lo < z.real < hi and z.imag == t["shift"]["imag"] for z in pts)
    for seed in (3, 2**31 + 5):
        s = take(t, seed, 3 * n)
        for b in range(3):
            assert sorted(s[b * n:(b + 1) * n], key=abs) == \
                sorted(pts, key=abs)


def test_warmup_is_the_middle_of_the_band_and_not_on_the_grid():
    t = load("gun_sweep_ritz")
    assert warmup_shift(t) == complex(20000.0, 100.0)
    assert warmup_shift(t) not in grid(t)
