"""Gallery registry: ``nep_gallery(name, *params, device=..., **kwargs)``."""
from __future__ import annotations

from . import basic, examples
from .bem import bem_fichera
from .chebdiff import orr_sommerfeld
from .distributed import dep_distributed
from .dtn_dimer import load_dtn_dimer
from .lowrank_sum import schrodinger_movebc
from .nlevp import (gun_like, nlevp_native_cd_player, nlevp_native_fiber,
                    nlevp_native_gun, nlevp_native_hadeler,
                    nlevp_native_loaded_string, nlevp_native_pdde_stability)
from .periodic_dde import periodic_dde_gallery
from .waveguide import wep_gallery

__all__ = ["nep_gallery", "GALLERY", "register"]

GALLERY = {
    "dep0": basic.dep0,
    "dep0_sparse": basic.dep0_sparse,
    "dep0_tridiag": basic.dep0_tridiag,
    "pep0": basic.pep0,
    "pep0_sym": basic.pep0_sym,
    "pep0_sparse": basic.pep0_sparse,
    "qep_fixed_eig": basic.qep_fixed_eig,
    "dep1": examples.dep1,
    "dep_symm_double": examples.dep_symm_double,
    "dep_double": examples.dep_double,
    "real_quadratic": examples.real_quadratic,
    "qdep0": examples.qdep0,
    "qdep1": examples.qdep1,
    "neuron0": examples.neuron0,
    "beam": examples.beam,
    "sine": examples.sine_nep,
    "dep_distributed": dep_distributed,
    "schrodinger_movebc": schrodinger_movebc,
    "nlevp_native_gun": nlevp_native_gun,
    "gun_like": gun_like,
    "nlevp_native_cd_player": nlevp_native_cd_player,
    "nlevp_native_fiber": nlevp_native_fiber,
    "nlevp_native_hadeler": nlevp_native_hadeler,
    "nlevp_native_pdde_stability": nlevp_native_pdde_stability,
    "nlevp_native_loaded_string": nlevp_native_loaded_string,
    "waveguide": wep_gallery,
    "periodicdde": periodic_dde_gallery,
    "bem_fichera": bem_fichera,
    "dtn_dimer": load_dtn_dimer,
    "orr_sommerfeld": orr_sommerfeld,
}


def register(name, fn):
    """Add (or replace) a gallery entry."""
    GALLERY[name] = fn


def nep_gallery(problem, *params, **kwargs):
    """Look up and construct a gallery problem; remaining arguments (such as
    ``device=``; default: the card) are forwarded to its constructor, so
    ``nep_gallery("periodicdde", name="mathieu")`` works."""
    if problem not in GALLERY:
        raise ValueError(
            f"unknown gallery problem '{problem}'; available: "
            f"{sorted(GALLERY)}")
    return GALLERY[problem](*params, **kwargs)
