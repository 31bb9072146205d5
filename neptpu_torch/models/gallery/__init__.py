"""Gallery registry: ``nep_gallery(name, *params, device=..., **kwargs)``."""
from __future__ import annotations

from . import basic, examples
from .distributed import dep_distributed
from .nlevp import gun_like, nlevp_native_loaded_string
from .waveguide import wep_gallery

__all__ = ["nep_gallery", "GALLERY"]

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
    "dep_distributed": dep_distributed,
    "gun_like": gun_like,
    "nlevp_native_loaded_string": nlevp_native_loaded_string,
    "waveguide": wep_gallery,
}


def nep_gallery(problem, *params, **kwargs):
    """Look up and construct a gallery problem; remaining arguments (such as
    ``device=``; default: the card) are forwarded to its constructor."""
    if problem not in GALLERY:
        raise ValueError(
            f"unknown gallery problem '{problem}'; available: "
            f"{sorted(GALLERY)}")
    return GALLERY[problem](*params, **kwargs)
