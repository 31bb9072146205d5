"""Gallery registry: ``nep_gallery(name, *params, device=..., **kwargs)``."""
from __future__ import annotations

from .nlevp import gun_like
from .waveguide import wep_gallery

__all__ = ["nep_gallery", "GALLERY"]

GALLERY = {
    "gun_like": gun_like,
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
