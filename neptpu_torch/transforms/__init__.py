"""Problem transformations: ``shift_and_scale`` and ``mobius_transform``
(type-preserving for DEP, PEP and SPMF problems) and
``taylor_expansion_pep``."""
from .shift_scale import (MobiusTransformedNEP, ShiftScaledNEP,
                          mobius_transform, shift_and_scale,
                          taylor_expansion_pep)

__all__ = [
    "shift_and_scale",
    "mobius_transform",
    "taylor_expansion_pep",
    "ShiftScaledNEP",
    "MobiusTransformedNEP",
]
