"""Problem transformations: ``shift_and_scale`` and ``mobius_transform``
(type-preserving for DEP, PEP and SPMF problems), ``taylor_expansion_pep``,
and the CORK pencils (``cork.py``)."""
from .cork import (CORKPencil, CORKPencilLR, CorkLinearization,
                   DefaultCorkLinearization, IarCorkLinearization,
                   NleigsCorkLinearization, build_pencil, low_rank_compress)
from .shift_scale import (MobiusTransformedNEP, ShiftScaledNEP,
                          mobius_transform, shift_and_scale,
                          taylor_expansion_pep)

__all__ = [
    "shift_and_scale",
    "mobius_transform",
    "taylor_expansion_pep",
    "ShiftScaledNEP",
    "MobiusTransformedNEP",
    "CORKPencil",
    "CORKPencilLR",
    "build_pencil",
    "low_rank_compress",
    "CorkLinearization",
    "DefaultCorkLinearization",
    "IarCorkLinearization",
    "NleigsCorkLinearization",
]
