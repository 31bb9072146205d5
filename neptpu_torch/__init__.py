"""neptpu_torch — the PyTorch/CUDA port of neptpu's main eigensolver path.

A second package beside the JAX reference ``neptpu``: the gun-class and
waveguide SPMFs (host-built problem -> mixed term bank -> partitioned
SPIKE + SMW shifted factorization -> complex-as-real IAR scan from one shift
or several -> Newton refinement on the host or, batched over shifts, on the
device), with the stacked-DIA fused multi-term SpMV as hand-written sm_90a
CUDA kernels (``csrc/dia_spmv.cu``: one operand, or a re/im pair in one
launch).  It imports torch, numpy and scipy — never jax or neptpu.  Entry
points run on the card unless the caller passes ``device="cpu"``
(``config.default_device``).
"""
from . import config  # noqa: F401  (switches TF32 off)
from .core.nep import (NEP, compute_Mder, compute_Mlincomb, compute_MM,
                       compute_resnorm)
from .models.gallery import nep_gallery
from .models.pep import PEP
from .models.spmf import AbstractSPMF, SPMF_NEP
from .models.sumnep import GenericSumNEP, SPMFSumNEP, SumNEP
from .ops import matfun
from .solvers.refine import newton_refine, resinv_refine
from .solvers.spmf_real import iar_real_spmf, iar_real_spmf_multishift

__all__ = [
    "NEP",
    "compute_Mder",
    "compute_Mlincomb",
    "compute_MM",
    "compute_resnorm",
    "nep_gallery",
    "PEP",
    "AbstractSPMF",
    "SPMF_NEP",
    "GenericSumNEP",
    "SPMFSumNEP",
    "SumNEP",
    "matfun",
    "newton_refine",
    "resinv_refine",
    "iar_real_spmf",
    "iar_real_spmf_multishift",
]
