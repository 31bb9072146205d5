"""neptpu_torch — the PyTorch/CUDA port of neptpu's main eigensolver path.

A second package beside the JAX reference ``neptpu``: the gun-class SPMF
(host-built problem -> mixed term bank -> partitioned SPIKE + SMW shifted
factorization -> complex-as-real IAR scan -> host Newton refinement), with
the stacked-DIA fused multi-term SpMV as a hand-written sm_90a CUDA kernel
(``csrc/dia_spmv.cu``).  It imports torch, numpy and scipy — never jax or
neptpu.  Entry points take an explicit ``device=``.
"""
from . import config  # noqa: F401  (switches TF32 off)
from .core.nep import (NEP, compute_Mder, compute_Mlincomb, compute_MM,
                       compute_resnorm)
from .models.gallery import nep_gallery
from .models.pep import PEP
from .models.spmf import AbstractSPMF, SPMF_NEP
from .models.sumnep import GenericSumNEP, SPMFSumNEP, SumNEP
from .ops import matfun
from .solvers.refine import newton_refine
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
    "iar_real_spmf",
    "iar_real_spmf_multishift",
]
