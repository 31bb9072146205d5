"""neptpu_torch — the PyTorch/CUDA port of neptpu.

A second package beside the JAX reference ``neptpu``, with the same module
paths and names:

* problems: ``PEP``, ``SPMF_NEP``, ``DEP``, sums, and the gallery (gun_like,
  wep, the delay and the random polynomial problems);
* the compute protocol (``compute_Mder``/``compute_Mlincomb``/``compute_MM``)
  whose hot operation, the fused multi-term apply of a banded term bank, is
  the stacked-DIA SpMV written by hand for sm_90a (``csrc/dia_spmv.cu``: one
  operand, or a re/im pair in one launch; float32, float64, bfloat16);
* the complex-as-real Krylov solvers in split re/im channels (``iar_real``,
  ``tiar_real`` for delay problems, ``iar_real_spmf``/``tiar_real_spmf`` and
  the multishift scan for SPMFs) with their shifted factorizations (dense
  block LU, partitioned SPIKE + SMW) and Newton refinement on the host or,
  batched over shifts, on the device;
* the protocol solvers (``iar``, ``tiar``, ``newton``, ``augnewton``,
  ``resinv``, ``quasinewton``, ``newtonqr``, ``implicitdet``, ``mslp``,
  ``sgiter``, ``rfi``, ``rfi_b``, ``polyeig``) with the linear-solver,
  linear-eigensolver, orthogonalization, error-measure and logger layers;
* deflation (``deflate_eigpair``: the padded original terms in their own
  storage plus low-rank factor terms) and projection (``create_proj_NEP``),
  the inner solvers on projected problems (``inner_solve``) and the
  projection solvers built on them (``jd_betcke``, ``jd_effenberger``,
  ``nlar``, and ``iar``/``tiar`` with ``proj_solve=True``);
* the restarted SPMF scan with Effenberger deflation inside the scan step
  (``iar_real_spmf_deflated``, ``DeflationOps``), the Krylov variants
  (``iar_chebyshev``, ``ilan``, ``infbilanczos``), the dense Newton solvers
  for invariant pairs (``blocknewton``, ``broyden``), the problem
  transformations (``shift_and_scale``, ``mobius_transform``,
  ``taylor_expansion_pep``), ``DerSPMF``, the function-handle problems and
  ``interpolate_pep``;
* the rational family: ``nleigs`` (rational Krylov on a dynamic Leja-Bagby
  linearization), ``AAAeigs`` and ``svAAA``, the CORK pencils, the contour
  methods ``contour_beyn`` and ``contour_block_SS`` on batched shifted
  solves, and the inner solvers built on them;
* the native waveguide ``WEP_FD`` (Sylvester-form Mlincomb, the Schur
  complement factored dense on the device or solved by GMRES with the
  FFT-Sylvester SMW preconditioner: ``WEPLinSolverCreator``,
  ``wep_generate_preconditioner``), the complex-dtype scans ``iar_jitted``,
  ``tiar_jitted`` and ``tiar_jitted_spmf``, the whole gallery (30 problems)
  and the utilities (sparse-matrix text files, the benchmark harness, the
  mpmath extended-precision Newton).

It imports torch, numpy and scipy — never jax or neptpu.  Entry points run on
the card unless the caller passes ``device="cpu"``
(``config.default_device``).
"""
import time as _time

_T_IMPORT = _time.perf_counter_ns()

from . import config  # noqa: F401  (switches TF32 off)
from .core.errmeasure import (DefaultErrmeasure, EigvalReferenceErrmeasure,
                              Errmeasure, ResidualErrmeasure,
                              StandardSPMFErrmeasure, estimate_error)
from .core import trace  # noqa: F401
from .core.exceptions import (LostOrthogonalityException,
                              NoConvergenceException)
from .core.logger import (ErrorLogger, Logger, PrintLogger, push_info,
                          push_iteration_info)
from .core.nep import (NEP, compute_Mder, compute_Mlincomb, compute_MM,
                       compute_resnorm)
from .core.nep import mder_from_mm as compute_Mder_from_MM
from .core.nep import mlincomb_from_mder as compute_Mlincomb_from_Mder
from .core.nep import mlincomb_from_mm as compute_Mlincomb_from_MM
from .models.cheb import ChebPEP
from .models.deflation import (DeflatedGenericNEP, DeflatedNEP,
                               DeflatedNEPMM, DeflatedSPMF, deflate_eigpair,
                               get_deflated_eigpairs)
from .models.dep import DEP
from .models.derspmf import DerSPMF
from .models.gallery import nep_gallery
from .models.gallery.distributed import (distributed_kernel_gauss_legendre,
                                         distributed_kernel_trapezoidal,
                                         gauss_legendre_weights)
from .models.gallery.waveguide import (WEP, WEP_FD, WEPLinSolverCreator,
                                       wep_gallery,
                                       wep_generate_preconditioner)
from .models.helpers import REP, Mder_Mlincomb_NEP, Mder_NEP
from .models.lowrank import LowRankFactorizedNEP, LowRankMatrixAndFunction
from .models.pep import PEP, interpolate_pep
from .models.projection import (Proj_NEP, Proj_SPMF_NEP, create_proj_NEP,
                                expand_projectmatrices, set_projectmatrices)
from .models.spmf import AbstractSPMF, SPMF_NEP
from .models.sumnep import GenericSumNEP, SPMFSumNEP, SumNEP
from .ops import matfun, sparse
from .ops.eigsolve import (ArnoldiEigSolver, DefaultEigSolver,
                           EigenEigSolver, EigSolver, eig_solve)
from .ops.linsolve import (BackslashLinSolver, BackslashLinSolverCreator,
                           DefaultLinSolverCreator, DeflatedNEPLinSolver,
                           DeflatedNEPLinSolverCreator, FactorizeLinSolver,
                           FactorizeLinSolverCreator, GMRESLinSolver,
                           GMRESLinSolverCreator, LinSolver, LinSolverCreator,
                           SparseFactorizeLinSolver,
                           SparseFactorizeLinSolverCreator, create_linsolver,
                           lin_solve)
from .ops.orth import (DGKS, ClassicalGS, ModifiedGS,
                       orthogonalize_and_normalize)
from .solvers.aaa import AAAeigs, svAAA
from .solvers.blocknewton import blocknewton
from .solvers.broyden import broyden
from .solvers.companion import companion, polyeig
from .solvers.contour import (MatrixGaussLegendre, MatrixIntegrator,
                              MatrixTrapezoidal, batched_shifted_solves,
                              contour_beyn, contour_block_SS,
                              integrate_interval)
from .solvers.iar import iar
from .solvers.iar_chebyshev import iar_chebyshev
from .solvers.iar_jit import iar_jitted
from .solvers.iar_real import (DeflationOps, dep_shift_block_lu, iar_real,
                               iar_real_scan)
from .solvers.ilan import ilan
from .solvers.infbilanczos import infbilanczos
from .solvers.inner import (ContourBeynInnerSolver, DefaultInnerSolver,
                            IARChebInnerSolver, IARInnerSolver, InnerSolver,
                            NewtonInnerSolver, NleigsInnerSolver,
                            PolyeigInnerSolver, SGIterInnerSolver,
                            inner_solve)
from .solvers.jd import jd_betcke, jd_effenberger
from .solvers.mslp import mslp
from .solvers.nleigs import NleigsSolutionDetails, nleigs
from .solvers.newton import (augnewton, implicitdet, newton, newtonqr,
                             quasinewton, resinv)
from .solvers.nlar import (default_eigval_sorter, nlar,
                           residual_eigval_sorter, threshold_eigval_sorter)
from .solvers.refine import newton_refine, resinv_refine
from .solvers.rf import compute_rf
from .solvers.rfi import rfi, rfi_b
from .solvers.rk import (LinSolverCache, discretizepolygon, inpolygon,
                         lejabagby, nleigs_coefficients, ratnewtoncoeffs,
                         ratnewtoncoeffsm, scgendivdiffs)
from .solvers.rk.rknep import RKNEP, get_rk_nep
from .solvers.sgiter import sgiter
from .solvers.spmf_real import (iar_real_spmf, iar_real_spmf_deflated,
                                iar_real_spmf_multishift)
from .solvers.tiar import tiar
from .solvers.tiar_jit import tiar_jitted, tiar_jitted_spmf
from .solvers.tiar_real import tiar_real, tiar_real_scan, tiar_real_spmf
from .transforms import (CORKPencil, CORKPencilLR, CorkLinearization,
                         DefaultCorkLinearization, IarCorkLinearization,
                         MobiusTransformedNEP, NleigsCorkLinearization,
                         ShiftScaledNEP, build_pencil, low_rank_compress,
                         mobius_transform, shift_and_scale,
                         taylor_expansion_pep)
from .utils.serialization import read_sparse_matrix, write_sparse_matrix

jd = jd_betcke
interpolate = interpolate_pep  # the reference's name
buildPencil = build_pencil
lowRankCompress = low_rank_compress


def get_Av(nep):
    """The SPMF term matrices of ``nep``."""
    return nep.get_Av()


def get_fv(nep):
    """The SPMF term functions of ``nep``."""
    return nep.get_fv()


__all__ = [
    "NEP",
    "compute_Mder",
    "compute_Mlincomb",
    "compute_MM",
    "compute_resnorm",
    "nep_gallery",
    "PEP",
    "DEP",
    "AbstractSPMF",
    "SPMF_NEP",
    "GenericSumNEP",
    "SPMFSumNEP",
    "SumNEP",
    "matfun",
    "Errmeasure",
    "ResidualErrmeasure",
    "StandardSPMFErrmeasure",
    "EigvalReferenceErrmeasure",
    "DefaultErrmeasure",
    "estimate_error",
    "NoConvergenceException",
    "LostOrthogonalityException",
    "Logger",
    "PrintLogger",
    "ErrorLogger",
    "push_info",
    "push_iteration_info",
    "LinSolver",
    "lin_solve",
    "FactorizeLinSolver",
    "SparseFactorizeLinSolver",
    "BackslashLinSolver",
    "GMRESLinSolver",
    "FactorizeLinSolverCreator",
    "SparseFactorizeLinSolverCreator",
    "BackslashLinSolverCreator",
    "GMRESLinSolverCreator",
    "DefaultLinSolverCreator",
    "create_linsolver",
    "DGKS",
    "ClassicalGS",
    "ModifiedGS",
    "orthogonalize_and_normalize",
    "iar",
    "tiar",
    "newton",
    "augnewton",
    "resinv",
    "quasinewton",
    "newtonqr",
    "implicitdet",
    "compute_rf",
    "iar_real",
    "iar_real_scan",
    "dep_shift_block_lu",
    "tiar_real",
    "tiar_real_scan",
    "tiar_real_spmf",
    "newton_refine",
    "resinv_refine",
    "iar_real_spmf",
    "iar_real_spmf_multishift",
    "LowRankFactorizedNEP",
    "LowRankMatrixAndFunction",
    "ChebPEP",
    "Proj_NEP",
    "Proj_SPMF_NEP",
    "create_proj_NEP",
    "set_projectmatrices",
    "expand_projectmatrices",
    "DeflatedNEP",
    "DeflatedNEPMM",
    "DeflatedGenericNEP",
    "DeflatedSPMF",
    "deflate_eigpair",
    "get_deflated_eigpairs",
    "LinSolverCreator",
    "DeflatedNEPLinSolver",
    "DeflatedNEPLinSolverCreator",
    "EigSolver",
    "EigenEigSolver",
    "ArnoldiEigSolver",
    "DefaultEigSolver",
    "eig_solve",
    "companion",
    "polyeig",
    "mslp",
    "sgiter",
    "rfi",
    "rfi_b",
    "InnerSolver",
    "DefaultInnerSolver",
    "NewtonInnerSolver",
    "PolyeigInnerSolver",
    "IARInnerSolver",
    "IARChebInnerSolver",
    "SGIterInnerSolver",
    "ContourBeynInnerSolver",
    "NleigsInnerSolver",
    "inner_solve",
    "nlar",
    "default_eigval_sorter",
    "residual_eigval_sorter",
    "threshold_eigval_sorter",
    "jd_betcke",
    "jd_effenberger",
    "jd",
    "compute_Mder_from_MM",
    "compute_Mlincomb_from_MM",
    "compute_Mlincomb_from_Mder",
    "get_Av",
    "get_fv",
    "wep_gallery",
    "WEP",
    "WEP_FD",
    "WEPLinSolverCreator",
    "wep_generate_preconditioner",
    "iar_jitted",
    "tiar_jitted",
    "tiar_jitted_spmf",
    "read_sparse_matrix",
    "write_sparse_matrix",
    "sparse",
    "DeflationOps",
    "iar_real_spmf_deflated",
    "DerSPMF",
    "Mder_NEP",
    "Mder_Mlincomb_NEP",
    "REP",
    "interpolate_pep",
    "interpolate",
    "shift_and_scale",
    "mobius_transform",
    "taylor_expansion_pep",
    "ShiftScaledNEP",
    "MobiusTransformedNEP",
    "iar_chebyshev",
    "ilan",
    "infbilanczos",
    "blocknewton",
    "broyden",
    "nleigs",
    "NleigsSolutionDetails",
    "AAAeigs",
    "svAAA",
    "contour_beyn",
    "contour_block_SS",
    "MatrixIntegrator",
    "MatrixTrapezoidal",
    "MatrixGaussLegendre",
    "integrate_interval",
    "batched_shifted_solves",
    "LinSolverCache",
    "discretizepolygon",
    "inpolygon",
    "lejabagby",
    "nleigs_coefficients",
    "ratnewtoncoeffs",
    "ratnewtoncoeffsm",
    "scgendivdiffs",
    "RKNEP",
    "get_rk_nep",
    "CORKPencil",
    "CORKPencilLR",
    "CorkLinearization",
    "DefaultCorkLinearization",
    "IarCorkLinearization",
    "NleigsCorkLinearization",
    "build_pencil",
    "buildPencil",
    "low_rank_compress",
    "lowRankCompress",
    "gauss_legendre_weights",
    "distributed_kernel_gauss_legendre",
    "distributed_kernel_trapezoidal",
]

trace._add_load("nt.load.import", _time.perf_counter_ns() - _T_IMPORT)
