"""The solvers: the complex-as-real scans and their refinement, the
protocol solvers (Krylov, Newton, projection and deflation families).

Every name of the JAX package's ``neptpu.solvers`` is here.  Where a solver
function and its module share a name (``iar``, ``tiar``, ``iar_real``,
``mslp``, ``rfi``, ``sgiter``, ``nlar``, ``companion``...) the name is the
module, as the port's tests import it (``from neptpu_torch.solvers import
iar_real`` is the module); the function is the module's attribute and the
top-level package's (``neptpu_torch.iar_real``)."""
from .aaa import AAAeigs, get_prz, svAAA
from .blocknewton import blocknewton
from .broyden import broyden
from .contour import (MatrixGaussLegendre, MatrixIntegrator,
                      MatrixTrapezoidal, batched_shifted_solves, contour_beyn,
                      contour_block_SS, integrate_interval)
from .iar_chebyshev import iar_chebyshev
from .iar_jit import iar_jitted, iar_scan_kernel
from .ilan import ilan
from .infbilanczos import infbilanczos
from .nleigs import NleigsSolutionDetails, nleigs
from .spmf_real import iar_real_spmf_deflated
from .tiar_jit import tiar_jitted, tiar_jitted_spmf
__all__ = ["blocknewton", "broyden", "iar_chebyshev", "ilan", "infbilanczos",
           "iar_real_spmf_deflated", "nleigs", "NleigsSolutionDetails",
           "AAAeigs", "svAAA", "get_prz", "contour_beyn", "contour_block_SS",
           "MatrixIntegrator", "MatrixTrapezoidal", "MatrixGaussLegendre",
           "integrate_interval", "batched_shifted_solves", "iar_jitted",
           "iar_scan_kernel", "tiar_jitted", "tiar_jitted_spmf",
           "NoConvergenceException", "closest_to", "polyeig",
           "dep_shift_block_lu", "iar_real_scan", "ContourBeynInnerSolver",
           "DefaultInnerSolver", "IARChebInnerSolver", "IARInnerSolver",
           "InnerSolver", "NewtonInnerSolver", "NleigsInnerSolver",
           "PolyeigInnerSolver", "SGIterInnerSolver", "inner_solve",
           "jd_betcke", "jd_effenberger", "augnewton", "implicitdet",
           "newtonqr", "quasinewton", "resinv", "default_eigval_sorter",
           "residual_eigval_sorter", "threshold_eigval_sorter",
           "newton_refine", "resinv_refine", "compute_rf", "rfi_b",
           "iar_real_spmf", "iar_real_spmf_multishift"]

# the rest of the JAX package's names, loaded at first use: their modules
# import the models, and the models import ``solvers.common``
_LAZY = {
    "common": ("NoConvergenceException", "closest_to"),
    "companion": ("polyeig",),
    "iar_real": ("dep_shift_block_lu", "iar_real_scan"),
    "inner": ("ContourBeynInnerSolver", "DefaultInnerSolver",
              "IARChebInnerSolver", "IARInnerSolver", "InnerSolver",
              "NewtonInnerSolver", "NleigsInnerSolver", "PolyeigInnerSolver",
              "SGIterInnerSolver", "inner_solve"),
    "jd": ("jd_betcke", "jd_effenberger"),
    "newton": ("augnewton", "implicitdet", "newtonqr", "quasinewton",
               "resinv"),
    "nlar": ("default_eigval_sorter", "residual_eigval_sorter",
             "threshold_eigval_sorter"),
    "refine": ("newton_refine", "resinv_refine"),
    "rf": ("compute_rf",),
    "rfi": ("rfi_b",),
    "spmf_real": ("iar_real_spmf", "iar_real_spmf_multishift"),
}
_LAZY_MODULE = {name: mod for mod, names in _LAZY.items() for name in names}


def __getattr__(name):
    mod = _LAZY_MODULE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(f".{mod}", __name__), name)
