"""The solvers: the complex-as-real scans and their refinement, the
protocol solvers (Krylov, Newton, projection and deflation families).

The Krylov variants, the dense Newton solvers, the rational family
(NLEIGS, AAAeigs, the contour methods) and the complex-dtype scans of this
package are
exported here under their module's name (``from neptpu_torch.solvers import
ilan`` is the function); the other solvers are reached through their
modules or the top-level package."""
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
           "iar_scan_kernel", "tiar_jitted", "tiar_jitted_spmf"]
