"""The solvers: the complex-as-real scans and their refinement, the
protocol solvers (Krylov, Newton, projection and deflation families).

The Krylov variants and the dense Newton solvers of this package are
exported here under their module's name (``from neptpu_torch.solvers import
ilan`` is the function); the other solvers are reached through their
modules or the top-level package."""
from .blocknewton import blocknewton
from .broyden import broyden
from .iar_chebyshev import iar_chebyshev
from .ilan import ilan
from .infbilanczos import infbilanczos
from .spmf_real import iar_real_spmf_deflated

__all__ = ["blocknewton", "broyden", "iar_chebyshev", "ilan", "infbilanczos",
           "iar_real_spmf_deflated"]
