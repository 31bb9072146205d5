"""The port stands alone: importing it loads neither JAX nor the JAX package
(the card's machine has no JAX)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import neptpu_torch
import neptpu_torch.interop
import neptpu_torch.ops.dia_kernel
import neptpu_torch.solvers.refine
import neptpu_torch.models.gallery.waveguide
import neptpu_torch.ops.partitioned
from neptpu_torch.solvers.refine import newton_refine, resinv_refine
from neptpu_torch.ops.partitioned import BatchedShiftSMW
import neptpu_torch.core.errmeasure, neptpu_torch.core.exceptions
import neptpu_torch.core.logger, neptpu_torch.ops.lapack
import neptpu_torch.ops.orth, neptpu_torch.ops.linsolve
import neptpu_torch.solvers.common, neptpu_torch.solvers.iar
import neptpu_torch.solvers.tiar, neptpu_torch.solvers.rf
import neptpu_torch.solvers.newton, neptpu_torch.solvers.iar_real
import neptpu_torch.solvers.tiar_real, neptpu_torch.models.dep
import neptpu_torch.models.gallery.msws, neptpu_torch.models.gallery.basic
import neptpu_torch.models.gallery.examples
import neptpu_torch.models.deflation, neptpu_torch.models.projection
import neptpu_torch.models.lowrank, neptpu_torch.models.cheb
import neptpu_torch.ops.eigsolve, neptpu_torch.solvers.inner
import neptpu_torch.solvers.jd, neptpu_torch.solvers.nlar
import neptpu_torch.solvers.companion, neptpu_torch.solvers.mslp
import neptpu_torch.solvers.sgiter, neptpu_torch.solvers.rfi
import neptpu_torch.transforms, neptpu_torch.transforms.shift_scale
import neptpu_torch.models.derspmf, neptpu_torch.models.helpers
import neptpu_torch.solvers.iar_chebyshev, neptpu_torch.solvers.ilan
import neptpu_torch.solvers.infbilanczos, neptpu_torch.solvers.blocknewton
import neptpu_torch.solvers.broyden
dep = neptpu_torch.nep_gallery('dep0_tridiag', 40, device='cpu')
neptpu_torch.iar_real(dep, sigma=-0.2, maxit=8, neigs=1, device='cpu')
neptpu_torch.tiar_real(dep, sigma=-0.2, maxit=8, neigs=1, device='cpu')
neptpu_torch.resinv(neptpu_torch.nep_gallery('dep0', device='cpu'),
                    lam=-0.5, device='cpu')
neptpu_torch.jd_effenberger(neptpu_torch.nep_gallery('dep0', device='cpu'),
                            neigs=1, maxit=5, lam=-0.5, v=[1.0] * 5,
                            tol=1e-8, device='cpu')
neptpu_torch.nlar(neptpu_torch.nep_gallery('pep0', 40, device='cpu'),
                  neigs=2, maxit=40, v=[1.0] * 40, num_restart_ritz_vecs=2,
                  tol=1e-9, device='cpu')
neptpu_torch.iar(dep, sigma=-0.2, maxit=20, neigs=1, proj_solve=True,
                 check_error_every=5, device='cpu')
import numpy as np, torch
nx = 12
from neptpu_torch.models.gallery.nlevp import _gun_from_matrices
import scipy.sparse as sp
L1 = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)], [-1, 0, 1])
K = ((sp.kron(L1, sp.eye(nx)) + sp.kron(sp.eye(nx), L1)) * 169).tocsr()
M = sp.eye(nx * nx, format='csr')
W = sp.csr_matrix(([1.0, 0.5], ([3, 7], [7, 3])), shape=(144, 144))
neptpu_torch.iar_real_spmf_deflated(
    _gun_from_matrices(K, M, W, W.T.tocsr(), device='cpu'),
    sigma=300.0 + 5j, gamma=150.0, maxit=6, neigs=2, restarts=2,
    dtype=torch.float64, device='cpu')
neptpu_torch.iar_chebyshev(neptpu_torch.nep_gallery('dep0', device='cpu'),
                           neigs=1, maxit=10, v=[1.0] * 5, tol=1e-8,
                           device='cpu')
import neptpu_torch.solvers.nleigs, neptpu_torch.solvers.aaa
import neptpu_torch.solvers.contour, neptpu_torch.solvers.rk
import neptpu_torch.transforms.cork, neptpu_torch.models.gallery.distributed
pep = neptpu_torch.PEP([np.array([[1.0, 3], [5, 6]]),
                        np.array([[3.0, 4], [6, 6]]), np.eye(2)], device='cpu')
neptpu_torch.nleigs(pep, [-10 - 2j, 10 - 2j, 10 + 2j, -10 + 2j], maxit=10,
                    v=np.ones(2) + 0j, blksize=5, device='cpu')
neptpu_torch.AAAeigs(
    neptpu_torch.nep_gallery('nlevp_native_loaded_string', device='cpu'),
    np.linspace(0.01, 50, 200) + 0j, neigs=2, shifts=[4.0 + 0j], maxit=20,
    check_error_every=5, device='cpu')
dd = neptpu_torch.nep_gallery('dep_distributed', device='cpu')
neptpu_torch.contour_beyn(dd, radius=1.5, neigs=2, N=32, k=3,
                          sanity_check=False, device='cpu')
neptpu_torch.contour_block_SS(dd, radius=1.5, k=2, K=2, N=32, device='cpu')
neptpu_torch.build_pencil(neptpu_torch.CORKPencil.from_nep(
    pep, neptpu_torch.IarCorkLinearization(d=4)), device='cpu')
for mod in (neptpu_torch, neptpu_torch.solvers, neptpu_torch.transforms,
            neptpu_torch.solvers.rk):
    for name in mod.__all__:
        getattr(mod, name)
nep = neptpu_torch.nep_gallery('waveguide', nx=5, nz=3, neptype='SPMF',
                               device='cpu')
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'neptpu'))
print(','.join(bad))
"""


def test_import_loads_no_jax_and_no_neptpu():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_every_module_of_the_port_imports_alone():
    """Each module under ``neptpu_torch`` imports in a fresh interpreter's
    module table without JAX or the JAX package appearing."""
    pkg = os.path.join(REPO, "neptpu_torch")
    mods = []
    for root, _, names in os.walk(pkg):
        for f in sorted(names):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    assert len(mods) >= 48 and "neptpu_torch.transforms.shift_scale" in mods
    probe = ("import importlib, sys\n"
             f"for m in {mods!r}:\n    importlib.import_module(m)\n"
             "print(','.join(sorted(m for m in sys.modules if "
             "m.split('.')[0] in ('jax', 'jaxlib', 'neptpu'))))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_sources_never_import_jax_or_neptpu():
    pkg = os.path.join(REPO, "neptpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    for path in files:
        with open(path) as fh:
            for line in fh:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0].rstrip(",")
                    assert top not in ("jax", "jaxlib", "neptpu"), (path, line)
