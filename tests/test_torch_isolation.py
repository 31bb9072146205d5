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
