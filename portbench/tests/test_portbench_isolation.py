"""What a run loads: in a fresh process that loads the harness and every
module it reads by name and runs a cell through, no top-level module is
``jax``, ``jaxlib``, ``flax`` or the JAX package ``neptpu`` (the port,
``neptpu_torch``, is a different top-level name)."""
import json
import os
import subprocess
import sys

import tiny

SCRIPT = r"""
import glob, json, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
torch.set_num_threads(1)
import portbench.run
from portbench import harness
for folder in ("layers", "end_to_end", "reference"):
    for path in sorted(glob.glob(os.path.join(root, "portbench", folder, "*.py"))):
        if not os.path.basename(path).startswith("_"):
            harness.load_module(path, folder)
rc, result = harness.run_cell(root, "tiny.refined", 3, 0.2, 1, device="cpu")
print(json.dumps({"rc": rc, "correct": result["correct"],
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    root = tiny.checkout(tmp_path)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT, root],
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0 and got["correct"]
    assert "neptpu_torch" in got["top"] and "portbench" in got["top"]
    assert not set(got["top"]) & {"jax", "jaxlib", "flax", "neptpu"}


def test_the_harness_refuses_a_run_that_loaded_jax_package(tmp_path,
                                                            monkeypatch):
    from portbench import harness

    root = tiny.checkout(tmp_path)
    monkeypatch.setitem(sys.modules, "neptpu", type(sys)("neptpu"))
    rc, result = harness.run_cell(root, "tiny.ritz", 3, 0.1, 0, device="cpu")
    assert rc != 0 and result is None
