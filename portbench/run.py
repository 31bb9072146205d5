"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  The last line of standard output is the result as one JSON
object; the numbers that decide ``correct`` follow it as the last lines of
standard error.  ``--control bf16_factor`` runs the program with the scan's
shifted solver built from M(sigma) rounded to bfloat16, the precision below
the configuration's float32, for the readings of the correctness control;
``--control rounded_mder`` does the same for a problem reached only through
``Mder`` (the kind ``protocol``), with every matrix it returns rounded
through the precision below its own; no cell's runs use either.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_age():
    """Seconds since this process started, from ``/proc`` (0 elsewhere)."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def cache_dirs(root):
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(root, ".portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def one_thread():
    """One host thread for the numerical libraries, unless the environment
    says otherwise: the load comes from one process, steadily."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def main(argv=None):
    age = process_age()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)

    cache_dirs(ROOT)
    one_thread()
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    chips = {w["name"]: int(w["chips"]) for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        print(f"the cell needs {chips[args.workload]} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    from portbench.harness import run_cell

    rc, result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          args.trace, device="cuda", control=args.control,
                          process_age=age, t_start=T_START)
    if result is None:
        return rc or 1
    print(json.dumps(result), flush=True)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
