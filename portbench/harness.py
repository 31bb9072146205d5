"""One run of one cell: set-up, the measured window of back-to-back solves,
the judgement of every answer against the plain reference, and the result.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file, ``traffic/<mix>.json``, ``reference/<config>.py``
(or the reference a configuration names), ``end_to_end/<metric>.py`` and
``layers/<metric>.py``.  A metric module's ``read(record)`` returns the
metric's value or None where the run gave it nothing to read.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import re
import sys
import tempfile
import time
from contextlib import nullcontext

import numpy as np

from . import measures, problems
from .traffic import shift_stream, warmup_shift

# the benchmark's folder in a checkout
FOLDER = "portbench"
# top-level modules the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "neptpu")
# a traced run profiles this many solves at the start of its window
TRACE_SOLVES = 3
# an idle gap shorter than this is counted with the others of its kind,
# not attributed to what the host was doing
SHORT_GAP_US = 20.0
# the entry contracts a traffic file may name under ``returns``
RETURNS = ("info", "pairs")


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, package):
    """The module at ``path`` as a submodule of ``portbench.<package>``."""
    name = os.path.splitext(os.path.basename(path))[0]
    full = f"portbench.{package}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if full in sys.modules:
        return sys.modules[full]
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


def applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic,
    reference and metrics, read from the checkout at ``root``."""

    def __init__(self, root, workload):
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; the cells are "
                             f"{sorted(cells)}")
        self.root = root
        self.base = os.path.join(root, FOLDER)
        self.name = workload
        self.cell = cells[workload]
        config = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        self.cfg = load_json(os.path.join(root, config["file"]))
        self.traffic = load_json(os.path.join(
            self.base, "traffic", f"{self.cell['traffic']}.json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if applies(m, workload)]
        self.per_layer = [m for m in bench["per_layer"]
                          if applies(m, workload)]
        self.reference_name = self.cfg.get("reference", config["name"])

    def reference(self):
        mod = load_module(os.path.join(
            self.base, "reference", f"{self.reference_name}.py"), "reference")
        return mod.build(self.cfg, self.root)

    def readers(self, trace):
        folder, metrics = (("layers", self.per_layer) if trace
                           else ("end_to_end", self.end_to_end))
        return [(m, load_module(os.path.join(self.base, folder,
                                             f"{m['name']}.py"), folder))
                for m in metrics]


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Solver:
    """One request of the traffic: a scan at a shift, then, where the
    traffic asks for it, clustering and Newton refinement.

    The traffic's ``returns`` names the entry's contract: ``"info"`` (the
    default), the scans' ``(lams, Q, info)`` under ``return_info=True``,
    whose ``info`` carries each pair's error and the scan's times; or
    ``"pairs"``, a solver that returns ``(lams, V)`` and nothing else.  A
    user of such a solver measures what it got: the request does so with the
    cell's errmeasure once the solve's time is taken, so that the latency
    holds the entry's own calls of the measure and not a second pass of
    it."""

    def __init__(self, torch, problem, traffic, err, device, control=None):
        import neptpu_torch as nt

        self.torch, self.nt = torch, nt
        self.problem, self.err, self.device = problem, err, device
        self.entry = getattr(nt, traffic["entry"])
        self.dtype = problem.dtype
        self.scan = dict(traffic["scan"])
        self.refine = traffic.get("refine")
        self.k = int(traffic["k"])
        self.tol = float((self.refine or self.scan)["tol"])
        self.control = control
        self.returns = traffic.get("returns", "info")
        if self.returns not in RETURNS:
            raise SystemExit(f"unknown entry contract {self.returns!r}; the "
                             f"contracts are {list(RETURNS)}")
        if self.refine and (self.returns == "pairs" or not problem.mats):
            raise SystemExit(
                "the traffic asks for refinement, which clusters by the "
                "scan's own errors and refines the problem's term matrices; "
                f"a {self.returns!r} entry on a {problem.kind} problem gives "
                "it " + ("no errors" if problem.mats else "no terms"))
        self.nep = (problems.rounded_mder(problem)
                    if control == "rounded_mder" else problem.nep)

    def __call__(self, sigma, annotate=False):
        """Solve at ``sigma``; returns ``(answer, record)``."""
        torch = self.torch
        span = (torch.profiler.record_function if annotate
                else lambda name: nullcontext())
        if sigma.imag == 0.0:
            sigma = sigma.real
        kw = dict(self.scan, **self.problem.entry_kwargs)
        if self.control == "bf16_factor":
            kw["lu_piv"] = problems.rounded_shift_solver(
                self.problem, sigma, self.dtype, self.device, torch.bfloat16)
        if self.returns == "info":
            kw["return_info"] = True
        t0 = time.perf_counter()
        with span("solve"):
            with span("scan"):
                out = self.entry(self.nep, sigma=sigma, dtype=self.dtype,
                                 errmeasure=self.err, device=self.device, **kw)
            if self.returns == "info":
                lams, Q, info = out
                lams = np.asarray(lams, dtype=complex)
                Q = np.asarray(Q)
                errs = np.asarray(info["errs"][: len(lams)], dtype=float)
            else:
                lams, Q = host_pairs(torch, *out)
                info = errs = None
            t_refine = None
            if self.refine:
                opts = dict(self.refine)
                keep = opts.pop("keep")
                reps = measures.cluster_candidates(lams, errs, keep=keep)
                t1 = time.perf_counter()
                with span("refine"):
                    lams, Q, errs = self.nt.newton_refine(
                        self.problem.mats, self.problem.fv, lams[reps],
                        Q[:, reps], errmeasure=self.err, dtype=self.dtype,
                        device=self.device, **opts)
                t_refine = time.perf_counter() - t1
            _sync(torch, self.device)
        latency = time.perf_counter() - t0
        if errs is None:
            errs = np.asarray(self.err.batch(lams, Q), dtype=float)
        distinct = len(measures.distinct_below_tol(lams, errs, self.tol))
        record = {"sigma": [float(np.real(sigma)), float(np.imag(sigma))],
                  "latency_s": latency,
                  "t_factorize": scan_info(info, "t_factorize", float),
                  "t_scan": scan_info(info, "t_scan", float),
                  "t_check": scan_info(info, "t_check", float),
                  "k_done": scan_info(info, "k_done", int),
                  "t_refine": t_refine, "returned": len(lams),
                  "distinct": distinct, "traced": bool(annotate)}
        return (lams, Q, errs), record


def host_pairs(torch, lams, V):
    """A ``"pairs"`` entry's answer on the host: the eigenvalues as a
    complex128 vector and the vectors as a complex128 ``(n, p)`` array."""
    if isinstance(V, torch.Tensor):
        V = V.detach().to("cpu", torch.complex128).resolve_conj().numpy()
    return np.asarray(lams, dtype=complex), np.asarray(V, dtype=complex)


def scan_info(info, key, kind):
    """``info[key]`` as ``kind``; None for an entry that returns no info."""
    return None if info is None else kind(info[key])


def judge(ref, answers, tol, k):
    """The numbers that may decide ``correct``, from the reference's own
    float64 backward error of every pair each solve returned:

    * ``backward_max``: the largest over the pairs a solve claims (its own
      error below ``tol``);
    * ``short_share``: the share of solves among whose pairs the reference
      finds fewer than ``k`` distinct ones below ``tol``;
    * ``floor_median``: the median over the solves that claim a pair of the
      smallest error among their claimed pairs, the accuracy the solve's
      arithmetic reaches (None where no solve claims one)."""
    worst, short, floors = 0.0, 0, []
    for lams, Q, errs in answers:
        e = ref.backward(lams, Q)
        e = np.where(np.isfinite(e), e, np.inf)
        claimed = errs < tol
        if claimed.any():
            worst = max(worst, float(e[claimed].max()))
            floors.append(float(e[claimed].min()))
        if len(measures.distinct_below_tol(lams, e, tol)) < k:
            short += 1
    return {"short_share": short / max(len(answers), 1),
            "backward_max": worst,
            "floor_median": float(np.median(floors)) if floors else None}


def passes(value, limit):
    return value is not None and value <= limit


def analyse_trace(events):
    """What a traced stretch of the window says: its length and device
    busy time (from the ``solve`` spans and the union of the device
    operations inside them), the device operations by total time, the idle
    gaps by what the host was doing (the shortest host event around each
    gap's middle), and the launches of kernel B1 with their times."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "solve"]
    if not spans:
        return None
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    dev = [e for e in measures.device_events(events)
           if e["ts"] >= lo and e["ts"] + e["dur"] <= hi]
    busy = measures.busy_intervals(dev)
    by_op = {}
    for e in dev:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e["dur"] * 1e-6
    host = [e for e in events if e.get("cat") in (
        "cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
        and "dur" in e]
    starts = np.array([e["ts"] for e in host], dtype=float)
    ends = starts + np.array([e["dur"] for e in host], dtype=float)
    gaps = {}
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SHORT_GAP_US:
            key = f"(gaps under {SHORT_GAP_US:g} us)"
        else:
            mid = 0.5 * (a + b)
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            key = (host[inside[np.argmin(ends[inside] - starts[inside])]]
                   ["name"] if inside.size else "(no host event)")
        gaps[key] = gaps.get(key, 0.0) + (b - a) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    top = [(_short(name), s) for name, s in top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "device_ops": [[name, s] for name, s in top],
            "idle_gaps": [[name, s] for name, s in idle],
            "b1": [(e["name"], e["dur"]) for e in dev
                   if re.search(r"\bdia_(lincomb|generic)", e["name"])],
            "n_device_ops": len(dev)}


def _short(name, width=160):
    """A kernel's name without its parameter list, at most ``width`` long."""
    if name.endswith(")") and "(" in name:
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i and name[i - 1] != " ":
                    name = name[:i]
                break
    return name[:width]


def _forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


# the controls of the correctness check: the scan's shifted solver built
# from M(sigma) rounded to bfloat16; every matrix a protocol problem's Mder
# returns rounded through the precision below its own
CONTROLS = ("bf16_factor", "rounded_mder")


def run_cell(root, workload, seed, seconds, trace, device="cuda",
             control=None, process_age=0.0, t_start=None, log=sys.stderr):
    """Run ``workload`` once; returns ``(exit code, result or None)``.
    ``process_age``: seconds the process had lived at ``t_start`` (a
    ``time.perf_counter()`` reading), so that ``setup_s`` counts from the
    process's start.  ``control``: run the program in the precision below
    the one the configuration states, for the control readings
    (``bf16_factor``: the scan's shifted solver built from M(sigma) rounded
    to bfloat16; ``rounded_mder``, for a protocol problem: every matrix its
    ``Mder`` returns rounded through the precision below its own); no cell's
    runs use it."""
    if t_start is None:
        t_start = time.perf_counter()

    def say(*args):
        print(*args, file=log, flush=True)

    cell = Cell(root, workload)
    traffic = cell.traffic
    import torch

    device = torch.device(device)
    if control not in (None,) + CONTROLS:
        raise SystemExit(f"unknown control {control!r}; the controls are "
                         f"{list(CONTROLS)}")
    if device.type == "cuda":
        from neptpu_torch.ops.dia_kernel import DIA_SPMV, build_kernel

        build_kernel()
        if DIA_SPMV.build_seconds is not None:
            say(f"kernel library built in {DIA_SPMV.build_seconds:.3f} s")
    _sync(torch, device)
    t0 = time.perf_counter()
    problem = problems.build(cell.cfg, device)
    _sync(torch, device)
    build_s = time.perf_counter() - t0
    ref = cell.reference()
    solver = Solver(torch, problem, traffic, measures.errmeasure(ref), device,
                    control=control)
    _, warm = solver(warmup_shift(traffic))
    setup_s = time.perf_counter() - t_start + process_age
    say(f"set-up {setup_s:.3f} s (problem and bank {build_s:.3f} s, "
        f"warm-up solve {warm['latency_s']:.3f} s at {warm['sigma']})")

    stream = shift_stream(traffic, seed)
    answers, solves = [], []
    prof = None
    if trace:  # started before the window: its start-up is not a solve's
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    t_w0 = time.perf_counter()
    t_end = t_w0
    while not solves or t_end - t_w0 < seconds:
        traced = bool(trace) and len(solves) < TRACE_SOLVES
        answer, rec = solver(next(stream), annotate=traced)
        t_end = time.perf_counter()
        if traced and len(solves) + 1 == TRACE_SOLVES:
            prof.stop()
        answers.append(answer)
        solves.append(rec)
        k_done = "-" if rec["k_done"] is None else rec["k_done"]
        say(f"solve {len(solves) - 1}: sigma {rec['sigma']}, "
            f"{rec['latency_s']:.4f} s, k_done {k_done}, "
            f"{rec['distinct']} distinct of {rec['returned']}"
            + (" (traced)" if traced else ""))
    if trace and len(solves) < TRACE_SOLVES:
        prof.stop()
    window = {"t_start": t_w0, "t_end": t_end, "solves": solves,
              "setup_s": setup_s}
    _sync(torch, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    k, tol = solver.k, solver.tol
    b1_shape = problem.b1_shape
    tr = None
    if prof is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            tr = analyse_trace(measures.trace_events(path))
        prof = None
    del solver, problem
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = judge(ref, answers, tol, k)
    say("judged: " + ", ".join(f"{n} {v!r}" for n, v in checks.items()))
    limits = dict({name: float(v) for name, v in traffic["correct"].items()},
                  backward_max=tol)
    correct = bool(solves) and all(passes(checks[n], limits[n])
                                   for n in limits)

    untraced = [s for s in solves if not s["traced"]] or solves
    record = {"solves": untraced, "build_s": build_s, "b1_shape": b1_shape,
              "trace": tr, "window": window}
    metrics = {}
    for m, mod in cell.readers(trace):
        value = mod.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev_info["power_limit"] = _power_limit()
    if trace:
        dev_info["busy_s"] = tr["busy_s"] if tr else 0.0
        dev_info["window_s"] = tr["window_s"] if tr else 0.0
    failed = sum(1 for s in solves if s["distinct"] < k)
    found = _forbidden_modules()
    if found:
        say(f"the run loaded {found}; the port may import none of "
            f"{list(FORBIDDEN)}")
        return 3, None
    result = {"correct": correct, "attempted": len(solves), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {n: {"value": checks[n], "limit": limits[n]}
                        for n in limits}
    say(f"solves in the window: {len(solves)}, failed {failed}"
        + (f"; traced: the first {min(TRACE_SOLVES, len(solves))}" if trace
           else ""))
    return 0, result
