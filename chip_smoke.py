#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``neptpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one informative line each (any failure exits non-zero):

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile the hand-written DIA SpMV kernel (``neptpu_torch/csrc/
   dia_spmv.cu``) with nvcc for sm_90a, timed apart from everything else;
3. kernel vs. its plain PyTorch twin on the card at four shapes (gun_like's
   bank in float32 and float64, the SpMV headline shape of ``bench.py``, a
   wide 211-diagonal bank): max relative error against the twin within the
   stated tolerance, median CUDA-event times of both, effective GB/s;
4. main path: ``nep_gallery("gun_like")`` on the card -> float32
   complex-as-real IAR (SPIKE + SMW shifted solve, kernel-backed bank apply)
   -> cluster the candidates -> host Newton refinement to backward error
   1e-9 (driven toward 1e-11), the ``bench.py`` gun_like protocol.  Requires
   >= 10 distinct pairs at backward error <= 1e-9, >= 10 of them within rel
   1e-9 of the pinned oracle, and >= 2 kernel launches per scan step.

The line before the last is a JSON object describing the kernel; the last
line is ``{"ok": true, "device": {...}}``.  There is no CPU path: without a
CUDA device the script exits non-zero and prints no result.
"""
import json
import subprocess
import sys
import time

import numpy as np

# gun_like eigenvalues closest to sigma = 2e4 + 100i, backward error < 2e-14
# each (tests/test_gun_oracle.py:27-42, computed offline by an independent
# host IAR + Rayleigh-functional Newton pipeline)
GUN_LIKE_PINNED = np.array([
    2.000784486007e+04 + 2.336317476305e+00j,
    1.998653058823e+04 + 2.190038755012e+00j,
    2.002340378018e+04 + 1.843217042443e+00j,
    2.002269572738e+04 + 1.588909478222e+00j,
    1.997644902939e+04 + 1.557111376214e+00j,
    1.997169337583e+04 + 2.220253243247e+00j,
    1.995989273931e+04 + 2.957300026441e+00j,
    2.004294766786e+04 + 1.516863061471e+00j,
    1.995715987883e+04 + 1.293708622892e+00j,
    2.005124451189e+04 + 2.007272099441e+00j,
    2.006158121584e+04 + 2.321728954563e+00j,
    1.993649599695e+04 + 2.131066205484e+00j,
    2.006568598876e+04 + 1.821894430190e+00j,
    1.991647938831e+04 + 2.066989490675e+00j,
])

SIGMA, GAMMA = 2.0e4 + 100j, 1.0e4
# headline SpMV bank of bench.py:60-72 (n = 1e6, 4 terms, 9 diagonals)
HEADLINE_N, HEADLINE_M = 1_000_000, 4


class SmokeFailure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


# -- measures copied from bench.py:123-177 --------------------------------
def backward_errmeasure(mats, fv):
    from neptpu_torch.solvers.refine import _TermOps
    from neptpu_torch.solvers.spmf_real import (_spmf_host_resnorm,
                                                spmf_fun_scalars)

    fro = np.array([np.sqrt(np.abs(A.multiply(A.conj())).sum())
                    for A in mats])
    rn = _spmf_host_resnorm(mats, fv)

    def err(lam, q):
        return rn(lam, q) / float(np.abs(spmf_fun_scalars(fv, lam)) @ fro)

    ops = _TermOps([A.tocsr() for A in mats], fv)

    def err_batch(lams_v, Qm):
        W = ops.weights(lams_v, 1)[:, 0]
        r = np.linalg.norm(ops.contract(ops.apply(Qm), W), axis=0)
        return r / (np.abs(W).T @ fro)

    err.batch = err_batch
    return err


def cluster_candidates(lams, errs, rel=3e-5, keep=None):
    """One best-residual representative per eigenvalue cluster."""
    sel = []
    for j in np.argsort(errs):
        if all(abs(lams[j] - lams[i]) > rel * max(1.0, abs(lams[j]))
               for i in sel):
            sel.append(int(j))
    return sel[:keep] if keep is not None else sel


def distinct_below_tol(lams, errs, tol, rel=1e-7):
    """Distinct eigenpairs below ``tol`` (best residual per 1e-7 group)."""
    good = np.nonzero(np.asarray(errs) < tol)[0]
    sel = []
    for j in good[np.argsort(np.asarray(errs)[good])]:
        if all(abs(lams[j] - lams[i]) > rel * max(1.0, abs(lams[j]))
               for i in sel):
            sel.append(int(j))
    return sel


# -- phases ---------------------------------------------------------------
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    return card


def phase_build(dia_kernel):
    t0 = time.perf_counter()
    dia_kernel.build_kernel()
    dt = time.perf_counter() - t0
    regs = [ln.split(":", 1)[1].strip() for ln in
            dia_kernel.DIA_SPMV.build_log.splitlines() if "registers" in ln]
    built = dia_kernel.DIA_SPMV.build_seconds
    print(f"[build] {dia_kernel.DIA_SPMV.library_path()} in {dt:.3f} s "
          f"(nvcc {'%.3f s' % built if built is not None else 'cached'}); "
          f"ptxas: {' | '.join(regs) or 'n/a'}", flush=True)


def _median_ms(torch, fn, reps=20, inner=10):
    """Median over ``reps`` of CUDA-event time per call across ``inner``
    back-to-back calls (warm; includes the host launch cost when that is the
    larger)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def phase_kernel_checks(torch, dia_kernel, gun_bank):
    """Kernel vs. plain twin at the four shapes; returns the gun f32 row."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = int(round(np.sqrt(HEADLINE_N)))
    shapes = [
        ("gun_like f32", gun_bank.data.to(torch.float32), gun_bank.offsets,
         1e-5),
        ("headline f32", None, (-w - 1, -w, -w + 1, -1, 0, 1, w - 1, w, w + 1),
         1e-5),
        ("wide f32", None, tuple(range(-105, 106)), 1e-5),
        ("gun_like f64", gun_bank.data.to(torch.float64), gun_bank.offsets,
         1e-12),
    ]
    rows = []
    for name, data, offs, tol in shapes:
        if data is None:
            n = HEADLINE_N if name.startswith("headline") else 11655
            m = HEADLINE_M if name.startswith("headline") else 2
            data = torch.randn((m, len(offs), n), generator=gen,
                               device="cuda", dtype=torch.float32)
        data = data.contiguous()
        m, ndiag, n = data.shape
        W = torch.randn((n, m), generator=gen, device="cuda",
                        dtype=data.dtype)
        offs_dev = torch.tensor(offs, dtype=torch.int32, device="cuda")
        y = dia_kernel.dia_lincomb(data, offs_dev, W)
        torch.cuda.synchronize()
        y_plain = dia_kernel.dia_lincomb_plain(data, offs, W)
        abs_err = float((y - y_plain).abs().max())
        rel = abs_err / float(y_plain.abs().max())
        check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
        ms = _median_ms(torch, lambda: dia_kernel.dia_lincomb(data, offs_dev,
                                                              W))
        plain_ms = _median_ms(torch, lambda: dia_kernel.dia_lincomb_plain(
            data, offs, W))
        nbytes = (m * ndiag * n + n * m + n) * data.element_size()
        print(f"[kernel] {name}: n={n} m={m} ndiag={ndiag} max_rel_err="
              f"{rel:.3e} (tol {tol:g}) max_abs_err={abs_err:.3e} kernel "
              f"{ms * 1e3:.2f} us ({nbytes / ms / 1e6:.1f} GB/s) plain "
              f"{plain_ms * 1e3:.2f} us ({nbytes / plain_ms / 1e6:.1f} GB/s)",
              flush=True)
        check(rel <= tol, f"{name}: kernel disagrees with its twin "
                          f"(max rel err {rel:.3e} > {tol:g})")
        rows.append({"shape": name, "max_abs_err": abs_err, "ms": ms,
                     "plain_ms": plain_ms, "gbs": nbytes / ms / 1e6})
    # same-run bandwidth reference: a device copy of 1 GiB (20x the L2)
    x = torch.empty(2**28, dtype=torch.float32, device="cuda")
    x.normal_(generator=gen)
    y = torch.empty_like(x)
    copy_ms = _median_ms(torch, lambda: y.copy_(x), reps=5, inner=5)
    copy_gbs = 2 * x.numel() * 4 / copy_ms / 1e6
    head = rows[1]
    print(f"[kernel] stream copy 1 GiB: {copy_ms * 1e3:.1f} us = "
          f"{copy_gbs:.1f} GB/s; headline kernel at "
          f"{head['gbs'] / copy_gbs:.3f} of it (bank 144 MB, W 16 MB)",
          flush=True)
    del x, y
    return rows


def phase_main_path(torch, dia_kernel):
    from neptpu_torch import nep_gallery
    from neptpu_torch.solvers.refine import newton_refine
    from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                                iar_real_spmf)

    torch.cuda.reset_peak_memory_stats()
    dia_kernel.DIA_SPMV.launches = 0
    t_start = time.perf_counter()
    nep = nep_gallery("gun_like", device="cuda")
    mats, fv = collect_spmf_terms(nep)
    backward = backward_errmeasure(mats, fv)
    t_problem = time.perf_counter() - t_start
    lams, Q, info = iar_real_spmf(
        nep, sigma=SIGMA, gamma=GAMMA, maxit=60, neigs=10, tol=1e-6,
        check_error_every=20, dtype=torch.float32, errmeasure=backward,
        return_info=True, device="cuda")
    torch.cuda.synchronize()
    t_iar_done = time.perf_counter()
    lams = np.asarray(lams)
    Q = np.asarray(Q)
    errs0 = np.array([backward(complex(lams[j]), Q[:, j])
                      for j in range(len(lams))])
    reps = cluster_candidates(lams, errs0, keep=10 + 6)
    lams, Q, errs = newton_refine(
        mats, fv, lams[reps], Q[:, reps], nsweeps=3, tol=1e-11,
        errmeasure=backward, dtype=torch.float32, ir=3, shift_rel=1e-8,
        backend="auto", target_distinct=10)
    wall = time.perf_counter() - t_start
    launches = dia_kernel.DIA_SPMV.launches
    sel = distinct_below_tol(lams, errs, 1e-9)
    matched = sum(1 for j in sel
                  if np.min(np.abs(GUN_LIKE_PINNED - lams[j]))
                  / abs(lams[j]) < 1e-9)
    k_done = int(info["k_done"])
    print(f"[main] gun_like n={nep.n}: k_done={k_done} nconv={info['nconv']} "
          f"scaled={info['scaled']} candidates={len(reps)} distinct<=1e-9="
          f"{len(sel)} matched_pinned={matched} max_backward="
          f"{max(errs[sel]) if sel else float('nan'):.3e} launches="
          f"{launches}", flush=True)
    print(f"[main] t_problem={t_problem:.3f} s t_factorize="
          f"{info['t_factorize']:.3f} s t_scan={info['t_scan']:.3f} s "
          f"(host checks {info['t_check']:.3f} s) t_refine="
          f"{wall - (t_iar_done - t_start):.3f} s wall={wall:.3f} s "
          f"peak_device_mem={torch.cuda.max_memory_allocated() / 2**20:.1f} "
          "MiB", flush=True)
    check(len(sel) >= 10, f"only {len(sel)} distinct pairs at backward "
                          "error <= 1e-9 (need 10)")
    check(matched >= 10, f"only {matched} pairs within rel 1e-9 of the "
                         "pinned oracle (need 10)")
    check(launches >= 2 * k_done, f"kernel launched {launches} times in "
                                  f"{k_done} scan steps (need >= 2 per step)")
    return launches


def phase_profile(torch, trace_path):
    """The factorization and scan of the main path once more under
    ``torch.profiler``; the chrome trace goes to ``trace_path`` and its device
    kernels give the device's busy share and the time by kernel."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from neptpu_torch import nep_gallery
    from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                                iar_real_spmf)

    nep = nep_gallery("gun_like", device="cuda")
    mats, fv = collect_spmf_terms(nep)
    kw = dict(sigma=SIGMA, gamma=GAMMA, maxit=60, neigs=10, tol=1e-6,
              check_error_every=20, dtype=torch.float32,
              errmeasure=backward_errmeasure(mats, fv), return_info=True,
              device="cuda")
    iar_real_spmf(nep, **kw)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, info = iar_real_spmf(nep, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_us = 0.0  # union of device intervals (one stream: no overlap)
    end = -1.0
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        by[e["name"]][0] += e["dur"]
        by[e["name"]][1] += 1
    check(busy_us > 0, "profile: no device activity traced")
    print(f"[profile] factorize+scan wall {wall:.3f} s (t_factorize "
          f"{info['t_factorize']:.3f} s, t_scan {info['t_scan']:.3f} s, "
          f"k_done {info['k_done']}); device busy {busy_us / 1e6:.4f} s = "
          f"{busy_us / 1e4 / wall:.1f}% of wall, {len(dev)} device ops",
          flush=True)
    for name, (us, cnt) in sorted(by.items(), key=lambda x: -x[1][0])[:8]:
        print(f"[profile]   {us / 1e3:8.3f} ms {100 * us / busy_us:5.1f}% "
              f"x{cnt:5d}  {name[:80]}", flush=True)
    dia = [v for k, v in by.items() if "dia_lincomb" in k]
    if dia:
        us, cnt = dia[0]
        print(f"[profile] dia_lincomb kernel: {cnt} launches, "
              f"{us / cnt:.2f} us device time each, {100 * us / busy_us:.2f}% "
              "of device time", flush=True)


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="TRACE.json", default=None,
                    help="also profile the main path's factorization and "
                         "scan, writing the chrome trace to this file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an "
              "NVIDIA GPU (there is no CPU path)", file=sys.stderr)
        return 2
    from neptpu_torch import nep_gallery
    from neptpu_torch.ops import dia_kernel

    t0 = time.perf_counter()
    phase_device(torch)
    phase_build(dia_kernel)
    gun_bank = nep_gallery("gun_like", device="cuda").nep1.bank
    rows = phase_kernel_checks(torch, dia_kernel, gun_bank)
    launches = phase_main_path(torch, dia_kernel)
    if args.profile:
        phase_profile(torch, args.profile)
    gun = rows[0]
    print(f"[done] total {time.perf_counter() - t0:.3f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "dia_lincomb",
        "route": "cuda",
        "source": "neptpu_torch/csrc/dia_spmv.cu",
        "replaces": "neptpu/ops/pallas_spmv.py:76",
        "launches": launches,
        "max_abs_err": gun["max_abs_err"],
        "ms": gun["ms"],
        "plain_ms": gun["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
