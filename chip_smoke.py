#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``neptpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile TRACE.json] [--parent DIR]

Phases, a few informative lines each (any failure exits non-zero):

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile the hand-written DIA SpMV kernels (``neptpu_torch/csrc/
   dia_spmv.cu``) with nvcc for sm_90a, timed apart from everything else;
3. kernels vs. their plain PyTorch twins on the card, through the prepared
   launcher (``DiaLauncher``) on term-major operands: the single-operand
   kernel at four shapes (gun_like's bank in float32 and float64, the SpMV
   headline shape of ``bench.py``, a synthetic 211-diagonal bank) and the
   re/im pair kernel at the gun_like, wep, wep_large and headline shapes (each
   waveguide bank the main paths build is held against the shape checked
   here); both again at the delay problem's shape (n = 1e4, 2 terms, the 9
   offsets of ``dep_symm_double``) in float32 and float64; and the bfloat16
   kernels (bf16 bank and operands, float32 sums and result), single and
   pair, at the headline and the delay shape; the generic body (more than
   16 offsets or 4 terms) at a wide band (11655, 2 terms, 211 offsets; f32
   single and pair, f64 pair), [generic]'s quartic PEP bank (1e6, 5, 9; f32
   single and pair, f64 pair, bf16 single), a 27-point stencil on a 100^3
   grid (1e6, 2, 27; f32) and, correctness only, 300 offsets (11655, 1) from
   the device array - max
   relative error against the twin within the stated tolerance, the pair
   equal to two single launches, median CUDA-event times of kernel, twin and
   the nearest library calls (a ``torch.sparse`` CSR product of the stacked
   bank; the port's own CSR bank), and each time's bound from the bytes moved.
   Every time is read as the host makes the calls (eager) and, for
   n <= 1e5, a second time under CUDA-graph replay (ten launches captured,
   replayed: the device's time per launch), the library product and the
   empty-kernel floor the same two ways.  Where ``--parent`` holds an
   unpacked copy of the parent commit, that commit's kernel body is built
   as a second library and timed in turns (old, new, new, old) beside the
   present one, and its results must equal the present ones bit for bit
   (the narrow body) or within the row's tolerance (the generic body, which
   sums in another order);
4. main paths, through the entry points a user calls, each with the kernel
   launch counts set to 0 just before and read just after:
   * SpMV headline: a DIA bank at n = 1e6 (4 terms x 9 diagonals) applied
     through ``DiaTermBank.lincomb_apply_t`` (the operand term-major, as
     the models and the scans form it) and through the row-major entry
     ``lincomb_apply`` (which transposes first), in float32 and as a
     bfloat16 bank (single and re/im pair apply), each row within its
     rounding bound of the scipy product;
   * generic: a quartic ``PEP`` of five seeded 9-offset stencil matrices
     at n = 1e6 (``--seed``), its bank a 5-term ``DiaTermBank`` that only
     the generic body takes: ``compute_Mlincomb`` with three derivative
     columns at two shifts on complex128 and float32 operands, and the
     bank's float32 single and pair and bfloat16 single applies, each
     against a host scipy CSR float64 product (rel 1e-12 / 1e-5; bf16 within
     its rounding bound); every launch on the generic body;
   * gun_like (n = 9956): float32 complex-as-real IAR (SPIKE + SMW shifted
     solve, kernel-backed bank apply) -> cluster -> Newton refinement to
     backward error 1e-9 (driven toward 1e-11), the ``bench.py`` protocol;
     >= 10 distinct pairs, >= 10 within rel 1e-9 of the pinned oracle;
   * wep (waveguide, n = 11655, 213 terms, 3 shifts) at full size:
     multishift scan -> cluster -> refinement on the card
     (``backend="chip"``, the choice ``bench.py`` leaves to
     ``BENCH_WEP_REFINE``); >= 10 distinct pairs at 1e-9, and at most
     ``MAX_HOST_FALLBACK`` of the refinement's shifts may fail the device
     solver's validation and fall back to a host splu.  The same candidates
     are then refined with ``backend="auto"`` (the host, below 2n = 2e5) and
     that count is printed, not gated;
   * wep_large (n = 13915, 4 shifts) at full size, the same way: >= 10
     distinct pairs at 1e-9;
   every scan step must launch the pair kernel at least once;
   * spmf-deflated: the restarted scan with Effenberger deflation inside
     the scan step (``iar_real_spmf_deflated``) on gun_like (float64: float32
     overflows its T; maxit 30 a sweep, 10 pairs wanted, tol 1e-6; host
     refinement: >= 4 distinct pairs at 1e-9, each within rel 1e-9 of the
     pinned oracle) and on wep (float32, maxit 12, 6 pairs, tol 1e-5, the
     first bench shift; chip refinement: >= 3 distinct pairs at 1e-9, each
     matched to the main path's refined pairs or printed as new); at least
     two sweeps converge pairs, no pair reconverges, one pair launch a scan
     step; sweeps, max |T| per sweep and the host checks per sweep printed;
     within 200 s;
   * dep (``dep_symm_double``, n = 1e4, delays 0 and 2), the protocol of
     ``benchmarks/time_to_tol.py``: float32 ``iar_real`` then ``tiar_real``
     at sigma = -1, all ``maxit`` Ritz pairs measured on the host in float64;
     each >= 10 pairs at backward error <= 1e-6, the two agreeing on their
     10 best eigenvalues to rel 1e-5 (modulo conjugation), exactly one pair
     launch and no single launch per scan step; then the bank itself applied
     to the best Ritz vector in float32, float64 and bfloat16;
   * dep-protocol, the same problem through the protocol solvers on the
     card: ``tiar`` and ``iar`` (complex128, dense LU, maxit 30) and
     ``resinv``/``augnewton``/``quasinewton``/``newton`` from one of
     ``iar_real``'s pairs perturbed by 1e-3, each converging to its default
     tolerance onto an eigenvalue ``iar_real`` found (rel 1e-6);
   * dep-deflation, the same problem through the deflation and projection
     solvers on the card: ``jd_effenberger`` (3 pairs; the deflated problem
     keeps the DIA bank, padded, and low-rank factor terms), ``jd_betcke``
     (2 pairs), ``nlar`` (3 pairs) and ``iar``/``tiar`` with
     ``proj_solve=True`` (4 pairs each), every pair at backward error
     <= 1e-10 and within rel 1e-6 of float64 ``iar_real``'s eigenvalues,
     the deflating solvers' eigenvalues distinct, within 150 s;
   * dep-krylov, the same problem through ``iar_chebyshev`` (``:DEP``,
     shifted explicitly to sigma = -1), ``ilan`` (``proj_solve=True``),
     ``infbilanczos`` (with the transposed problem), ``blocknewton`` (from
     float64 ``iar_real``'s best three pairs) and ``broyden`` (at nside 40,
     held against float64 ``iar_real`` there), every pair at backward error
     <= 1e-10 and within rel 1e-6 of float64 ``iar_real``'s eigenvalues,
     within 120 s;
   * rational: gun_like (n = 9956, complex128) through ``nleigs`` (a box
     around six pinned eigenvalues, the poles on the second square root's
     branch cut, three shifts with one dense LU each), ``AAAeigs`` (400
     samples of the box, the same shifts), ``contour_beyn`` and
     ``contour_block_SS`` (an ellipse around the same six, 128 nodes, eight
     nodes' dense M LU-factored as one stack): every pinned eigenvalue in
     the region found (AAAeigs: >= 4 of its 6 pairs), NLEIGS and AAAeigs at
     backward error <= 1e-10 and rel 1e-9 of the oracle, the contour methods
     within rel 1e-8 and with no other eigenvalue in the ellipse; one float64
     pair launch per NLEIGS divided-difference apply and per AAAeigs
     iteration; within 200 s;
5. refine-chip: the gun_like candidates refined again on the card
   (``BatchedShiftSMW``: float32 factors + float64 iterative refinement)
   against the host backend: >= 10 distinct at 1e-9, eigenvalues within rel
   1e-9 of the host backend's;
6. wep-native: the waveguide's native form ``WEP_FD`` at n = 11655
   (JARLEBRING, complex128): ``resinv`` with the factorized Schur solver
   (the complement assembled dense, 2.1 GB, one LU on the card) onto the
   pinned eigenvalue within 1e-9, ``iar`` (>= 3 pairs, one within 1e-10 of
   it), GMRES with the FFT-Sylvester SMW preconditioner (N = 21) to a
   relative residual < 1e-8, and the SPMF form's merged bank (the float64
   pair kernel) against the native Mlincomb (rel 1e-12) and at the pair
   (backward error <= 1e-10); within 120 s;
7. complex-scan: ``tiar_jitted_spmf`` on gun_like (>= 4 distinct pairs at
   backward error 1e-9 on the pinned oracle, one float64 pair launch a
   step) and ``iar_jitted``/``tiar_jitted`` on the float64 delay problem
   (6 pairs each at backward error <= 1e-10, within rel 1e-6 of float64
   ``iar_real``) and ``iar_jitted`` on a deflated ``pep0`` (captured, its
   eigenvalue within rel 1e-8 of the CPU's); within 90 s;
8. gallery: every gallery problem this slice ports built on the card, the
   registry identity Mlincomb = Mder v, and the pinned oracles
   (``real_quadratic``, ``orr_sommerfeld``, the mathieu ``periodicdde``,
   ``bem_fichera``, fiber, cd_player, hadeler, pdde_stability, beam);
   within 60 s;
9. sharded: the sharded layer (``torch.distributed``, SPMD).  (a) One rank
   over NCCL in this process: ``iar_real_sharded`` on the float64 delay
   problem (n = 1e4, maxit 60; >= 10 pairs at backward error <= 1e-10
   within rel 1e-9 of float64 ``iar_real``), ``iar_real_spmf_sharded`` on
   gun_like (the 4 converged pairs nearest sigma within rel 1e-9 of the
   serial float64 scan; >= 10 distinct pairs on the pinned oracle, the
   others on the serial scan's) and on wep (3 pairs within 1e-10 of the
   serial scan, residual < 1e-8), ``contour_beyn(mesh=...)`` on
   [rational]'s ellipse (rel 1e-8 of the serial run).  (b) Four ranks on
   the one card (spawned processes, gloo with every collective staged
   through the host, compute on the card): the three scans with the same
   gates and ``sharded_dia_lincomb`` on the SpMV headline bank against the
   single-card apply (rel 1e-6).  Each scan launches one float64 B1 pair a
   step on each rank's block (the halo exchange overlapped, the boundary
   corrections after it) and nothing else; the blocks are the shapes the
   kernel checks ran at.  At one rank each scan's steps replay one captured
   CUDA graph, in turns with the eager comparator (the same launches and
   Hessenberg to rel 1e-12), and a probe captures and replays NCCL
   collectives; the four host-staged ranks run every step eagerly and say
   so; within 180 s.  One card gives correctness, not scaling.

10. scan-graph: every scan above steps through one captured CUDA graph a
   scan (the step's static-shape form: the step index a device tensor, the
   first step eager as the capture's warm-up, then one replay a step); here
   each runs again beside the eager step loop (the comparator, by its
   private name) on the same bank, solver and start - gun_like and wep's
   three shifts (``iar_real_spmf``, float32), the delay problem's
   ``iar_real`` and ``tiar_real`` (float32), the deflated wep scan and
   ``tiar_jitted_spmf`` on gun_like (complex128): ``t_scan`` and a step's
   time without the host checks for both, capture seconds, replays and host
   graph launches a step, peak memory; gates: the same steps, launches and
   eigenvalues, the Hessenberg within rel 1e-6 (float32) or 1e-12, one
   replay a step after the warm-up; within 150 s.

With ``--profile``, one shift's factorization and scan of gun_like and of wep
run once more under ``torch.profiler`` (device busy share, time by kernel),
[scan-graph] prints each form's device busy share for gun_like, wep's first
shift, the delay problem's scans and ``tiar_jitted_spmf``, and the device
operations per scan step at gun_like, wep and dep are counted for the graph
and the eager comparator, the copy and gather kernels among them apart.

The line before the last is a JSON object describing the kernels; the last
line is ``{"ok": true, "device": {...}}``.  There is no CPU path: without a
CUDA device the script exits non-zero and prints no result.
"""
import json
import os
import re
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
# the waveguide configurations of bench.py:445-477 (JARLEBRING, SPMF form)
WEP = dict(nx=109, nz=105, sigmas=[-3 - 3.5j, -4.5 - 4.5j, -1.2 - 1.6j])
WEP_LARGE = dict(nx=119, nz=115,
                 sigmas=[-3 - 3.5j, -4.5 - 4.5j, -1.2 - 1.6j, -2.1 - 2.4j])
# of the chip refine backend's shifts, at most this many per phase may fail
# the device solver's validation and be solved by a host splu instead
MAX_HOST_FALLBACK = 2
# the delay problem of benchmarks/time_to_tol.py:55-59 (dep_symm_double on
# an nside x nside grid; sigma, maxit, pairs wanted, backward-error tolerance)
DEP = dict(nside=100, sigma=-1.0, maxit=60, k=10, tol=1e-6)
# [spmf-deflated]: the restarted scan with Effenberger deflation (maxit is
# per sweep).  gun_like runs in float64: there gamma theta / |sigma - lam|
# ~ 100, so max |T| ~ 100^maxit overflows float32 past maxit ~ 17 (7.8e59
# at 30), and below that float32 sweeps converge nothing at 1e-6
SPMF_DEFLATED = {
    "gun_like": dict(maxit=30, neigs=10, tol=1e-6, need=4, dtype="float64",
                     check_every=10),
    "wep": dict(maxit=12, neigs=6, tol=1e-5, need=3, dtype="float32",
                check_every=6)}
# [dep-krylov]: the Krylov variants and the dense Newton solvers on the
# float64 delay problem; broyden on a smaller grid (its restart takes a dense
# eig of the (n + k)^2 bordered matrix on the host)
KRYLOV = dict(broyden_nside=40, budget=120.0)
DEVICE = "cuda"  # every phase runs on the card
# [rational]: the rational-Krylov, AAA and contour family on gun_like.  The
# box Sigma and the ellipse both lie inside the disk of radius 128.7 about
# SIGMA that the pinned oracle covers, so every eigenvalue in them is
# pinned; the nodes (NLEIGS's shifts after the freeze, AAAeigs's shifts) sit
# inside the box, each more than 1 from every pinned value
RATIONAL = dict(box=(19965 - 15j, 19965 + 15j, 20035 + 15j, 20035 - 15j),
                nodes=(19980 + 6j, 20000 + 6j, 20020 + 6j),
                center=2.0e4 + 2j, radius=(35.0, 10.0), N=128, chunk=8,
                tol=1e-10, budget=200.0)
# published peaks of one H100 SXM (NVIDIA data sheet): the bounds' rates
PEAK_BYTES_PER_S = 3.35e12
# vector rates; the bfloat16 kernels widen to float32 before multiplying
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12}


def dep_bank_shape(nside):
    """(m, offsets, n) of ``dep_symm_double``'s DIA bank: two terms on the
    nine-point stencil of ``kron(LL, LL)`` on the nside x nside grid."""
    w = nside
    return 2, (-w - 1, -w, -w + 1, -1, 0, 1, w - 1, w, w + 1), w * w


def wep_bank_shape(cfg):
    """(m, offsets, n) of a waveguide's main DIA bank: three terms on the
    five-point stencil of the (nx + 2) x nz grid, the z-neighbours one short
    of the row length because the periodic wrap is in the low-rank part."""
    nz = cfg["nz"]
    return 3, (-nz, -nz + 1, -1, 0, 1, nz - 1, nz), (cfg["nx"] + 2) * nz


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
    log = dia_kernel.DIA_SPMV.build_log
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    built = dia_kernel.DIA_SPMV.build_seconds
    print(f"[build] {dia_kernel.DIA_SPMV.library_path()} in {dt:.3f} s "
          f"(nvcc {'%.3f s' % built if built is not None else 'cached'}); "
          f"ptxas: {len(regs)} kernels, registers "
          f"{min(regs, default=0)}-{max(regs, default=0)}, spill stores "
          f"{sum(spills)} B in {sum(1 for x in spills if x)} kernels",
          flush=True)


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


def _bound(n, m, ndiag, noperands, itemsize, dtype_name):
    """Least time (ms) for the fused apply of one (m, ndiag, n) bank to
    ``noperands`` (n, m) operands: each input read once, each output written
    once (the bfloat16 kernels write float32), against the published memory
    rate; 2 flops per bank word and operand against the published vector
    rate.  Returns (ms, by, bytes)."""
    out_size = 4 if dtype_name == "bfloat16" else itemsize
    nbytes = ((m * ndiag * n + noperands * n * m) * itemsize
              + noperands * n * out_size)
    flops = 2 * m * ndiag * n * noperands
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return ((t_bytes, "bytes", nbytes) if t_bytes >= t_ops
            else (t_ops, "operations", nbytes))


def _graph_ms(torch, fn, reps=20, inner=10, replays=5):
    """Median over ``reps`` of CUDA-event time per call of ``inner``
    back-to-back calls captured into one CUDA graph and replayed ``replays``
    times: the device's time per launch, free of the rate at which the host launches.
    None (with a printed reason) where ``fn`` cannot be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn()
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"[kernel] not capturable into a CUDA graph: "
              f"{str(e).splitlines()[0][:100]}", flush=True)
        return None
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / (inner * replays))
    del graph
    return float(np.median(times))


def _in_turns(torch, timer, old, new):
    """``(old_ms, new_ms)`` timed old, new, new, old on the same card, the
    mean of each one's two readings; ``old`` None: the new one alone."""
    if old is None:
        return None, timer(torch, new)
    t = [timer(torch, f) for f in (old, new, new, old)]
    if any(x is None for x in t):
        return None, t[1]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


class ParentBody:
    """The kernels of the parent commit's ``dia_spmv.cu``, built as a second
    library from an unpacked copy of that commit and launched through a bare
    ctypes call on its own bank struct (the parent's ``DiaBank``: data,
    offsets array, n, m, ndiag, rows a thread, 256 offsets by value;
    term-major operands), for timing beside the present body in the same
    run.  A measurement input: the port itself never loads it."""

    SUFFIX = {"float32": "f32", "float64": "f64", "bfloat16": "bf16"}

    def __init__(self, torch, dia_kernel, source):
        import ctypes

        class Bank(ctypes.Structure):
            _fields_ = [("data", ctypes.c_void_p),
                        ("offsets_dev", ctypes.c_void_p),
                        ("n", ctypes.c_longlong), ("m", ctypes.c_int),
                        ("ndiag", ctypes.c_int), ("vec", ctypes.c_int),
                        ("offsets", ctypes.c_int * 256)]

        self.torch, self.dia_kernel, self.Bank = torch, dia_kernel, Bank
        library = dia_kernel.KernelLibrary("dia_spmv_parent", source)
        self.lib = ctypes.CDLL(library.build())
        self.build_seconds = library.build_seconds
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for sfx in self.SUFFIX.values():
            fn = getattr(self.lib, f"dia_lincomb_{sfx}")
            fn.argtypes = [ctypes.POINTER(Bank), ptr, ptr, ptr]
            fn.restype = i32
            fn = getattr(self.lib, f"dia_lincomb_pair_{sfx}")
            fn.argtypes = [ctypes.POINTER(Bank), ptr, ptr, ptr, ptr, ptr]
            fn.restype = i32

    def prepare(self, data, offs, WT, WimT):
        """Closures ``(single, pair)`` on the same term-major operands; each
        call allocates its result and launches once."""
        import ctypes

        torch = self.torch
        m, ndiag, n = data.shape
        sfx = self.SUFFIX[str(data.dtype).split(".")[1]]
        f1 = getattr(self.lib, f"dia_lincomb_{sfx}")
        f2 = getattr(self.lib, f"dia_lincomb_pair_{sfx}")
        offs_dev = torch.tensor(offs, dtype=torch.int32, device=data.device)
        bank = self.Bank()
        bank.data, bank.offsets_dev = data.data_ptr(), offs_dev.data_ptr()
        bank.n, bank.m, bank.ndiag = n, m, ndiag
        bank.vec = self.dia_kernel.rows_per_thread(data.dtype, n)
        for d, o in enumerate(tuple(offs)[:256]):
            bank.offsets[d] = o
        ref = ctypes.byref(bank)
        rdt = self.dia_kernel.result_dtype(data.dtype)

        def single():
            y = torch.empty(n, dtype=rdt, device=data.device)
            rc = f1(ref, WT.data_ptr(), y.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"parent body: launch failed ({rc})")
            return y

        def pair():
            y = torch.empty((2, n), dtype=rdt, device=data.device)
            rc = f2(ref, WT.data_ptr(), WimT.data_ptr(), y[0].data_ptr(),
                    y[1].data_ptr(), torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"parent body: pair launch failed ({rc})")
            return y[0], y[1]

        single.keep = pair.keep = (offs_dev, bank)  # alive while in use
        return single, pair


def _stacked_csr(torch, data, offs):
    """The bank as ONE ``torch.sparse`` CSR matrix (n, m*n) acting on the
    flattening of the term-major WT (m, n): ``y = A @ WT.reshape(-1)`` is the
    fused apply - the library yardstick, used nowhere in the port."""
    m, ndiag, n = data.shape
    r = torch.arange(n, device=data.device)
    rows, cols, vals = [], [], []
    for d, off in enumerate(offs):
        ok = (r + off >= 0) & (r + off < n)
        for i in range(m):
            rows.append(r[ok])
            cols.append(i * n + r[ok] + off)
            vals.append(data[i, d][ok])
    A = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (n, n * m)).coalesce()
    return A.to_sparse_csr()


def _library_times(torch, data, offs, WT, WimT, y_plain, tol):
    """``{"mv": (eager_ms, graph_ms), "mm": ...}`` of the ``torch.sparse``
    CSR product on the same operands (graph replay for n <= 1e5), checked
    against the plain result first.  None where this build has no sparse CSR
    product for the dtype."""
    w1 = WT.reshape(-1)
    w2 = torch.stack([WT.reshape(-1), WimT.reshape(-1)], dim=1)
    try:
        A = _stacked_csr(torch, data, offs)
        y_lib = (A @ w1).to(y_plain.dtype)
        A @ w2
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        if data.dtype != torch.bfloat16:
            raise
        print(f"[kernel] no torch.sparse CSR product in {data.dtype} on this "
              f"build ({str(e).splitlines()[0][:80]}): library call none",
              flush=True)
        return None
    if data.dtype == torch.bfloat16:
        tol = 5e-2  # the library rounds its result (and may sum) in bf16
    rel = float((y_lib - y_plain).abs().max() / y_plain.abs().max())
    check(rel <= tol, f"library CSR product disagrees with the plain "
                      f"version ({rel:.3e})")
    small = data.shape[2] <= 100_000
    reps, inner = (20, 10) if small else (5, 5)
    out = {}
    for key, fn in (("mv", lambda: A @ w1), ("mm", lambda: A @ w2)):
        out[key] = (_median_ms(torch, fn, reps, inner),
                    _graph_ms(torch, fn) if small else None)
    return out


# [kernel] rows held against their twin and not timed
CHECK_ONLY = {"300 offsets f32"}


def _unstaged_launcher(dia_kernel, data, offs):
    """The bank prepared for the generic body with no staged window: every
    diagonal reads the operand through L1 (the staged plan's comparator)."""
    plan = dia_kernel.generic_plan
    dia_kernel.generic_plan = lambda *a, **k: plan(*a, **k, stage=False)
    try:
        return dia_kernel.DiaLauncher(data, offs)
    finally:
        dia_kernel.generic_plan = plan


def _us(ms):
    return "n/a" if ms is None else f"{ms * 1e3:.2f}"


def phase_kernel_checks(torch, dia_kernel, gun_bank, parent=None,
                        extra=None):
    """Both kernels vs. their plain twins; returns rows keyed by shape.
    ``parent``: a :class:`ParentBody` to time in turns beside the kernels
    (the narrow body must equal it bit for bit; the generic body, which sums
    in another order, within the row's tolerance); ``extra``: more banks by
    name, held in float64 (the gallery problems' DIA banks)."""
    from neptpu_torch.ops.sparse import make_term_bank

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    w = int(round(np.sqrt(HEADLINE_N)))
    head_offs = (-w - 1, -w, -w + 1, -1, 0, 1, w - 1, w, w + 1)
    wm, wl = wep_bank_shape(WEP), wep_bank_shape(WEP_LARGE)
    dp = dep_bank_shape(DEP["nside"])
    d40 = dep_bank_shape(KRYLOV["broyden_nside"])
    bf16 = torch.bfloat16
    # name, data (None: random) or dtype, offsets, n, m, tolerance (relative
    # to max |y|: a few roundings of the accumulator's dtype per row, sums
    # reordered - the bfloat16 kernels and their twins both sum exact
    # products in float32), check the pair too
    shapes = [
        ("gun_like f32", gun_bank.data.to(torch.float32), gun_bank.offsets,
         None, None, 1e-5, True),
        ("wep f32", None, wm[1], wm[2], wm[0], 1e-5, True),
        ("wep_large f32", None, wl[1], wl[2], wl[0], 1e-5, True),
        ("headline f32", None, head_offs, HEADLINE_N, HEADLINE_M, 1e-5, True),
        ("gun_like f64", gun_bank.data.to(torch.float64), gun_bank.offsets,
         None, None, 1e-12, True),
        ("dep f32", torch.float32, dp[1], dp[2], dp[0], 1e-5, True),
        ("dep f64", torch.float64, dp[1], dp[2], dp[0], 1e-12, True),
        # the shifted delay problem of iar_chebyshev (one more term) and
        # broyden's smaller one
        ("shifted dep f64", torch.float64, dp[1], dp[2], dp[0] + 1, 1e-12,
         True),
        ("dep40 f64", torch.float64, d40[1], d40[2], d40[0], 1e-12, True),
        ("headline bf16", bf16, head_offs, HEADLINE_N, HEADLINE_M, 1e-5, True),
        ("dep bf16", bf16, dp[1], dp[2], dp[0], 1e-5, True),
        # the wep bank in float64: the native waveguide's cross-format check
        ("wep f64", torch.float64, wm[1], wm[2], wm[0], 1e-12, True),
    ] + [(f"{key} f64", bank.data.to(torch.float64), bank.offsets, None,
          None, 1e-12, True) for key, bank in (extra or {}).items()]
    # the generic body (more than 16 offsets or more than 4 terms): a wide
    # bank, [generic]'s quartic PEP, a 27-point stencil on a 100^3 grid, and
    # more offsets than ride by value (correctness only)
    wide = tuple(range(-105, 106))
    g27 = tuple(sorted(dz * 10_000 + dy * 100 + dx for dz in (-1, 0, 1)
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1)))
    shapes += [
        ("wide f32", None, wide, 11655, 2, 1e-5, True),
        ("wide f64", torch.float64, wide, 11655, 2, 1e-12, True),
        ("quartic f32", torch.float32, head_offs, HEADLINE_N,
         GENERIC["terms"], 1e-5, True),
        ("quartic f64", torch.float64, head_offs, HEADLINE_N,
         GENERIC["terms"], 1e-12, True),
        ("quartic bf16", bf16, head_offs, HEADLINE_N, GENERIC["terms"], 1e-5,
         False),
        ("27-point f32", torch.float32, g27, HEADLINE_N, 2, 1e-5, False),
        ("300 offsets f32", torch.float32, tuple(range(-150, 150)), 11655, 1,
         1e-5, False)]
    # [sharded]: the bulk of each rank's apply, B1 on the rank's block of
    # the bank, at one rank and at four; the scans' float64 pair and the
    # SpMV headline's float32 single apply
    shapes += [(block_row(key, ranks), torch.float32 if key == "headline"
                else torch.float64, offs, blk, m,
                1e-5 if key == "headline" else 1e-12, key != "headline")
               for (key, ranks), (m, offs, blk)
               in sharded_blocks(gun_bank).items()
               if (key, ranks) in SHARDED["runs"]]
    # the launch floor: an empty kernel through the same ctypes route, as
    # the host launches it and under graph replay
    floor_ms = _median_ms(torch, lambda: dia_kernel.empty_launch(DEVICE))
    floor_graph_ms = _graph_ms(torch, lambda: dia_kernel.empty_launch(DEVICE))
    print(f"[kernel] empty-kernel launch floor {floor_ms * 1e3:.2f} us per "
          "call (ctypes + launch, back to back), "
          f"{_us(floor_graph_ms)} us per launch under CUDA-graph replay (10 "
          "launches a graph)", flush=True)
    rows = {}
    for name, data, offs, n, m, tol, pair in shapes:
        if data is None or isinstance(data, torch.dtype):
            data = torch.randn((m, len(offs), n), generator=gen,
                               device=DEVICE, dtype=torch.float32).to(
                data or torch.float32)
        data = data.contiguous()
        m, ndiag, n = data.shape
        dtn = str(data.dtype).split(".")[1]
        small = n <= 100_000
        reps, inner = (20, 10) if small else (10, 10)
        WT = torch.randn((m, n), generator=gen, device=DEVICE,
                         dtype=torch.float32).to(data.dtype)
        WimT = torch.randn((m, n), generator=gen, device=DEVICE,
                           dtype=torch.float32).to(data.dtype)
        # the bank prepared once, as DiaTermBank prepares it
        launcher = dia_kernel.DiaLauncher(data, offs)
        y = launcher.single(WT)
        torch.cuda.synchronize()
        y_plain = dia_kernel.dia_lincomb_plain(data, offs, WT)
        abs_err = float((y - y_plain).abs().max())
        rel = abs_err / float(y_plain.abs().max())
        check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
        check(y.dtype == dia_kernel.result_dtype(data.dtype),
              f"{name}: result in {y.dtype}")
        check(torch.equal(y, dia_kernel.dia_lincomb(data, offs, WT)),
              f"{name}: prepared and functional entry differ")
        # the narrow body must equal the parent's bit for bit; the generic
        # one sums in another order and is held to the row's tolerance
        body = "generic" if launcher.generic else "narrow"
        old1 = old2 = None
        same_as_parent = parent_rel = None
        if parent is not None:
            old1, old2 = parent.prepare(data, offs, WT, WimT)
            y_old = old1()
            same_as_parent = bool(torch.equal(y_old, y))
            parent_rel = float((y - y_old).abs().max() / y_old.abs().max())
            check(same_as_parent or (launcher.generic and parent_rel <= tol),
                  f"{name}: result differs from the parent body's "
                  f"(max rel {parent_rel:.3e})")
        if name in CHECK_ONLY:
            print(f"[kernel] {name} ({body} body, {launcher.plan}): n={n} "
                  f"m={m} ndiag={ndiag} max_rel_err={rel:.3e} (tol {tol:g}) "
                  f"max_abs_err={abs_err:.3e}; parent body max rel gap "
                  f"{parent_rel}; correctness only, not timed", flush=True)
            check(rel <= tol, f"{name}: kernel disagrees with its twin "
                              f"(max rel err {rel:.3e} > {tol:g})")
            rows[name] = {"shape": name, "n": n, "m": m, "ndiag": ndiag,
                          "max_abs_err": abs_err}
            continue

        def timer(torch, fn):
            return _median_ms(torch, fn, reps, inner)

        old_ms, ms = _in_turns(torch, timer, old1, lambda: launcher.single(WT))
        old_graph_ms = graph_ms = None
        if small:
            old_graph_ms, graph_ms = _in_turns(
                torch, _graph_ms, old1, lambda: launcher.single(WT))
        l1 = None
        if launcher.generic and launcher.plan.clusters:
            # the windows' worth: the same bank with every diagonal read
            # through L1, in turns, and the same bits
            bare = _unstaged_launcher(dia_kernel, data, offs)
            check(torch.equal(bare.single(WT), y),
                  f"{name}: staged and unstaged results differ")
            l1 = _in_turns(torch, timer, lambda: bare.single(WT),
                           lambda: launcher.single(WT))
            if small:
                l1 += _in_turns(torch, _graph_ms, lambda: bare.single(WT),
                                lambda: launcher.single(WT))
            print(f"[kernel] {name}: windows staged / through L1, in turns: "
                  f"{_us(l1[1])} / {_us(l1[0])} us eager" + (
                      f", {_us(l1[3])} / {_us(l1[2])} us graph replay"
                      if small else "") + "; bit-equal: True", flush=True)
        plain_ms = _median_ms(torch, lambda: dia_kernel.dia_lincomb_plain(
            data, offs, WT), reps, inner)
        bound_ms, by, nbytes = _bound(n, m, ndiag, 1, data.element_size(),
                                      dtn)
        lib = _library_times(torch, data, offs, WT, WimT, y_plain, tol)
        lib_ms, lib_graph_ms = lib["mv"] if lib else (None, None)
        print(f"[kernel] {name}: n={n} m={m} ndiag={ndiag} {body} body "
              f"({launcher.plan or f'rows/thread={launcher.vec}'}) "
              f"max_rel_err="
              f"{rel:.3e} (tol {tol:g}) max_abs_err={abs_err:.3e} kernel "
              f"{ms * 1e3:.2f} us eager ({nbytes / ms / 1e6:.1f} GB/s), "
              f"{_us(graph_ms)} us graph replay; parent body "
              f"{_us(old_ms)} us eager, {_us(old_graph_ms)} us graph replay, "
              f"bit-equal to it: {same_as_parent} (max rel gap "
              f"{parent_rel}); plain "
              f"{plain_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.3f} us by {by} "
              f"({nbytes} B at 3.35 TB/s); sparse-CSR mv {_us(lib_ms)} us "
              f"eager, {_us(lib_graph_ms)} us graph replay", flush=True)
        check(rel <= tol, f"{name}: kernel disagrees with its twin "
                          f"(max rel err {rel:.3e} > {tol:g})")
        row = {"shape": name, "n": n, "m": m, "ndiag": ndiag, "body": body,
               "l1_ms": l1, "max_abs_err": abs_err, "ms": ms,
               "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
               "graph_ms": graph_ms, "parent_ms": old_ms,
               "parent_graph_ms": old_graph_ms,
               "library_graph_ms": lib_graph_ms,
               "gbs": nbytes / ms / 1e6, "nbytes": nbytes}
        rows[name] = row
        if not pair:
            continue
        # the pair kernel: against its twin, and equal to two single launches
        yre, yim = launcher.pair(WT, WimT)
        torch.cuda.synchronize()
        pre, pim = dia_kernel.dia_lincomb_pair_plain(data, offs, WT, WimT)
        p_abs = float(max((yre - pre).abs().max(), (yim - pim).abs().max()))
        p_rel = p_abs / float(max(pre.abs().max(), pim.abs().max()))
        y2 = launcher.single(WimT)
        equal = bool(torch.equal(yre, y) and torch.equal(yim, y2))
        if old2 is not None:
            pre_old, pim_old = old2()
            gap = float(max((yre - pre_old).abs().max(),
                            (yim - pim_old).abs().max())
                        / max(pre_old.abs().max(), pim_old.abs().max()))
            check(gap == 0 or (launcher.generic and gap <= tol),
                  f"{name}: pair differs from the parent body's ({gap:.3e})")
        old_pair_ms, pair_ms = _in_turns(
            torch, timer, old2, lambda: launcher.pair(WT, WimT))
        old_pair_graph_ms = pair_graph_ms = None
        if small:
            old_pair_graph_ms, pair_graph_ms = _in_turns(
                torch, _graph_ms, old2, lambda: launcher.pair(WT, WimT))

        def two_singles():
            launcher.single(WT)
            launcher.single(WimT)

        two_ms = _median_ms(torch, two_singles, reps, inner)
        pair_plain_ms = _median_ms(
            torch, lambda: dia_kernel.dia_lincomb_pair_plain(data, offs, WT,
                                                             WimT),
            reps, inner)
        pb_ms, pby, pbytes = _bound(n, m, ndiag, 2, data.element_size(), dtn)
        csr_ms = None
        if small and data.dtype == torch.float32:
            # the port's own CSR bank on the same operands (two applies)
            mats = [A.tocsr() for A in _bank_terms(data, offs)]
            csr = make_term_bank(mats, dtype=np.float32, fmt="csr",
                                 device=DEVICE)
            W, Wim = WT.T.contiguous(), WimT.T.contiguous()
            csr_ms = _median_ms(torch, lambda: (csr.lincomb_apply(W),
                                                csr.lincomb_apply(Wim)))
        lib_pair_ms, lib_pair_graph_ms = lib["mm"] if lib else (None, None)
        print(f"[kernel] {name} pair: max_rel_err={p_rel:.3e} (tol {tol:g}) "
              f"equal_to_two_singles={equal} pair {pair_ms * 1e3:.2f} us "
              f"eager ({pbytes / pair_ms / 1e6:.1f} GB/s), "
              f"{_us(pair_graph_ms)} us graph replay; parent body "
              f"{_us(old_pair_ms)} us eager, {_us(old_pair_graph_ms)} us "
              f"graph replay; 2x single {two_ms * 1e3:.2f} us; plain "
              f"{pair_plain_ms * 1e3:.2f} us; bound {pb_ms * 1e3:.3f} us by "
              f"{pby} ({pbytes} B); sparse-CSR mm {_us(lib_pair_ms)} us "
              f"eager, {_us(lib_pair_graph_ms)} us graph replay; CSR-bank x2 "
              f"{_us(csr_ms)} us", flush=True)
        check(p_rel <= tol, f"{name}: pair kernel disagrees with its twin "
                            f"(max rel err {p_rel:.3e} > {tol:g})")
        check(equal, f"{name}: pair kernel differs from two single launches")
        rows[name + " pair"] = {
            "shape": name, "n": n, "m": m, "ndiag": ndiag, "body": body,
            "max_abs_err": p_abs, "ms": pair_ms, "plain_ms": pair_plain_ms,
            "bound_ms": pb_ms, "bound_by": pby, "library_ms": lib_pair_ms,
            "graph_ms": pair_graph_ms, "parent_ms": old_pair_ms,
            "parent_graph_ms": old_pair_graph_ms,
            "library_graph_ms": lib_pair_graph_ms,
            "two_singles_ms": two_ms, "csr_bank_ms": csr_ms,
            "nbytes": pbytes}
    # same-run bandwidth reference: a device copy of 1 GiB (20x the L2)
    x = torch.empty(2**28, dtype=torch.float32, device=DEVICE)
    x.normal_(generator=gen)
    y = torch.empty_like(x)
    copy_ms = _median_ms(torch, lambda: y.copy_(x), reps=5, inner=5)
    copy_gbs = 2 * x.numel() * 4 / copy_ms / 1e6
    head = rows["headline f32"]
    print(f"[kernel] stream copy 1 GiB: {copy_ms * 1e3:.1f} us = "
          f"{copy_gbs:.1f} GB/s; headline kernel at "
          f"{head['gbs'] / copy_gbs:.3f} of it (bank 144 MB, W 16 MB); "
          "bounds at the copy rate: " + ", ".join(
              f"{k} {r['nbytes'] / copy_gbs / 1e3:.3f} us"
              for k, r in rows.items() if "nbytes" in r), flush=True)
    del x, y
    return rows


def _bank_terms(data, offs):
    """scipy CSR terms of a DIA bank held on the device."""
    from neptpu_torch.ops.dia import DiaTermBank

    n = data.shape[2]
    return DiaTermBank(data, offs, (n, n)).host_csr_terms()


def phase_spmv_path(torch, dia_kernel):
    """Main path step: the SpMV headline through the bank's own apply."""
    import scipy.sparse as sp

    from neptpu_torch.ops.sparse import make_term_bank

    rng = np.random.default_rng(0)
    n, w = HEADLINE_N, int(round(np.sqrt(HEADLINE_N)))
    offs = (-w - 1, -w, -w + 1, -1, 0, 1, w - 1, w, w + 1)
    t0 = time.perf_counter()
    mats = [sp.diags([rng.standard_normal(n - abs(o)).astype(np.float32)
                      for o in offs], offs, shape=(n, n), format="csr")
            for _ in range(HEADLINE_M)]
    dia_kernel.DIA_SPMV.reset_counts()
    bank = make_term_bank(mats, dtype=np.float32, device=DEVICE)
    t_build = time.perf_counter() - t0
    # the operand term-major (terms, n), as the scans hold theirs
    WT = torch.from_numpy(rng.standard_normal((HEADLINE_M, n)).astype(
        np.float32)).to(DEVICE)
    W = WT.T.contiguous()  # the same operand row-major (n, terms)
    ncalls = 50
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)

    def per_apply(apply, operand):
        """(result, ms per apply) over ``ncalls`` back-to-back applies."""
        y = apply(operand)
        torch.cuda.synchronize()
        a.record()
        for _ in range(ncalls):
            y = apply(operand)
        b.record()
        b.synchronize()
        return y, a.elapsed_time(b) / ncalls

    y, ms = per_apply(bank.lincomb_apply_t, WT)
    y_rows, ms_rows = per_apply(bank.lincomb_apply, W)
    counts = dict(dia_kernel.DIA_SPMV.counts)
    # correctness by the repo's own means: the scipy terms themselves
    ref = sum(A @ WT[i].cpu().numpy() for i, A in enumerate(mats))
    rel = float(np.abs(y.cpu().numpy() - ref).max() / np.abs(ref).max())
    nnz = sum(A.nnz for A in mats)
    print(f"[main] spmv headline n={n} terms={HEADLINE_M} ndiag={len(offs)} "
          f"({type(bank).__name__}): {ms * 1e3:.2f} us per apply = "
          f"{nnz / ms / 1e6:.2f} Gnnz/s term-major (lincomb_apply_t), "
          f"{ms_rows * 1e3:.2f} us per apply row-major (lincomb_apply: "
          f"transpose copy + kernel), max_rel_err vs scipy {rel:.3e}, "
          f"host build {t_build:.2f} s, launches {counts}", flush=True)
    check(rel <= 1e-5, f"headline apply disagrees with scipy ({rel:.3e})")
    check(torch.equal(y, y_rows), "headline: the row-major entry differs "
                                  "from the term-major one")
    check(counts["dia_lincomb"] == 2 * (ncalls + 1),
          f"headline path launched the kernel {counts['dia_lincomb']} times "
          f"in {2 * (ncalls + 1)} applies")

    # the same bank at half width: bfloat16 values and operand, float32 sums
    bank16 = bank.astype(torch.bfloat16)
    W16, W16b = WT.to(torch.bfloat16), WT.flip(1).to(torch.bfloat16)
    y16, ms16 = per_apply(bank16.lincomb_apply_t, W16)
    y16_rows, ms16_rows = per_apply(bank16.lincomb_apply, W16.T.contiguous())
    yre, yim = bank16.lincomb_apply_pair_t(W16, W16b)
    torch.cuda.synchronize()
    entry = dict(dia_kernel.DIA_SPMV.entry_counts)
    # rounding bank and operand to bfloat16 moves each product by at most
    # 2^-8 of itself (2^-9 per factor): |dy[r]| <= 2^-7 sum |data W| holds
    # with room for the float32 sum
    worst = 0.0
    for yk, Wk in ((y16, WT), (yre, WT), (yim, WT.flip(1))):
        Wh = Wk.cpu().numpy().astype(np.float64)
        refk = sum(A @ Wh[i] for i, A in enumerate(mats))
        room = sum(abs(A) @ np.abs(Wh[i]) for i, A in enumerate(mats))
        worst = max(worst, float(np.max(
            np.abs(yk.cpu().numpy() - refk) / np.maximum(room, 1e-30))))
    print(f"[main] spmv headline bf16 bank ({bank16.data.dtype} -> "
          f"{y16.dtype}): {ms16 * 1e3:.2f} us per apply = "
          f"{nnz / ms16 / 1e6:.2f} Gnnz/s ({ms / ms16:.2f}x the float32 "
          f"apply) term-major, {ms16_rows * 1e3:.2f} us row-major, single "
          f"and pair max |dy| / sum|data W| per row "
          f"{worst:.3e} (bound 2^-7 = {2**-7:.3e}), launches "
          f"{ {k: v for k, v in entry.items() if v} }", flush=True)
    check(y16.dtype == torch.float32 and yre.dtype == torch.float32,
          "bf16 apply did not return float32")
    check(worst <= 2**-7, f"bf16 headline apply off by {worst:.3e} of its "
                          "row's sum |data W| (bound 2^-7)")
    check(torch.equal(y16, y16_rows), "bf16 headline: the row-major entry "
                                      "differs from the term-major one")
    check(entry["dia_lincomb_bf16"] == 2 * (ncalls + 1)
          and entry["dia_lincomb_pair_bf16"] == 1,
          f"bf16 headline applies launched {entry}")
    return {"counts": dict(dia_kernel.DIA_SPMV.counts), "entry": entry,
            "y": y.cpu().numpy()}


# [generic]: a quartic PEP (5 terms) on the SpMV headline's 9-offset stencil
# at n = 1e6, the bank kernel B1's narrow body (<= 4 terms) does not take;
# two shifts, three derivative columns
GENERIC = dict(terms=5, lams=(0.7, -0.4 + 0.3j), ncols=3, budget=120.0)


def quartic_matrices(seed):
    """Five seeded 9-offset stencil matrices at the SpMV headline's shape
    (scipy CSR, float64) and their offsets."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n, w = HEADLINE_N, int(round(np.sqrt(HEADLINE_N)))
    offs = (-w - 1, -w, -w + 1, -1, 0, 1, w - 1, w, w + 1)
    return [sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                     shape=(n, n), format="csr")
            for _ in range(GENERIC["terms"])], offs


def pep_coefficients(degree, lam, ncols):
    """``C[d, j] = d! / (d - j)! lam^(d - j)`` (zero for j > d): the weight
    of ``A_d V[:, j]`` in ``sum_j M^(j)(lam) V[:, j]``, on the host."""
    import math

    C = np.zeros((degree + 1, ncols), dtype=complex)
    for d in range(degree + 1):
        for j in range(min(d, ncols - 1) + 1):
            C[d, j] = math.perm(d, j) * complex(lam) ** (d - j)
    return C


def phase_generic(torch, dia_kernel, seed):
    """[generic]: the quartic PEP through ``PEP(...)`` and
    ``compute_Mlincomb`` (complex128 and float32 operands, two shifts, three
    derivative columns), then its bank through the entries the scans use
    (float32 single and re/im pair, bfloat16 single), each against a host
    scipy CSR float64 product; every launch on the generic body.  Returns
    the launches by entry point."""
    import scipy.sparse as sp

    from neptpu_torch import PEP, compute_Mlincomb
    from neptpu_torch.ops.dia import DiaTermBank

    t0 = time.perf_counter()
    mats, offs = quartic_matrices(seed)
    n, m, k = HEADLINE_N, GENERIC["terms"], GENERIC["ncols"]
    stack = sp.vstack(mats, format="csr")  # the host reference's operator
    rng = np.random.default_rng(seed + 1)
    V = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
    V32 = rng.standard_normal((n, k)).astype(np.float32)

    def host(lam, X):
        """sum_j M^(j)(lam) X[:, j] from the scipy terms in float64."""
        T = np.asarray(stack @ X).reshape(m, n, k)
        return np.einsum("dnk,dk->n", T, pep_coefficients(m - 1, lam, k))

    def rel(y, ref):
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
        return float(np.abs(y - ref).max() / np.abs(ref).max())

    dia_kernel.DIA_SPMV.reset_counts()
    nep = PEP(mats, device=DEVICE)  # float64 bank
    nep32 = PEP(mats, dtype=np.float32, device=DEVICE)
    t_build = time.perf_counter() - t0
    for p in (nep, nep32):
        check(isinstance(p.bank, DiaTermBank) and p.bank.nterms == m
              and p.bank.offsets == tuple(sorted(offs)),
              f"the quartic PEP's bank is {type(p.bank).__name__} "
              f"({getattr(p.bank, 'nterms', '?')} terms), not a {m}-term "
              "DiaTermBank on the stencil's offsets")
        check(dia_kernel.is_generic(p.bank.nterms, p.bank.ndiag),
              "the quartic PEP's bank would run the narrow body")
    errs = {}
    Vd, V32d = torch.from_numpy(V).to(DEVICE), torch.from_numpy(V32).to(DEVICE)
    for lam in GENERIC["lams"]:
        # the user's entry point: complex128 and float32 operands
        y = compute_Mlincomb(nep, lam, Vd)
        errs[f"Mlincomb c128 lam={lam}"] = (rel(y, host(lam, V)), 1e-12)
        y = compute_Mlincomb(nep32, lam, V32d)
        errs[f"Mlincomb f32 lam={lam}"] = (
            rel(y, host(lam, V32.astype(np.float64))), 1e-5)
    # the scans' entries on the float32 bank: the operand term-major
    C = pep_coefficients(m - 1, GENERIC["lams"][0], k).real
    WT = torch.from_numpy((C @ V32.T.astype(np.float64)).astype(
        np.float32)).to(DEVICE)
    ref = host(GENERIC["lams"][0], V32.astype(np.float64))
    errs["bank f32 single"] = (rel(nep32.bank.lincomb_apply_t(WT), ref), 1e-5)
    Cc = pep_coefficients(m - 1, GENERIC["lams"][1], k)
    Wc = Cc @ V32.T.astype(np.float64)
    WreT = torch.from_numpy(Wc.real.astype(np.float32)).to(DEVICE)
    WimT = torch.from_numpy(Wc.imag.astype(np.float32)).to(DEVICE)
    yre, yim = nep32.bank.lincomb_apply_pair_t(WreT, WimT)
    errs["bank f32 pair"] = (
        rel(torch.complex(yre.double(), yim.double()),
            host(GENERIC["lams"][1], V32.astype(np.float64))), 1e-5)
    # bfloat16 bank and operand (float32 sums): within the bound of rounding
    # both factors, |dy[r]| <= 2^-7 sum |data W| (as the headline's bf16 path)
    bank16 = nep32.bank.astype(torch.bfloat16)
    W16 = WT.to(torch.bfloat16)
    y16 = bank16.lincomb_apply_t(W16)
    Wh = W16.float().cpu().numpy().astype(np.float64)
    ref16 = sum(A @ Wh[i] for i, A in enumerate(mats))
    room = sum(abs(A) @ np.abs(Wh[i]) for i, A in enumerate(mats))
    worst16 = float(np.max(np.abs(y16.cpu().numpy() - ref16)
                           / np.maximum(room, 1e-30)))
    torch.cuda.synchronize()
    entry = dict(dia_kernel.DIA_SPMV.entry_counts)
    generic = dict(dia_kernel.DIA_SPMV.generic_counts)
    wall = time.perf_counter() - t0
    print(f"[generic] quartic PEP n={n} terms={m} offsets={len(offs)} "
          f"({type(nep.bank).__name__}, {nep.bank.data.dtype} and "
          f"{nep32.bank.data.dtype}) built in {t_build:.3f} s; plan "
          f"{nep32.bank.launcher(torch.float32).plan}", flush=True)
    for what, (err, tol) in errs.items():
        print(f"[generic] {what}: max_rel_err vs host CSR float64 "
              f"{err:.3e} (tol {tol:g})", flush=True)
        check(err <= tol, f"[generic] {what} off by {err:.3e} (> {tol:g})")
    print(f"[generic] bank bf16 single: max |dy| / sum|data W| per row "
          f"{worst16:.3e} (bound 2^-7 = {2**-7:.3e}); launches "
          f"{ {e: v for e, v in entry.items() if v} }, on the generic body "
          f"{ {e: v for e, v in generic.items() if v} }; phase {wall:.3f} s "
          f"(budget {GENERIC['budget']:g} s)", flush=True)
    check(worst16 <= 2**-7, f"[generic] bf16 apply off by {worst16:.3e}")
    check(generic == entry, "a [generic] launch went to the narrow body")
    want = {"dia_lincomb_pair_f64": 4, "dia_lincomb_f32": 1,
            "dia_lincomb_pair_f32": 1, "dia_lincomb_bf16": 1}
    check({e: v for e, v in entry.items() if v} == want,
          f"[generic] launched {entry}, expected {want}")
    check(wall <= GENERIC["budget"],
          f"[generic] took {wall:.1f} s (> {GENERIC['budget']:g} s)")
    return entry


def run_time_to_tol(torch, dia_kernel, key, make_nep, sigma, gamma=1.0,
                    maxit=60, neigs=10, tol=1e-6, tol_refine=1e-9,
                    tol_gate=1e-9, k_target=10, need=10, pinned=None,
                    refine_backend="auto", report_backend=None):
    """One ``bench.py`` time-to-tolerance phase on the card: problem ->
    float32 scan (one shift or several) -> cluster -> ``newton_refine``
    with ``refine_backend``, gated.  ``report_backend``: refine the same
    candidates once more with that backend, after the timed wall, and print
    its count and time without gating.  Returns the launch counts, the
    problem's terms and the candidates handed to the refinement."""
    from neptpu_torch.solvers.refine import newton_refine
    from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                                iar_real_spmf,
                                                iar_real_spmf_multishift)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dia_kernel.DIA_SPMV.reset_counts()
    t_start = time.perf_counter()
    nep = make_nep()
    mats, fv = collect_spmf_terms(nep)
    backward = backward_errmeasure(mats, fv)
    t = {"problem": time.perf_counter() - t_start, "bank": 0.0,
         "cluster": 0.0, "refine": 0.0}
    kw = dict(gamma=gamma, maxit=maxit, neigs=neigs, tol=tol,
              check_error_every=20, dtype=torch.float32, errmeasure=backward,
              precision="highest", return_info=True, device=DEVICE)
    if isinstance(sigma, list):
        lams, Q, minfo = iar_real_spmf_multishift(nep, sigma, **kw)
        per = minfo["per_shift"]
        t["bank"] = minfo["t_bank"]
    else:
        lams, Q, info = iar_real_spmf(nep, sigma=sigma, **kw)
        per = [info]
        t["bank"] = info["t_bank"]
    torch.cuda.synchronize()
    lams, Q = np.asarray(lams), np.asarray(Q)
    t0 = time.perf_counter()
    errs0 = np.array([backward(complex(lams[j]), Q[:, j])
                      for j in range(len(lams))])
    reps = cluster_candidates(lams, errs0, keep=k_target + 6)
    cand = (lams[reps], Q[:, reps])
    t1 = time.perf_counter()
    rkw = dict(nsweeps=3, tol=tol_refine, errmeasure=backward,
               dtype=torch.float32, ir=3, shift_rel=1e-8,
               target_distinct=k_target, device=DEVICE)
    stats = {"chip_shifts": 0, "host_fallback_shifts": 0}
    lams, Q, errs = newton_refine(mats, fv, *cand, backend=refine_backend,
                                  stats=stats, **rkw)
    t["cluster"] = t1 - t0
    t["refine"] = time.perf_counter() - t1
    sel = distinct_below_tol(lams, errs, tol_gate)
    wall = time.perf_counter() - t_start
    counts = dict(dia_kernel.DIA_SPMV.counts)
    entry = dict(dia_kernel.DIA_SPMV.entry_counts)
    k_done = [int(i["k_done"]) for i in per]

    def tsum(name):
        return sum(i[name] for i in per)

    print(f"[main] {key} n={nep.n} terms={len(fv)} shifts={len(per)}: "
          f"k_done={k_done} nconv={[int(i['nconv']) for i in per]} "
          f"scaled={[bool(i['scaled']) for i in per]} candidates="
          f"{len(cand[0])} refine={refine_backend} "
          f"distinct<={tol_gate:g}={len(sel)} "
          f"max_backward={max(errs[sel]) if sel else float('nan'):.3e} "
          f"max_backward_candidates={max(errs):.3e} refine_shifts_on_card="
          f"{stats['chip_shifts']} refine_shifts_fallen_back_to_host="
          f"{stats['host_fallback_shifts']} launches={counts}", flush=True)
    print(f"[main] {key} t_problem={t['problem']:.3f} s t_bank="
          f"{t['bank']:.3f} s t_table={tsum('t_table'):.3f} s t_factorize="
          f"{tsum('t_factorize'):.3f} s t_scan={tsum('t_scan'):.3f} s "
          f"(host checks {tsum('t_check'):.3f} s; graph capture "
          f"{sum(i['graph']['capture_s'] for i in per):.4f} s, replays "
          f"{[i['graph']['replays'] for i in per]}) t_cluster="
          f"{t['cluster']:.3f} s t_refine={t['refine']:.3f} s "
          f"wall={wall:.3f} s peak_device_mem="
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    check(bool(np.isfinite(lams).all() and np.isfinite(errs).all()),
          f"{key}: non-finite refined pairs")
    check(len(sel) >= need, f"{key}: only {len(sel)} distinct pairs at "
                            f"backward error <= {tol_gate:g} (need {need})")
    if pinned is not None:
        matched = sum(1 for j in sel
                      if np.min(np.abs(pinned - lams[j])) / abs(lams[j])
                      < 1e-9)
        print(f"[main] {key} matched_pinned={matched}", flush=True)
        check(matched >= need, f"{key}: only {matched} pairs within rel 1e-9 "
                               f"of the pinned oracle (need {need})")
    check(counts["dia_lincomb_pair"] >= sum(k_done),
          f"{key}: pair kernel launched {counts['dia_lincomb_pair']} times "
          f"in {sum(k_done)} scan steps (need >= 1 per step)")
    if refine_backend == "chip":
        check(stats["chip_shifts"] > 0
              and stats["host_fallback_shifts"] <= MAX_HOST_FALLBACK,
              f"{key}: chip refinement solved {stats['chip_shifts']} shifts "
              f"on the card and {stats['host_fallback_shifts']} on the host "
              f"(at most {MAX_HOST_FALLBACK} may fall back)")
    if report_backend is not None:
        t0 = time.perf_counter()
        rl, _, re_ = newton_refine(mats, fv, *cand, backend=report_backend,
                                   **rkw)
        rsel = distinct_below_tol(rl, re_, tol_gate)
        print(f"[main] {key} (not gated) the same {len(cand[0])} candidates "
              f"with refine={report_backend}: distinct<={tol_gate:g}="
              f"{len(rsel)} max_backward="
              f"{max(re_[rsel]) if rsel else float('nan'):.3e} "
              f"stalled_at={['%.3e' % e for e in sorted(re_) if e >= tol_gate]} "
              f"t_refine={time.perf_counter() - t0:.3f} s", flush=True)
    return {"counts": counts, "entry": entry, "mats": mats, "fv": fv,
            "backward": backward, "refined": lams[sel],
            "cand": cand, "t_scan": tsum("t_scan"),
            "t_check": tsum("t_check"), "k_done": k_done}


def wep_nep(cfg):
    from neptpu_torch import nep_gallery

    return nep_gallery("waveguide", nx=cfg["nx"], nz=cfg["nz"],
                       benchmark_problem="JARLEBRING", neptype="SPMF",
                       device=DEVICE)


def phase_wep(torch, dia_kernel, key, cfg):
    return run_time_to_tol(
        torch, dia_kernel, key, lambda: wep_nep(cfg), list(cfg["sigmas"]),
        maxit=100, neigs=8, tol=1e-5, refine_backend="chip",
        report_backend="auto")


def phase_wep_bank_share(torch, key, cfg, out):
    """Where a waveguide scan step's bank apply goes: the whole split apply
    against its DIA main part alone (the rest is the stacked low-rank group
    apply, plain PyTorch), beside the scan's time per step.  The bank is the
    one the scan builds from these terms; its DIA part must have the shape
    at which the kernel checks held the pair kernel against its twin."""
    from neptpu_torch.ops.mixed import make_mixed_bank

    bank = make_mixed_bank(out["mats"], dtype=np.float32, device=DEVICE)
    built = (bank.inner.nterms, tuple(bank.inner.offsets), bank.n)
    check(built == wep_bank_shape(cfg),
          f"{key}: the main path's DIA bank is (m, offsets, n) = {built}, "
          f"the kernel checks ran at {wep_bank_shape(cfg)}")
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    # the scan hands the bank its term-major (terms, n) products
    WreT = torch.randn((bank.nterms, bank.n), generator=gen, device=DEVICE)
    WimT = torch.randn((bank.nterms, bank.n), generator=gen, device=DEVICE)
    full = _median_ms(torch, lambda: bank.lincomb_apply_split_t(WreT, WimT))
    main = _median_ms(torch, lambda: bank._main_pair(WreT, WimT))
    # a step's wall without the host Ritz checks between the chunks
    step = (out["t_scan"] - out["t_check"]) / max(sum(out["k_done"]), 1) * 1e3
    ranks = [0 if L is None else L.shape[1] for L in (bank.Lr, bank.Li)]
    print(f"[bank] {key} mixed bank: main {type(bank.inner).__name__} m="
          f"{bank.inner.nterms} offsets={bank.inner.offsets}, low-rank "
          f"columns re/im {ranks}; split apply {full * 1e3:.1f} us, its DIA "
          f"pair launch {main * 1e3:.1f} us, low-rank groups "
          f"{(full - main) * 1e3:.1f} us = {100 * (full - main) / full:.1f}% "
          f"of the apply, {100 * (full - main) / step:.1f}% of a "
          f"{step:.3f} ms scan step", flush=True)


def _conj_gap(x, pool):
    """Relative distance from ``x`` to the nearest of ``pool`` or its
    conjugates (the delay problem is real: its spectrum is closed under
    conjugation, and a solver may land on either member of a pair)."""
    pool = np.asarray(pool)
    return float(min(np.min(np.abs(pool - x)),
                     np.min(np.abs(pool - np.conj(x)))) / abs(x))


def dep_problem(nside):
    """``benchmarks/time_to_tol.py``'s problem on the card: the gallery's
    ``dep_symm_double`` with its bank rebuilt in float32, the host backward
    error of that script, and the float64 gallery problem."""
    from neptpu_torch import DEP, nep_gallery
    from neptpu_torch.ops.dia import DiaTermBank

    nep0 = nep_gallery("dep_symm_double", nside, device=DEVICE)
    mats = nep0.bank.host_csr_terms()
    bank = DiaTermBank.from_matrices(mats, dtype=np.float32, device=DEVICE)
    nep = DEP(None, tauv=nep0.tauv, bank=bank)

    def backward_of(problem):
        """``time_to_tol.py:77-84``'s measure on ``problem``'s own operands
        (the float32-valued bank or the gallery's float64 one)."""
        return dep_backward(problem)[0]

    return nep, nep0, mats, backward_of


def phase_dep(torch, dia_kernel, cfg):
    """Main path of the delay family: ``iar_real`` then ``tiar_real`` in
    float32 at the settings of ``benchmarks/time_to_tol.py`` (all ``maxit``
    Ritz pairs returned, their backward errors measured on the host in
    float64), then the bank applied in its three precisions."""
    from neptpu_torch import iar_real, tiar_real

    t0 = time.perf_counter()
    nep, nep0, mats, backward_of = dep_problem(cfg["nside"])
    backward = backward_of(nep)
    t_problem = time.perf_counter() - t0
    bank = nep.bank
    built = (bank.nterms, tuple(bank.offsets), bank.n)
    check(type(bank).__name__ == "DiaTermBank"
          and built == dep_bank_shape(cfg["nside"]),
          f"dep: the bank is {type(bank).__name__} (m, offsets, n) = {built},"
          f" the kernel checks ran at {dep_bank_shape(cfg['nside'])}")
    out = {"nep": nep, "nep0": nep0, "backward64": backward_of(nep0),
           "entry": {}}
    m, k, tol = cfg["maxit"], cfg["k"], cfg["tol"]
    for name, solver in (("iar_real", iar_real), ("tiar_real", tiar_real)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dia_kernel.DIA_SPMV.reset_counts()
        t0 = time.perf_counter()
        lams, Q, info = solver(nep, sigma=cfg["sigma"], maxit=m, neigs=m,
                               tol=np.inf, dtype=torch.float32,
                               return_info=True, device=DEVICE)
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
        entry = dict(dia_kernel.DIA_SPMV.entry_counts)
        counts = dict(dia_kernel.DIA_SPMV.counts)
        t1 = time.perf_counter()
        errs = np.array([backward(complex(l), Q[:, i])
                         for i, l in enumerate(lams)])
        t_err = time.perf_counter() - t1
        order = np.argsort(errs)
        lams, Q, errs = np.asarray(lams)[order], Q[:, order], errs[order]
        nconv = int(np.sum(errs < tol))
        print(f"[dep] {name} n={nep.n} terms={bank.nterms} ndiag="
              f"{bank.ndiag} sigma={cfg['sigma']} maxit={m} float32: k_done="
              f"{info['k_done']} scaled={info.get('scaled')} ritz_pairs="
              f"{len(lams)} converged(backward<={tol:g})={nconv} (need {k}) "
              f"best10_max_backward={errs[:k].max():.3e} t_factorize="
              f"{info['t_factorize']:.3f} s t_scan={info['t_scan']:.3f} s "
              f"t_check={info['t_check']:.3f} s (graph capture "
              f"{info['graph']['capture_s']:.4f} s, "
              f"{info['graph']['replays']} replays) t_host_errors="
              f"{t_err:.3f} s "
              f"wall={t_solve + t_err:.3f} s launches="
              f"{ {k_: v for k_, v in entry.items() if v} } peak_device_mem="
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
              flush=True)
        check(bool(np.isfinite(lams).all() and np.isfinite(errs).all()),
              f"dep {name}: non-finite Ritz pairs")
        check(Q.shape == (nep.n, len(lams)), f"dep {name}: Q is {Q.shape}")
        check(nconv >= k, f"dep {name}: only {nconv} Ritz pairs at backward "
                          f"error <= {tol:g} (need {k})")
        check(entry["dia_lincomb_pair_f32"] == info["k_done"]
              and counts["dia_lincomb"] == 0,
              f"dep {name}: {info['k_done']} scan steps launched {entry} "
              "(need one float32 pair launch per step and no single launch)")
        out[name] = (lams, Q, errs, nconv)
        out["entry"][name] = entry
    print(f"[dep] problem built in {t_problem:.3f} s; eigenvalues (best 10 "
          f"of iar_real): {np.array2string(out['iar_real'][0][:k], precision=8)}",
          flush=True)
    # the two solvers agree on their best pairs (the other's converged set)
    gaps = []
    for a, b in (("iar_real", "tiar_real"), ("tiar_real", "iar_real")):
        pool = out[b][0][: out[b][3]]
        gaps += [_conj_gap(x, pool) for x in out[a][0][:k]]
    print(f"[dep] iar_real vs tiar_real, best {k} of each against the "
          f"other's converged pairs: max rel eigenvalue gap {max(gaps):.3e} "
          "(gate 1e-5, modulo conjugation)", flush=True)
    check(max(gaps) <= 1e-5, f"dep: iar_real and tiar_real eigenvalues "
                             f"differ by rel {max(gaps):.3e} (> 1e-5)")

    # the bank itself in its three precisions, applied to the best Ritz
    # vector: single apply on the real part, pair apply on re/im, against
    # the scipy terms
    dia_kernel.DIA_SPMV.reset_counts()
    lam, q = out["iar_real"][0][0], out["iar_real"][1][:, 0]
    w = np.exp(-nep.tauv * lam)  # term weights at lam
    W = q[:, None] * w[None, :]
    ref = sum(A @ W[:, i] for i, A in enumerate(mats))
    room = sum(abs(A) @ np.abs(W[:, i]) for i, A in enumerate(mats))
    for dt, bound in ((torch.float32, 2**-20), (torch.float64, 2**-48),
                      (torch.bfloat16, 2**-7)):
        # (the float64 bank is the gallery problem's own, not a widened copy)
        bk = out["nep0"].bank if dt == torch.float64 else bank.astype(dt)
        Wre = torch.as_tensor(W.real, device=DEVICE).to(dt)
        Wim = torch.as_tensor(W.imag, device=DEVICE).to(dt)
        y1 = bk.lincomb_apply(Wre)
        yre, yim = bk.lincomb_apply_pair(Wre, Wim)
        torch.cuda.synchronize()
        y = yre.cpu().numpy().astype(np.float64) + 1j * yim.cpu().numpy()
        off = float(np.max(np.abs(y - ref) / np.maximum(room, 1e-300)))
        check(torch.equal(y1, yre), f"dep bank {dt}: single and pair differ")
        print(f"[dep] bank apply in {dt} -> {yre.dtype}: max |dy| / "
              f"sum|data W| per row {off:.3e} (bound {bound:.3e})",
              flush=True)
        check(off <= bound, f"dep bank apply in {dt} off by {off:.3e} of "
                            f"its row's sum |data W| (bound {bound:.3e})")
    out["entry"]["bank"] = dict(dia_kernel.DIA_SPMV.entry_counts)
    return out


def perturbed_start(dep, cfg, nearest=False):
    """The best-isolated of the float32 ``[dep]`` run's first ``k``
    converged pairs (``nearest``: the one nearest sigma), eigenvalue and
    vector perturbed by 1e-3: ``(index, separations, lam0, v0)``."""
    found32 = dep["iar_real"][0][: dep["iar_real"][3]]
    sep = [np.min(np.abs(np.delete(found32, i) - x)) for i, x in
           enumerate(found32)]
    i0 = int(np.argmin(np.abs(found32[: cfg["k"]] - cfg["sigma"])) if nearest
             else np.argmax(sep[: cfg["k"]]))
    rng = np.random.default_rng(0)
    q = dep["iar_real"][1][:, i0]
    n = q.shape[0]
    lam0 = complex(found32[i0]) * (1 + 1e-3)
    v0 = q + 1e-3 * np.linalg.norm(q) / np.sqrt(n) * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return i0, sep, lam0, v0


def phase_dep_protocol(torch, dia_kernel, cfg, dep):
    """The same delay problem through the protocol solvers on the card, in
    complex128 on the gallery's float64 operands.

    The eigenvalues they converge to are held to rel 1e-6 against those
    ``iar_real`` finds in float64 on the same operands.  The float32 run of
    the ``[dep]`` phase gives the starting pairs; how far its eigenvalues are
    from the float64 ones is printed, not gated: with entries near h^-4 ~
    1e7, rounding the bank to float32 and factoring M(sigma) in float32 move
    the eigenvalues near -1 by more than 1e-6 (about 2e-5 at n = 3600), though
    their backward errors are 1e-9."""
    from neptpu_torch import (FactorizeLinSolverCreator,
                              NoConvergenceException, augnewton, iar,
                              iar_real, newton, quasinewton, resinv, tiar)

    nep = dep["nep0"]
    dia_kernel.DIA_SPMV.reset_counts()
    t0 = time.perf_counter()
    l64, Q64, info = iar_real(nep, sigma=cfg["sigma"], maxit=cfg["maxit"],
                              neigs=cfg["maxit"], tol=np.inf,
                              dtype=torch.float64, return_info=True,
                              device=DEVICE)
    torch.cuda.synchronize()
    e64 = np.array([dep["backward64"](complex(l), Q64[:, i])
                    for i, l in enumerate(l64)])
    found = np.asarray(l64)[e64 < 1e-12]
    entry64 = dict(dia_kernel.DIA_SPMV.entry_counts)
    gap32 = sorted(_conj_gap(x, np.asarray(l64))
                   for x in dep["iar_real"][0][: cfg["k"]])
    print(f"[dep-protocol] iar_real float64 maxit={cfg['maxit']}: "
          f"{len(found)} Ritz pairs at backward error < 1e-12 in "
          f"{time.perf_counter() - t0:.3f} s (t_factorize "
          f"{info['t_factorize']:.3f} s, t_scan {info['t_scan']:.3f} s), "
          f"launches { {k: v for k, v in entry64.items() if v} }; (not gated) the "
          f"float32 run's best {cfg['k']} eigenvalues, found on the bank "
          f"rounded to float32, lie within rel {gap32[len(gap32) // 2]:.3e} "
          f"(median) and {gap32[-1]:.3e} (max) of this run's Ritz values",
          flush=True)
    check(len(found) >= cfg["k"], f"dep-protocol: float64 iar_real found "
                                  f"only {len(found)} pairs")
    check(entry64["dia_lincomb_pair_f64"] >= info["k_done"],
          f"dep-protocol: float64 scan launched {entry64}")
    torch.cuda.reset_peak_memory_stats()
    for name, solver in (("tiar", tiar), ("iar", iar)):
        t0 = time.perf_counter()
        try:
            lams, Q, _ = solver(nep, sigma=cfg["sigma"], maxit=30, neigs=4,
                                linsolvercreator=FactorizeLinSolverCreator(),
                                v=np.ones(nep.n), device=DEVICE)
        except NoConvergenceException as e:
            raise SmokeFailure(f"dep-protocol {name}: {e}")
        torch.cuda.synchronize()
        gaps = [_conj_gap(x, found) for x in lams]
        print(f"[dep-protocol] {name} complex128 maxit=30 n={nep.n} "
              f"(FactorizeLinSolver): {len(lams)} pairs at its default "
              f"tolerance in {time.perf_counter() - t0:.3f} s, max rel gap "
              f"to float64 iar_real's eigenvalues {max(gaps):.3e} (gate 1e-6)",
              flush=True)
        check(len(lams) >= 4 and Q.device.type == DEVICE
              and max(gaps) <= 1e-6,
              f"dep-protocol {name}: {len(lams)} pairs, gap {max(gaps):.3e}")
    # Newton family from the best-isolated converged pair, perturbed by 1e-3
    i0, sep, lam0, v0 = perturbed_start(dep, cfg)
    for name, solver in (("resinv", resinv), ("augnewton", augnewton),
                         ("quasinewton", quasinewton), ("newton", newton)):
        t0 = time.perf_counter()
        try:
            lam, v = solver(nep, lam=lam0, v=v0, device=DEVICE)
        except NoConvergenceException as e:
            raise SmokeFailure(f"dep-protocol {name} from {lam0}: {e}; last "
                               f"iterate {e.lam}, error {e.errmeasure}")
        torch.cuda.synchronize()
        gap = _conj_gap(complex(lam), found)
        print(f"[dep-protocol] {name} from lam={lam0:.8f} (iar_real pair "
              f"{i0}, separation {sep[i0]:.2e}): lam={complex(lam):.12f} in "
              f"{time.perf_counter() - t0:.3f} s, rel gap to float64 "
              f"iar_real's eigenvalues {gap:.3e} (gate 1e-6)", flush=True)
        check(v.device.type == DEVICE and v.shape == (nep.n,)
              and gap <= 1e-6,
              f"dep-protocol {name}: gap {gap:.3e} to iar_real's eigenvalues")
    entry = dict(dia_kernel.DIA_SPMV.entry_counts)
    print(f"[dep-protocol] launches { {k: v for k, v in entry.items() if v} } "
          f"peak_device_mem {torch.cuda.max_memory_allocated() / 2**20:.1f} "
          "MiB", flush=True)
    check(entry["dia_lincomb_pair_f64"] > 0,
          "dep-protocol: compute_Mlincomb launched no float64 pair kernel")
    return entry, found, (np.asarray(l64), np.asarray(Q64), e64)


def _separation(lams):
    """Smallest pairwise relative distance of ``lams`` (inf for one)."""
    lams = np.asarray(lams)
    return min((abs(a - b) / abs(a) for i, a in enumerate(lams)
                for b in lams[i + 1:]), default=np.inf)


def phase_dep_deflation(torch, dia_kernel, cfg, dep, found):
    """The deflation/projection family on the same float64 delay problem in
    complex128: ``jd_effenberger`` (Effenberger deflation: the padded DIA
    bank through the pair kernel plus the low-rank factor terms, the
    Schur-complement solve from the second level on), ``jd_betcke``
    (Petrov-Galerkin), ``nlar`` and ``iar``/``tiar`` with
    ``proj_solve=True``, each against the eigenvalues float64 ``iar_real``
    found in ``[dep-protocol]``.

    The tolerances come from the problem's scale ``s = |sigma| sqrt(n) +
    sum_i |exp(-tau_i sigma)| ||A_i||_F`` (~6e8: the bank's entries reach
    ~1e7): ``jd_effenberger``'s absolute residual tolerance is 1e-11 s,
    the others measure the backward error (relative to the same sum) and
    take 1e-12, or their default.  ``jd_effenberger`` hands its inner solver
    tol/10 and accepts a projected pair only if its absolute residual is
    below 50 tol; the default inner IAR reads that tolerance as a backward
    error and expands around sigma, where a deflated eigenvalue 1e-3 away
    puts a pole into the deflated problem's term functions.  So its inner
    solver here is IAR held to the absolute residual with a Taylor degree of
    at most 12.  ``nlar``'s discard radius R is 1e-5: the default 0.01 is
    wider than the spacing of the eigenvalues near -1 (4e-4 at n = 1e4), so a
    converged eigenvalue's neighbours were discarded with it and it
    reconverged."""
    import functools

    from neptpu_torch import (FactorizeLinSolverCreator, IARInnerSolver,
                              Logger, NoConvergenceException,
                              ResidualErrmeasure, iar, jd_betcke,
                              jd_effenberger, nlar, residual_eigval_sorter,
                              tiar)

    class Creator(FactorizeLinSolverCreator):
        """The default creator, counting and timing its factorizations."""
        made = 0
        seconds = 0.0

        def _make(self, nep, lam):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver = super()._make(nep, lam)
            torch.cuda.synchronize()
            Creator.seconds += time.perf_counter() - t0
            Creator.made += 1
            return solver

    class Iterations(Logger):
        last = 0

        def iteration(self, iter_idx, errs=None, lams=None, level=1):
            Iterations.last = max(Iterations.last, int(iter_idx))

    nep, backward, sigma = dep["nep0"], dep["backward64"], cfg["sigma"]
    n = nep.n
    mats = nep.bank.host_csr_terms()
    scale = abs(sigma) * np.sqrt(n) + sum(
        abs(np.exp(-t * sigma)) * np.sqrt(A.multiply(A).sum())
        for t, A in zip(nep.tauv, mats))
    _, _, lam0, v0 = perturbed_start(dep, cfg)
    # jd_betcke finds eigenvalues in their order of distance to the target:
    # it starts from the pair nearest sigma
    _, _, lam1, v1 = perturbed_start(dep, cfg, nearest=True)
    inner = IARInnerSolver(maxit=12, iar_function=functools.partial(
        iar, errmeasure=ResidualErrmeasure))
    runs = [
        ("jd_effenberger", 3, 1e-11 * scale, True,
         lambda tol: jd_effenberger(
             nep, neigs=3, maxit=60, lam=lam0, v=v0, target=sigma,
             tol=tol, inner_solver_method=inner, linsolvercreator=Creator(),
             logger=Iterations(), device=DEVICE)),
        ("jd_betcke", 2, 1e-12, False,
         lambda tol: jd_betcke(
             nep, neigs=2, maxit=60, projtype=":PetrovGalerkin", lam=lam1,
             v=v1, target=sigma, tol=tol, linsolvercreator=Creator(),
             logger=Iterations(), device=DEVICE)),
        ("nlar", 3, 1e-12, True,
         lambda tol: nlar(
             nep, neigs=3, maxit=60, lam=sigma, v=v0, tol=tol, R=1e-5,
             num_restart_ritz_vecs=3,
             eigval_sorter=residual_eigval_sorter, linsolvercreator=Creator(),
             logger=Iterations(), device=DEVICE)),
    ] + [(f"{name}(proj_solve)", 4, None, False,
          lambda tol, solver=solver: solver(
              nep, sigma=sigma, maxit=30, neigs=4, proj_solve=True,
              v=np.ones(n), linsolvercreator=Creator(), logger=Iterations(),
              device=DEVICE))
         for name, solver in (("iar", iar), ("tiar", tiar))]
    dia_kernel.DIA_SPMV.reset_counts()
    t_phase = time.perf_counter()
    print(f"[dep-deflation] dep_symm_double n={n} float64, complex128, "
          f"sigma={sigma}: scale {scale:.6e}; starts lam0={lam0:.8f} "
          f"(jd_effenberger, nlar), {lam1:.8f} (jd_betcke); dense "
          "padded terms would take "
          f"{3 * (n + 3) ** 2 * 8 / 2**30:.2f} GiB and dense low-rank terms "
          f"{10 * (n + 3) ** 2 * 16 / 2**30:.2f} GiB at 3 levels", flush=True)
    for name, want, tol, distinct, run in runs:
        Creator.made = Iterations.last = 0
        Creator.seconds = 0.0
        before = dict(dia_kernel.DIA_SPMV.entry_counts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            out = run(tol)
        except NoConvergenceException as e:
            raise SmokeFailure(f"dep-deflation {name}: {e}; partial "
                               f"eigenvalues {np.asarray(e.lam)}")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        lams, V = np.asarray(out[0]), out[1]
        launched = {k: v - before[k] for k, v in
                    dia_kernel.DIA_SPMV.entry_counts.items() if v > before[k]}
        Vh = V.cpu().numpy()
        errs = [backward(complex(l), Vh[:, i] / np.linalg.norm(Vh[:, i]))
                for i, l in enumerate(lams)]
        gaps = [_conj_gap(x, found) for x in lams]
        sep = _separation(lams)
        print(f"[dep-deflation] {name}: {len(lams)} pairs "
              f"{np.array2string(lams, precision=10)} in {seconds:.3f} s, "
              f"tol {'default' if tol is None else '%.6e' % tol}, outer "
              f"iterations {Iterations.last}, factorizations {Creator.made} "
              f"({Creator.seconds:.3f} s), "
              f"launches {launched}, peak_device_mem "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; max "
              f"backward error {max(errs):.3e} (gate 1e-10), max rel gap to "
              f"iar_real's eigenvalues {max(gaps):.3e} (gate 1e-6), smallest "
              f"rel separation {sep:.3e}"
              + (" (gate 1e-8)" if distinct else ""), flush=True)
        check(len(lams) == want and V.shape == (n, want)
              and V.device.type == DEVICE,
              f"dep-deflation {name}: {len(lams)} pairs, vectors "
              f"{tuple(V.shape)} on {V.device}")
        check(max(errs) <= 1e-10 and max(gaps) <= 1e-6,
              f"dep-deflation {name}: backward error {max(errs):.3e}, gap "
              f"{max(gaps):.3e}")
        check(not distinct or sep > 1e-8,
              f"dep-deflation {name}: eigenvalues {lams} reconverged")
        check(launched.get("dia_lincomb_pair_f64", 0) > 0,
              f"dep-deflation {name}: no float64 pair launch ({launched})")
    t_phase = time.perf_counter() - t_phase
    entry = dict(dia_kernel.DIA_SPMV.entry_counts)
    print(f"[dep-deflation] phase {t_phase:.3f} s (budget 150 s), launches "
          f"{ {k: v for k, v in entry.items() if v} }", flush=True)
    check(t_phase <= 150.0, f"dep-deflation took {t_phase:.1f} s (> 150 s)")
    return entry


def phase_spmf_deflated(torch, dia_kernel, key, make_nep, sigma, gamma, cfg,
                        refine_backend, tol_refine=1e-9, pinned=None,
                        reference=None):
    """The restarted SPMF scan with Effenberger deflation inside the scan
    step (``iar_real_spmf_deflated``, in ``cfg["dtype"]``), its pairs
    refined by ``newton_refine``.  Gates: at least two sweeps converge
    pairs, the pairs are distinct (rel > 1e-7: no pair of a later sweep
    reconverges an earlier one), each Ritz backward error <= the scan's
    tolerance, one pair launch of the scan's dtype a scan step; after the refinement ``need`` distinct
    pairs at backward error <= 1e-9, each within rel 1e-9 of ``pinned``
    where given.  Against ``reference`` (the main path's refined pairs) each
    refined pair is matched to rel 1e-7 or printed as new."""
    from neptpu_torch.solvers.refine import newton_refine
    from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                                iar_real_spmf_deflated)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dia_kernel.DIA_SPMV.reset_counts()
    t_start = time.perf_counter()
    nep = make_nep()
    mats, fv = collect_spmf_terms(nep)
    backward = backward_errmeasure(mats, fv)
    t_problem = time.perf_counter() - t_start
    dt = getattr(torch, cfg["dtype"])
    tol = cfg["tol"]
    D, Q, info = iar_real_spmf_deflated(
        nep, sigma=sigma, gamma=gamma, maxit=cfg["maxit"],
        neigs=cfg["neigs"], tol=tol, check_error_every=cfg["check_every"],
        dtype=dt,
        return_info=True, device=DEVICE)
    torch.cuda.synchronize()
    t_scan_phase = time.perf_counter() - t_start - t_problem
    entry = {k: v for k, v in dia_kernel.DIA_SPMV.entry_counts.items() if v}
    errs0 = np.array([backward(complex(D[j]), Q[:, j])
                      for j in range(len(D))])
    sep = _separation(D)
    t1 = time.perf_counter()
    stats = {"chip_shifts": 0, "host_fallback_shifts": 0}
    lams, _, errs = newton_refine(
        mats, fv, D, Q, backend=refine_backend, stats=stats, nsweeps=3,
        tol=tol_refine, errmeasure=backward, dtype=torch.float32, ir=3,
        shift_rel=1e-8, target_distinct=len(D), device=DEVICE)
    t_refine = time.perf_counter() - t1
    sel = distinct_below_tol(lams, errs, 1e-9)
    wall = time.perf_counter() - t_start
    steps = sum(info["k_done_sweeps"])
    print(f"[spmf-deflated] {key} n={nep.n} terms={len(fv)} sigma={sigma} "
          f"gamma={gamma} maxit/sweep={info['m_per_sweep']} neigs="
          f"{cfg['neigs']} tol={tol:.3e} {cfg['dtype']}: sweeps="
          f"{info['sweeps']} "
          f"(steps {info['k_done_sweeps']}) nconv={info['nconv']} theta="
          f"{info['theta']:.6e} max|T| per sweep "
          f"{['%.3e' % t for t in info['max_abs_T']]}; Ritz backward errors "
          f"max {max(errs0, default=np.nan):.3e}, smallest rel separation "
          f"{sep:.3e}; eigenvalues {np.array2string(D, precision=8)}",
          flush=True)
    print(f"[spmf-deflated] {key} t_problem={t_problem:.3f} s "
          f"bank+factorize+scans={t_scan_phase:.3f} s (t_factorize="
          f"{info['t_factorize']:.3f} s t_scan={info['t_scan']:.3f} s, host "
          f"checks t_check={info['t_check']:.3f} s, per sweep "
          f"{['%.3f' % t for t in info['t_check_sweeps']]}) refine="
          f"{refine_backend} t_refine={t_refine:.3f} s wall={wall:.3f} s; "
          f"refined distinct<=1e-9={len(sel)} max_backward="
          f"{max(errs[sel]) if sel else float('nan'):.3e}; launches {entry} "
          f"in {steps} scan steps; peak_device_mem "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    check(bool(np.isfinite(D).all() and np.isfinite(errs0).all()
               and np.isfinite(lams).all()),
          f"spmf-deflated {key}: non-finite pairs")
    check(sum(1 for c in info["sweeps"] if c) >= 2,
          f"spmf-deflated {key}: sweeps {info['sweeps']} (need >= 2 that "
          "converge pairs)")
    check(sep > 1e-7, f"spmf-deflated {key}: pairs within rel {sep:.3e} of "
                      "each other (a converged pair reconverged)")
    check(errs0.max() <= tol, f"spmf-deflated {key}: Ritz backward error "
                              f"{errs0.max():.3e} above tol {tol:.3e}")
    pair_entry = f"dia_lincomb_pair_f{cfg['dtype'][-2:]}"
    check(entry.get(pair_entry, 0) >= steps,
          f"spmf-deflated {key}: {steps} scan steps launched {entry}")
    check(len(sel) >= cfg["need"],
          f"spmf-deflated {key}: {len(sel)} refined distinct pairs at "
          f"backward error <= 1e-9 (need {cfg['need']})")
    if pinned is not None:
        gaps = [float(np.min(np.abs(pinned - lams[j])) / abs(lams[j]))
                for j in sel]
        print(f"[spmf-deflated] {key} refined pairs vs the pinned oracle: "
              f"max rel gap {max(gaps):.3e} (gate 1e-9)", flush=True)
        check(max(gaps) <= 1e-9, f"spmf-deflated {key}: a refined pair lies "
                                 f"rel {max(gaps):.3e} from the pinned oracle")
    if reference is not None:
        ref = np.asarray(reference)
        new = [lams[j] for j in sel
               if np.min(np.abs(ref - lams[j])) / abs(lams[j]) > 1e-7]
        print(f"[spmf-deflated] {key} refined pairs within rel 1e-7 of the "
              f"main path's: {len(sel) - len(new)} of {len(sel)}; new: "
              f"{np.array2string(np.asarray(new), precision=10)}", flush=True)
    if refine_backend == "chip":
        check(stats["host_fallback_shifts"] <= MAX_HOST_FALLBACK,
              f"spmf-deflated {key}: {stats['host_fallback_shifts']} "
              "refinement shifts fell back to the host")
    return {"entry": dict(dia_kernel.DIA_SPMV.entry_counts), "wall": wall}


def dep_backward(nep):
    """``(backward, scale)``: ``benchmarks/time_to_tol.py``'s backward error
    on a delay problem's own operands (any vector, normalised here) and the
    scale ``|lam| sqrt(n) + sum_i |exp(-tau_i lam)| ||A_i||_F`` it divides
    by."""
    from neptpu_torch.solvers.iar_real import _dep_host_resnorm

    fro = [float(np.sqrt((A.multiply(A.conj())).sum()).real)
           for A in nep.bank.host_csr_terms()]
    rn = _dep_host_resnorm(nep)

    def scale(lam):
        return abs(lam) * np.sqrt(nep.n) + sum(
            abs(np.exp(-t * lam)) * f for t, f in zip(nep.tauv, fro))

    def backward(lam, q):
        q = np.asarray(q) / np.linalg.norm(q)
        return rn(lam, q) / scale(lam)

    return backward, scale


def phase_dep_krylov(torch, dia_kernel, cfg, dep, found, pairs64):
    """The Krylov variants and the dense Newton solvers on the float64
    delay problem of ``[dep-protocol]`` (n = 1e4), complex128:
    ``iar_chebyshev`` in ``:DEP`` mode at sigma = -1 (the problem shifted
    explicitly: one more delay-free term in its DIA bank),
    ``ilan`` (``proj_solve=True``), ``infbilanczos`` (the transposed problem
    built as the transpose), ``blocknewton`` from float64 ``iar_real``'s
    best three pairs (X orthonormalised, S = diag(lam), ``armijo_factor=
    0.5``), and ``broyden`` at nside 40 (its restart's dense eig of the
    bordered (n + k)^2 matrix runs on the host; its start ``M(sigma)``
    exactly, and a seeded random normalisation vector ``c``: with ``c`` all
    ones ``c^H v = 1`` makes the oscillating eigenvectors of this problem
    huge, and the step threshold 0.2 stalls the iteration at sigma).  Every
    pair at backward error <= 1e-10 and within rel 1e-6 of float64
    ``iar_real``'s eigenvalues (at nside 40 for ``broyden``)."""
    import warnings

    from neptpu_torch import (DEP, Logger, NoConvergenceException,
                              blocknewton, broyden, iar_chebyshev, iar_real,
                              ilan, infbilanczos, nep_gallery)

    class Iterations(Logger):
        last = 0

        def iteration(self, iter_idx, errs=None, lams=None, level=1):
            Iterations.last = max(Iterations.last, int(iter_idx))

    class Steps(Logger):
        """Counts broyden's inner iterations over all its pairs."""
        total = 0

        def iteration(self, iter_idx, errs=None, lams=None, level=1):
            Steps.total += 1

    nep, sigma = dep["nep0"], cfg["sigma"]
    n = nep.n
    backward, scale_at = dep_backward(nep)
    scale = scale_at(sigma)
    l64, Q64, e64 = pairs64
    best = np.argsort(e64)[:3]
    X0, _ = np.linalg.qr(Q64[:, best])
    S0 = np.diag(np.asarray(l64)[best])
    mats = nep.bank.host_csr_terms()
    t_phase = time.perf_counter()
    nep40 = nep_gallery("dep_symm_double", KRYLOV["broyden_nside"],
                        device=DEVICE)
    backward40, scale40_at = dep_backward(nep40)
    l40, Q40 = iar_real(nep40, sigma=sigma, maxit=60, neigs=60, tol=np.inf,
                        dtype=torch.float64, device=DEVICE)
    e40 = np.array([backward40(complex(x), Q40[:, i])
                    for i, x in enumerate(l40)])
    found40 = np.asarray(l40)[e40 < 1e-12]
    nept = DEP([A.T.tocsr() for A in mats], nep.tauv, device=DEVICE)
    c40 = np.random.default_rng(0).standard_normal(nep40.n)

    def eig_pairs(S, X):
        lam, Z = np.linalg.eig(S)
        return lam, (X @ torch.as_tensor(Z, device=X.device)).cpu().numpy()

    runs = [
        ("iar_chebyshev", nep, backward, found, lambda: iar_chebyshev(
            nep, sigma=sigma, compute_y0_method=":DEP", maxit=30, neigs=4,
            tol=1e-11 * scale, v=np.ones(n), logger=Iterations(),
            device=DEVICE)),
        ("ilan", nep, backward, found, lambda: ilan(
            nep, sigma=sigma, maxit=40, neigs=2, tol=1e-10, proj_solve=True,
            check_error_every=10, v=np.ones(n), logger=Iterations(),
            device=DEVICE)[:2]),
        ("infbilanczos", nep, backward, found, lambda: infbilanczos(
            nep, nept, sigma=sigma, maxit=40, neigs=3, tol=1e-10,
            v=np.ones(n), u=np.ones(n), logger=Iterations(),
            device=DEVICE)[:2]),
        ("blocknewton", nep, backward, found, lambda: eig_pairs(*blocknewton(
            nep, S=S0, X=X0, armijo_factor=0.5, tol=1e-12 * scale, maxit=20,
            logger=Iterations(), device=DEVICE))),
        ("broyden", nep40, backward40, found40, lambda: eig_pairs(*broyden(
            nep40, sigma=sigma, approxnep=nep40, pmax=3,
            tol=1e-12 * scale40_at(sigma), c=c40, inner_logger=Steps(),
            device=DEVICE))),
    ]
    print(f"[dep-krylov] dep_symm_double n={n} float64, complex128, sigma="
          f"{sigma}: scale {scale:.6e}; broyden at nside "
          f"{KRYLOV['broyden_nside']} (n={nep40.n}), float64 iar_real there "
          f"{len(found40)} pairs at backward error < 1e-12", flush=True)
    out = {}
    for name, problem, bw, pool, run in runs:
        Iterations.last = Steps.total = 0
        before = dict(dia_kernel.DIA_SPMV.entry_counts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                lams, V = run()
            except NoConvergenceException as e:
                raise SmokeFailure(f"dep-krylov {name}: {e}; partial "
                                   f"eigenvalues {np.asarray(e.lam)}")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        lams = np.asarray(lams)
        V = V.cpu().numpy() if hasattr(V, "cpu") else np.asarray(V)
        launched = {k: v - before[k] for k, v in
                    dia_kernel.DIA_SPMV.entry_counts.items() if v > before[k]}
        errs = [bw(complex(x), V[:, i]) for i, x in enumerate(lams)]
        gaps = [_conj_gap(x, pool) for x in lams]
        its = Steps.total if name == "broyden" else Iterations.last
        print(f"[dep-krylov] {name}: {len(lams)} pairs "
              f"{np.array2string(lams, precision=10)} in {seconds:.3f} s, "
              f"iterations {its}, launches {launched}, peak_device_mem "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; max "
              f"backward error {max(errs):.3e} (gate 1e-10), max rel gap to "
              f"float64 iar_real's eigenvalues {max(gaps):.3e} (gate 1e-6)"
              + "".join(f"; warned: {w.message}" for w in caught
                        if "shifted and scaled" in str(w.message)),
              flush=True)
        check(len(lams) > 0 and max(errs) <= 1e-10 and max(gaps) <= 1e-6,
              f"dep-krylov {name}: {len(lams)} pairs, backward error "
              f"{max(errs, default=np.nan):.3e}, gap "
              f"{max(gaps, default=np.nan):.3e}")
        if name != "blocknewton":  # (its residuals go through compute_MM)
            check(launched.get("dia_lincomb_pair_f64", 0) > 0,
                  f"dep-krylov {name}: no float64 pair launch ({launched})")
        out[name] = launched
    t_phase = time.perf_counter() - t_phase
    print(f"[dep-krylov] phase {t_phase:.3f} s (budget "
          f"{KRYLOV['budget']:g} s)", flush=True)
    check(t_phase <= KRYLOV["budget"],
          f"dep-krylov took {t_phase:.1f} s (> {KRYLOV['budget']:g} s)")
    return out


def _box_samples(box, nb=300, grid=(10, 10)):
    """Samples on the rectangle ``box`` (its boundary at ``nb`` points and
    an interior grid): AAAeigs's set Z."""
    from neptpu_torch.solvers.rk.polygon import discretizepolygon

    edge = discretizepolygon(list(box), npts=nb)[0][:nb]
    re_, im_ = np.real(box), np.imag(box)
    xs = np.linspace(re_.min(), re_.max(), grid[0] + 2)[1:-1]
    ys = np.linspace(im_.min(), im_.max(), grid[1] + 2)[1:-1]
    return np.concatenate([edge, (xs[None, :] + 1j * ys[:, None]).ravel()])


def phase_rational(torch, dia_kernel, gun, cfg=RATIONAL):
    """The rational-Krylov, AAA and contour family on full-size gun_like
    (n = 9956, complex128), each solver through its entry point with the
    launch counts set to 0 just before and read just after:

    * ``nleigs`` on the box ``cfg["box"]`` with the poles on the branch cut
      of the second square root and the shifts at ``cfg["nodes"]`` (one
      dense LU on the card each, kept), backward error tol 1e-10;
    * ``AAAeigs`` on samples of the same box, the same shifts, 6 pairs;
    * ``contour_beyn`` and ``contour_block_SS`` on the ellipse
      ``cfg["center"]``, ``cfg["radius"]`` with N nodes, the dense M of
      ``cfg["chunk"]`` nodes LU-factored as one stack.

    Gates: NLEIGS returns every pinned eigenvalue in the box, each within rel
    1e-9 of it, distinct, at backward error <= 1e-10; AAAeigs returns 6
    pairs at backward error <= 1e-10, those inside the oracle disk within
    rel 1e-9 of a pinned value, at least 4 of them; Beyn and block-SS return
    every pinned eigenvalue inside the ellipse within rel 1e-8 and no other
    eigenvalue inside it; NLEIGS launches the float64 pair kernel at least
    once per divided-difference apply and AAAeigs once per iteration; the
    contour methods factor ceil(N / chunk) stacks of N nodes in all; the
    phase within ``cfg["budget"]`` seconds."""
    import warnings

    from neptpu_torch import (AAAeigs, FactorizeLinSolverCreator,
                              NoConvergenceException, StandardSPMFErrmeasure,
                              contour_beyn, contour_block_SS, nep_gallery,
                              nleigs)
    from neptpu_torch.models.gallery.nlevp import GUN_SIGMA2
    from neptpu_torch.solvers import contour
    from neptpu_torch.solvers.nleigs import in_Sigma

    class TimedLU(FactorizeLinSolverCreator):
        """The dense-LU creator, counting its factorizations and their
        seconds (assembly of M included) on the card's clock."""
        count, seconds = 0, 0.0

        def _make(self, nep, lam):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver = super()._make(nep, lam)
            torch.cuda.synchronize()
            self.count += 1
            self.seconds += time.perf_counter() - t0
            return solver

    lu_time = [0.0]
    plain_factor = contour.batched_lu_factor

    def timed_factor(A):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_factor(A)
        torch.cuda.synchronize()
        lu_time[0] += time.perf_counter() - t0
        return out

    t_phase = time.perf_counter()
    nep = nep_gallery("gun_like", device=DEVICE)
    backward, tol = gun["backward"], cfg["tol"]
    box, nodes = list(cfg["box"]), list(cfg["nodes"])
    center, radius, N, chunk = (cfg["center"], cfg["radius"], cfg["N"],
                                cfg["chunk"])
    pinned_box = GUN_LIKE_PINNED[in_Sigma(GUN_LIKE_PINNED, box, 0.0)]

    def in_ellipse(x):
        d = np.asarray(x) - center
        return (d.real / radius[0]) ** 2 + (d.imag / radius[1]) ** 2 <= 1

    pinned_ell = GUN_LIKE_PINNED[in_ellipse(GUN_LIKE_PINNED)]
    # the pinned values lie this close to SIGMA (the oracle misses two
    # eigenvalues inside it, ROADMAP C11; none in the box or the ellipse)
    in_disk = 128.7
    Xi = GUN_SIGMA2**2 - np.logspace(-8, 8, 10000)
    Z = _box_samples(box)
    print(f"[rational] gun_like n={nep.n} complex128: box {box}, "
          f"{len(pinned_box)} pinned values in it; nodes {nodes}; ellipse "
          f"center {center} radius {radius}, {len(pinned_ell)} pinned values "
          f"in it; AAA samples {len(Z)}", flush=True)
    check(len(pinned_box) == 6 and len(pinned_ell) == 6,
          "rational: the box and the ellipse must hold 6 pinned values each")
    lus = {}

    def run_nleigs(st):
        lus["nleigs"] = TimedLU()
        lam, X, res, _ = nleigs(
            nep, box, Xi=Xi, nodes=nodes, tol=tol,
            errmeasure=StandardSPMFErrmeasure,
            linsolvercreator=lus["nleigs"], stats=st, device=DEVICE)
        return lam, X

    def run_aaa(st):
        lus["AAAeigs"] = TimedLU(max_factorizations=len(nodes))
        lam, X, res, _ = AAAeigs(
            nep, Z, neigs=6, shifts=nodes, tol=tol,
            errmeasure=StandardSPMFErrmeasure,
            linsolvercreator=lus["AAAeigs"], stats=st, device=DEVICE)
        return lam, X

    def run_beyn(st):
        return contour_beyn(nep, sigma=center, radius=radius, N=N, neigs=6,
                            k=8, errmeasure=StandardSPMFErrmeasure,
                            chunk=chunk, device=DEVICE)

    def run_ss(st):
        return contour_block_SS(nep, sigma=center, radius=radius, N=N, k=4,
                                K=4, chunk=chunk, device=DEVICE)

    def rel_gap(x):
        return float(np.min(np.abs(GUN_LIKE_PINNED - x)) / abs(x))

    out = {}
    contour.batched_lu_factor = timed_factor
    try:
        for name, run in (("nleigs", run_nleigs), ("AAAeigs", run_aaa),
                          ("contour_beyn", run_beyn),
                          ("contour_block_SS", run_ss)):
            st = {}
            lu_time[0] = 0.0
            contour.BATCHED_LU.update(chunks=0, nodes=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dia_kernel.DIA_SPMV.reset_counts()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    lams, V = run(st)
                except NoConvergenceException as e:
                    raise SmokeFailure(f"rational {name}: {e}; partial "
                                       f"eigenvalues {np.asarray(e.lam)}")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launched = {k: v for k, v in
                        dia_kernel.DIA_SPMV.entry_counts.items() if v}
            pair64 = launched.get("dia_lincomb_pair_f64", 0)
            lams = np.asarray(lams)
            Vh = V.cpu().numpy()
            errs = np.array([backward(complex(x), Vh[:, i])
                             for i, x in enumerate(lams)])
            gaps = np.array([rel_gap(x) for x in lams])
            if name in lus:
                lu = (f"LUs {lus[name].count} in {lus[name].seconds:.3f} s "
                      "(assembly included)")
            else:
                lu = (f"stacked LUs {contour.BATCHED_LU['chunks']} of "
                      f"{contour.BATCHED_LU['nodes']} nodes in "
                      f"{lu_time[0]:.3f} s")
            its = (f"iterations {st['iterations']}, kconv {st['kconv']}, "
                   f"D applies {st['D_applies']}" if name == "nleigs" else
                   f"iterations {st['iterations']}, support points "
                   f"{st['m']}" if name == "AAAeigs" else
                   f"nodes {N}, chunk {chunk}")
            print(f"[rational] {name}: {len(lams)} pairs "
                  f"{np.array2string(lams, precision=10)} in {seconds:.3f} "
                  f"s; {its}; {lu}; f64 pair launches {pair64} (all "
                  f"{launched}); peak_device_mem "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; max "
                  f"backward error {max(errs, default=np.nan):.3e}; max rel "
                  f"gap to the pinned oracle {max(gaps, default=np.nan):.3e}"
                  + "".join(f"; warned: {w.message}" for w in caught),
                  flush=True)
            check(np.isfinite(lams).all() and np.isfinite(errs).all(),
                  f"rational {name}: non-finite results")
            if name == "nleigs":
                hit = [rel_gap(x) <= 1e-9 for x in lams]
                found = [p for p in pinned_box
                         if np.min(np.abs(lams - p)) / abs(p) <= 1e-9]
                check(all(hit) and len(found) == len(pinned_box)
                      and len(distinct_below_tol(lams, errs, np.inf))
                      == len(lams) and max(errs) <= tol,
                      f"rational nleigs: {len(lams)} pairs, {len(found)} of "
                      f"{len(pinned_box)} pinned found, max backward "
                      f"{max(errs, default=np.nan):.3e}, max gap "
                      f"{max(gaps, default=np.nan):.3e}")
                check(pair64 >= st["D_applies"] > 0,
                      f"rational nleigs: {pair64} f64 pair launches for "
                      f"{st['D_applies']} divided-difference applies")
            elif name == "AAAeigs":
                near = np.abs(lams - SIGMA) < in_disk
                check(len(lams) == 6 and max(errs) <= tol
                      and all(gaps[near] <= 1e-9) and near.sum() >= 4,
                      f"rational AAAeigs: {len(lams)} pairs, max backward "
                      f"{max(errs, default=np.nan):.3e}, {int(near.sum())} "
                      "in the oracle disk, gaps there "
                      f"{gaps[near]}")
                check(pair64 >= st["iterations"] > 0,
                      f"rational AAAeigs: {pair64} f64 pair launches in "
                      f"{st['iterations']} iterations")
            else:
                inside = in_ellipse(lams)
                found = [p for p in pinned_ell
                         if np.min(np.abs(lams - p)) / abs(p) <= 1e-8]
                check(len(found) == len(pinned_ell)
                      and all(gaps[inside] <= 1e-8),
                      f"rational {name}: {len(found)} of {len(pinned_ell)} "
                      "pinned values inside the ellipse found; gaps of the "
                      f"eigenvalues inside {gaps[inside]}")
                check(contour.BATCHED_LU["chunks"] == -(-N // chunk)
                      and contour.BATCHED_LU["nodes"] == N,
                      f"rational {name}: {contour.BATCHED_LU} stacked LUs "
                      f"(expected {-(-N // chunk)} chunks of {N} nodes)")
            out[name] = launched
            if name == "contour_beyn":
                beyn = lams
    finally:
        contour.batched_lu_factor = plain_factor
    t_phase = time.perf_counter() - t_phase
    print(f"[rational] phase {t_phase:.3f} s (budget {cfg['budget']:g} s)",
          flush=True)
    check(t_phase <= cfg["budget"],
          f"rational took {t_phase:.1f} s (> {cfg['budget']:g} s)")
    return out, beyn


def phase_refine_chip(torch, gun):
    """The gun_like candidates refined on the card, against the host
    backend on the same candidates."""
    from neptpu_torch.solvers.refine import newton_refine

    lams0, Q0 = gun["cand"]
    kw = dict(nsweeps=3, tol=1e-11, errmeasure=gun["backward"],
              dtype=torch.float32, ir=3, shift_rel=1e-8, target_distinct=10)
    res = {}
    for backend in ("host", "chip"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lams, Q, errs = newton_refine(gun["mats"], gun["fv"], lams0, Q0,
                                      backend=backend, device=DEVICE, **kw)
        torch.cuda.synchronize()
        res[backend] = (lams, errs, time.perf_counter() - t0,
                        torch.cuda.max_memory_allocated() / 2**20)
    hl, he, ht, _ = res["host"]
    cl, ce, ct, cmem = res["chip"]
    hsel = distinct_below_tol(hl, he, 1e-9)
    csel = distinct_below_tol(cl, ce, 1e-9)
    gap = max(np.min(np.abs(hl[hsel] - cl[j])) / abs(cl[j]) for j in csel)
    print(f"[refine-chip] gun_like {len(lams0)} candidates: chip backend "
          f"distinct<=1e-9={len(csel)} max_backward={max(ce[csel]):.3e} in "
          f"{ct:.3f} s (peak_device_mem {cmem:.1f} MiB); host backend "
          f"distinct<=1e-9={len(hsel)} max_backward={max(he[hsel]):.3e} in "
          f"{ht:.3f} s; max rel eigenvalue gap chip vs host {gap:.3e}",
          flush=True)
    check(len(csel) >= 10, f"chip refine: only {len(csel)} distinct pairs "
                           "at backward error <= 1e-9 (need 10)")
    check(gap <= 1e-9, f"chip refine: eigenvalues differ from the host "
                       f"backend's by rel {gap:.3e} (> 1e-9)")


def _device_events(trace_path):
    """The device operations (kernels, copies, memsets) of a chrome trace
    written by ``torch.profiler``."""
    with open(trace_path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _count_device_ops(torch, fn):
    """``(device operations, copy and gather kernels among them)`` that
    ``fn()`` enqueues, counted by ``torch.profiler``."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        dev = _device_events(path)
    copies = sum(1 for e in dev if e.get("cat") == "gpu_memcpy"
                 or re.search("copy|gather|index", e["name"], re.I))
    return np.array([len(dev), copies])


def phase_step_launches(torch):
    """Device operations per complex-as-real scan step at gun_like, wep and
    dep, and how many of them are copy or gather kernels, for the graph
    path and for the eager comparator.  Each scan runs twice under
    ``torch.profiler`` on one prebuilt bank and factorization with the same
    basis size (maxit 20) and stops at its first convergence check, after 5
    or after 15 steps (every pair counts as converged); the difference over
    the 10 steps is the step's count (set-up, the warm-up step, the capture
    and the Ritz extraction cancel, every tensor has the same shape in both
    runs; the scaled mode is the one the main path runs in)."""
    from neptpu_torch import iar_real, nep_gallery
    from neptpu_torch.ops.mixed import make_mixed_bank
    from neptpu_torch.solvers.iar_real import dep_shift_block_lu
    from neptpu_torch.solvers.scan_graph import _eager_loop
    from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                                iar_real_spmf)

    def zero(lam, q):
        return 0.0  # converged at the first check, and no residual work

    def report(key, run):
        for form in ("graph", "eager comparator"):
            def count(k):
                if form == "graph":
                    return _count_device_ops(torch, lambda: run(k))
                with _eager_loop():
                    return _count_device_ops(torch, lambda: run(k))

            ops = [count(k) for k in (5, 15, 5, 15)]
            total, copies = (ops[1] + ops[3] - ops[0] - ops[2]) / 20
            print(f"[step] {key} ({form}): {total:g} device operations per "
                  f"scan step, {copies:g} of them copy or gather kernels",
                  flush=True)

    common = dict(maxit=20, neigs=1, tol=1e300, dtype=torch.float32,
                  errmeasure=zero, device=DEVICE)
    for key, make, sigma, gamma in (
            ("gun_like", lambda: nep_gallery("gun_like", device=DEVICE),
             SIGMA, GAMMA),
            ("wep", lambda: wep_nep(WEP), WEP["sigmas"][0], 1.0)):
        nep = make()
        kw = dict(common, sigma=sigma, gamma=gamma, scaled=True)
        bank = make_mixed_bank(collect_spmf_terms(nep)[0], dtype=np.float32,
                               device=DEVICE)
        solver = iar_real_spmf(nep, bank=bank, check_error_every=5,
                               return_info=True, return_solver=True,
                               **kw)[2]["solver"]
        report(key, lambda k: iar_real_spmf(
            nep, bank=bank, lu_piv=solver, check_error_every=k, **kw))
    nep, _, _, _ = dep_problem(DEP["nside"])
    lu_piv = dep_shift_block_lu(nep, DEP["sigma"], dtype=torch.float32,
                                device=DEVICE)
    kw = dict(common, sigma=DEP["sigma"], lu_piv=lu_piv, scaled=False)
    iar_real(nep, check_error_every=5, **kw)
    report("dep", lambda k: iar_real(nep, check_error_every=k, **kw))


def phase_profile(torch, trace_path, key, make_nep, sigma, gamma, maxit,
                  neigs, tol):
    """One shift's factorization and scan once more under
    ``torch.profiler``; the chrome trace goes to ``trace_path`` and its device
    kernels give the device's busy share and the time by kernel."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                                iar_real_spmf)

    nep = make_nep()
    mats, fv = collect_spmf_terms(nep)
    kw = dict(sigma=sigma, gamma=gamma, maxit=maxit, neigs=neigs, tol=tol,
              check_error_every=20, dtype=torch.float32,
              errmeasure=backward_errmeasure(mats, fv), return_info=True,
              device=DEVICE)
    iar_real_spmf(nep, **kw)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, info = iar_real_spmf(nep, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    dev = _device_events(trace_path)
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
    print(f"[profile] {key} bank+factorize+scan wall {wall:.3f} s (t_bank "
          f"{info['t_bank']:.3f} s, t_factorize {info['t_factorize']:.3f} s, "
          f"t_scan {info['t_scan']:.3f} s, k_done {info['k_done']}); device "
          f"busy {busy_us / 1e6:.4f} s = {busy_us / 1e4 / wall:.1f}% of wall, "
          f"{len(dev)} device ops", flush=True)
    for name, (us, cnt) in sorted(by.items(), key=lambda x: -x[1][0])[:10]:
        print(f"[profile]   {us / 1e3:8.3f} ms {100 * us / busy_us:5.1f}% "
              f"x{cnt:5d}  {name[:80]}", flush=True)
    for name, (us, cnt) in by.items():
        if "dia_lincomb" in name:
            print(f"[profile] {name[:60]}: {cnt} launches, {us / cnt:.2f} us "
                  f"device time each, {100 * us / busy_us:.2f}% of device "
                  "time", flush=True)


# [scan-graph]: the scans whose step the card replays as a captured CUDA
# graph, each beside the eager step loop on the same bank, solver and start;
# the gate's tolerance on the Hessenberg by dtype; turns: how many runs of
# each form, in the order graph, eager, eager, graph
SCAN_GRAPH = dict(tol={"float32": 1e-6, "float64": 1e-12,
                       "complex128": 1e-12}, budget=150.0)


def _busy(torch, fn):
    """``(wall s, device busy s, device ops)`` of ``fn()`` under
    ``torch.profiler`` (the union of the traced device intervals)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        dev = _device_events(path)
    busy_us, end = 0.0, -1.0
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return wall, busy_us / 1e6, len(dev)


def _scan_pair(torch, dia_kernel, key, dtype, run, turns=2, profile=False):
    """One scan of [scan-graph] run through the graph and as the eager
    comparator (``_eager_loop``) in turns (graph, eager[, eager, graph]);
    prints both and gates their equality.  ``run()`` returns ``(lams,
    info)``; the infos of a restarted scan carry per-sweep lists."""
    from neptpu_torch.solvers.scan_graph import _eager_loop

    out = {"graph": [], "eager": []}
    order = ["graph", "eager", "eager", "graph"][:2 * turns]
    for form in order:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dia_kernel.DIA_SPMV.snapshot()
        t0 = time.perf_counter()
        if form == "eager":
            with _eager_loop():
                lams, info = run()
        else:
            lams, info = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[form].append(dict(
            lams=np.sort_complex(np.asarray(lams)), info=info, wall=wall,
            launches=dia_kernel.DIA_SPMV.launches_since(before)[1],
            peak=torch.cuda.max_memory_allocated() / 2**20))
    g, e = out["graph"][0], out["eager"][0]
    sweeps = "graph_sweeps" in g["info"]

    def per(info, name):
        return info[f"{name}_sweeps"] if sweeps else [info[name]]

    steps = sum(per(g["info"], "k_done"))
    stats = per(g["info"], "graph")
    capture = sum(st["capture_s"] for st in stats)
    replays = sum(st["replays"] for st in stats)
    warm = sum(st["eager_steps"] for st in stats)

    def step_ms(r):
        t_check = r["info"].get("t_check", 0.0)
        return (r["info"]["t_scan"] - t_check) / steps * 1e3

    h_gap = max(float(np.linalg.norm(a - b) / np.linalg.norm(b))
                for a, b in zip(per(g["info"], "hessenberg"),
                                per(e["info"], "hessenberg")))
    lam_gap = float(np.max(np.abs(g["lams"] - e["lams"])
                           / np.abs(e["lams"]), initial=0.0))
    line = {form: ", ".join(
        f"t_scan {r['info']['t_scan']:.3f} s ({step_ms(r):.3f} ms a step, "
        f"checks {r['info'].get('t_check', 0.0):.3f} s) wall {r['wall']:.3f}"
        f" s peak {r['peak']:.1f} MiB" for r in out[form])
        for form in ("graph", "eager")}
    print(f"[scan-graph] {key} {dtype}: {steps} steps in "
          f"{len(stats)} scan(s); graph: {line['graph']}; eager comparator: "
          f"{line['eager']}; capture {capture:.4f} s, {replays} replays + "
          f"{warm} warm-up step(s) = {replays / max(steps - warm, 1):.3f} "
          f"host graph launches a step after the warm-up; launches "
          f"{ {k: v for k, v in g['launches'].items() if v} }; Hessenberg "
          f"rel gap {h_gap:.3e}, eigenvalue rel gap {lam_gap:.3e}",
          flush=True)
    tol = SCAN_GRAPH["tol"][dtype]
    for r in out["graph"] + out["eager"]:
        check(per(r["info"], "k_done") == per(g["info"], "k_done")
              and r["launches"] == g["launches"]
              and len(r["lams"]) == len(g["lams"]) > 0,
              f"scan-graph {key}: the runs differ in steps, launches or "
              "pairs")
    check(all(st["graphed"] and st["eager_steps"] == 1
              and st["replays"] == k - 1
              for st, k in zip(stats, per(g["info"], "k_done"))),
          f"scan-graph {key}: not one replay a step after the warm-up: "
          f"{stats}")
    check(not any(st["graphed"] for st in per(e["info"], "graph")),
          f"scan-graph {key}: the eager comparator ran a graph")
    check(h_gap <= tol, f"scan-graph {key}: Hessenberg rel gap {h_gap:.3e} "
                        f"(> {tol:g})")
    check(lam_gap <= 100 * tol, f"scan-graph {key}: eigenvalues differ by "
                                f"rel {lam_gap:.3e}")
    if profile:
        busy = {}
        for form in ("graph", "eager"):
            if form == "eager":
                with _eager_loop():
                    busy[form] = _busy(torch, run)
            else:
                busy[form] = _busy(torch, run)
        print(f"[scan-graph] {key} under the profiler: " + "; ".join(
            f"{form} wall {w:.3f} s, device busy {b:.4f} s = "
            f"{100 * b / w:.1f}%, {n} device ops"
            for form, (w, b, n) in busy.items()), flush=True)
    return {"graph_step_ms": float(np.mean([step_ms(r)
                                            for r in out["graph"]])),
            "eager_step_ms": float(np.mean([step_ms(r)
                                            for r in out["eager"]])),
            "capture_s": capture}


def phase_scan_graph(torch, dia_kernel, profile=False):
    """[scan-graph]: each ported scan through the captured graph and as the
    eager step loop (the comparator, under its private name), on the same
    bank, solver and start: gun_like and wep (its three shifts) through
    ``iar_real_spmf`` (float32), the delay problem's ``iar_real`` and
    ``tiar_real`` (float32), the deflated wep scan, ``tiar_jitted_spmf`` on
    gun_like (complex128).  Printed: ``t_scan`` and a step's time without
    the host checks for both forms, capture seconds, replays and host graph
    launches a step, peak memory; with ``profile`` the device's busy share
    of each form.  Gates: the same steps, launches and converged
    eigenvalues, the Hessenberg within rel 1e-6 (float32) or 1e-12, one
    replay a step after the warm-up step, the phase within its budget."""
    from neptpu_torch import iar_real, nep_gallery, tiar_real
    from neptpu_torch import iar_real_spmf_deflated, tiar_jitted_spmf
    from neptpu_torch.ops.mixed import make_mixed_bank
    from neptpu_torch.ops.partitioned import build_spmf_shift_solver
    from neptpu_torch.solvers.iar_real import dep_shift_block_lu
    from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                                iar_real_spmf)

    t_phase = time.perf_counter()
    rows = {}
    f32 = torch.float32
    for key, make, sigmas, gamma, maxit, neigs, tol in (
            ("gun_like", lambda: nep_gallery("gun_like", device=DEVICE),
             [SIGMA], GAMMA, 60, 10, 1e-6),
            ("wep", lambda: wep_nep(WEP), WEP["sigmas"], 1.0, 100, 8, 1e-5)):
        nep = make()
        mats, fv = collect_spmf_terms(nep)
        backward = backward_errmeasure(mats, fv)
        bank = make_mixed_bank(mats, dtype=np.float32, device=DEVICE)
        for i, sigma in enumerate(sigmas):
            solver = build_spmf_shift_solver(mats, fv, sigma, dtype=f32,
                                             device=DEVICE)

            def run(sigma=sigma, solver=solver):
                lams, _, info = iar_real_spmf(
                    nep, sigma=sigma, gamma=gamma, maxit=maxit, neigs=neigs,
                    tol=tol, check_error_every=20, dtype=f32,
                    errmeasure=backward, bank=bank, lu_piv=solver,
                    return_info=True, device=DEVICE)
                return lams, info

            name = key if len(sigmas) == 1 else f"{key} shift {i}"
            rows[name] = _scan_pair(torch, dia_kernel, name, "float32", run,
                                    turns=2 if key == "gun_like" else 1,
                                    profile=profile and i == 0)
            del solver
        del nep, bank

    dep, _, _, _ = dep_problem(DEP["nside"])
    lu_piv = dep_shift_block_lu(dep, DEP["sigma"], dtype=f32, device=DEVICE)
    for name, solve in (("iar_real", iar_real), ("tiar_real", tiar_real)):
        def run(solve=solve):
            lams, _, info = solve(dep, sigma=DEP["sigma"], maxit=DEP["maxit"],
                                  neigs=DEP["maxit"], tol=np.inf, dtype=f32,
                                  lu_piv=lu_piv, return_info=True,
                                  device=DEVICE)
            return lams, info

        rows[f"dep {name}"] = _scan_pair(torch, dia_kernel, f"dep {name}",
                                         "float32", run, turns=2,
                                         profile=profile)
    del dep, lu_piv

    cfg = SPMF_DEFLATED["wep"]
    wep = wep_nep(WEP)
    mats, fv = collect_spmf_terms(wep)

    def run_deflated():
        D, _, info = iar_real_spmf_deflated(
            wep, sigma=WEP["sigmas"][0], gamma=1.0, maxit=cfg["maxit"],
            neigs=cfg["neigs"], tol=cfg["tol"],
            check_error_every=cfg["check_every"], dtype=f32,
            return_info=True, device=DEVICE)
        return D, info

    rows["wep deflated"] = _scan_pair(torch, dia_kernel, "wep deflated",
                                      "float32", run_deflated, turns=1)
    del wep
    gun = nep_gallery("gun_like", device=DEVICE)
    mats, fv = collect_spmf_terms(gun)
    backward = backward_errmeasure(mats, fv)

    def run_complex():
        lams, _, info = tiar_jitted_spmf(
            gun, sigma=SIGMA, gamma=GAMMA, maxit=COMPLEX_SCAN["maxit"],
            neigs=COMPLEX_SCAN["neigs"], tol=COMPLEX_SCAN["tol"],
            check_error_every=COMPLEX_SCAN["check_every"],
            errmeasure=backward, return_info=True, device=DEVICE)
        return lams, info

    rows["tiar_jitted_spmf gun_like"] = _scan_pair(
        torch, dia_kernel, "tiar_jitted_spmf gun_like", "complex128",
        run_complex, turns=2, profile=profile)
    t_phase = time.perf_counter() - t_phase
    print(f"[scan-graph] per step, graph / eager comparator (ms): "
          + "; ".join(f"{k} {r['graph_step_ms']:.3f} / "
                      f"{r['eager_step_ms']:.3f}" for k, r in rows.items()),
          flush=True)
    print(f"[scan-graph] phase {t_phase:.3f} s (budget "
          f"{SCAN_GRAPH['budget']:g} s)", flush=True)
    check(t_phase <= SCAN_GRAPH["budget"],
          f"scan-graph took {t_phase:.1f} s (> {SCAN_GRAPH['budget']:g} s)")
    return rows


# [wep-native]: the waveguide's native form at the wep configuration's size
# (JARLEBRING, nx = 109, nz = 105, n = 11655), the pinned eigenvalue of
# tests/test_wep.py:59 and the SMW preconditioner's N = 21 z-domains
WEP_NATIVE = dict(nx=109, nz=105, sigma=-3 - 3.5j, N=21, budget=120.0,
                  ref=-2.743228671961724 - 3.1439375599649972j)
# [complex-scan]: the complex-dtype scans, gun_like at the gun shift and the
# delay problem of [dep] at its shift
COMPLEX_SCAN = dict(maxit=60, neigs=6, tol=1e-9, check_every=20, need=4,
                    dep_tol=1e-10, budget=90.0)
# [gallery]: every gallery problem this slice ports, at the sizes of its
# tests; (name, args, kwargs, point) of the registry identity
# Mlincomb(lam, v) = Mder(lam) v (tests/test_gallery_sweep.py:12-41)
GALLERY_SWEEP = [
    ("real_quadratic", (), {}, -3.0), ("qdep0", (), {}, 0.3),
    ("qdep1", (), {}, 0.3), ("neuron0", (), {}, 0.3),
    ("beam", (40,), {}, -1.0), ("sine", (), {}, 0.1),
    ("schrodinger_movebc", (120,), {}, -3.0),
    ("nlevp_native_cd_player", (), {}, 0.3),
    ("nlevp_native_fiber", (), {}, 1e-6),
    ("nlevp_native_hadeler", (200,), {}, 0.3),
    ("nlevp_native_pdde_stability", (20,), {}, 0.3),
    ("periodicdde", (), {"name": "mathieu"}, -0.24),
    ("bem_fichera", (1,), {}, 3.0), ("orr_sommerfeld", (24,), {}, 0.3)]
GALLERY_BUDGET = 60.0


def gallery_dia_banks(torch):
    """The DIA bank of the one [gallery] problem that holds one at the
    phase's sizes (fiber; ``schrodinger_movebc`` at n = 120 gets a CSR
    bank): the kernel is held against its twin at that shape too."""
    from neptpu_torch import nep_gallery

    return {"fiber": nep_gallery("nlevp_native_fiber", device=DEVICE).bank}


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class _Count:
    """A logger counting iterations (the protocol solvers call
    ``iteration`` once per step)."""

    def __init__(self):
        self.n = 0

    def iteration(self, *args, **kwargs):
        self.n += 1

    def info(self, *args, **kwargs):
        pass


def phase_wep_native(torch, dia_kernel, cfg=WEP_NATIVE):
    """The native waveguide ``WEP_FD`` at n = 11655, complex128, on the
    card (tests/test_wep.py:59-107 at full size):

    (a) ``resinv`` from lambda = -3 - 3.5i, v = 1/sqrt(n), the factorized
        Schur solver (the complement assembled dense and LU-factored on the
        card), errmeasure: distance to the pinned eigenvalue, tol 1e-12 —
        gates |lambda - ref| < 1e-9 and ||M(lambda) v|| / ||v|| < 1e-10;
    (b) ``iar`` at sigma, neigs 3, maxit 100, tol 1e-8, factorized — gates
        >= 3 pairs, one within 1e-10 of ref;
    (c) GMRES with the SMW preconditioner (N = 21, mm = 525), reltol 1e-10
        on a seeded b — gate ||M(sigma) x - b|| / ||b|| < 1e-8; GMRES steps,
        SMW setup seconds and seconds per preconditioner apply printed;
    (d) the SPMF form of the same problem: (a)'s pair through the merged
        bank (the float64 re/im pair kernel, one launch an apply) against
        the native Mlincomb — gates: on a seeded vector rel 1e-12, at the
        eigenpair a difference <= 1e-12 of the backward-error scale
        sum_i |f_i(lambda)| ||A_i||_F and a backward error <= 1e-10.

    Seconds of the Schur assembly, its LU, each solver, and the peak device
    memory printed; the phase within ``cfg["budget"]`` seconds.  Returns the
    launch counts of the path."""
    from neptpu_torch import (EigvalReferenceErrmeasure, WEPLinSolverCreator,
                              compute_Mlincomb, iar, nep_gallery, resinv)
    from neptpu_torch.models.gallery import waveguide as wg
    from neptpu_torch.ops.mixed import make_mixed_bank
    from neptpu_torch.solvers.spmf_real import (collect_spmf_terms,
                                                spmf_fun_scalars)

    sigma, ref = cfg["sigma"], cfg["ref"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dia_kernel.DIA_SPMV.reset_counts()
    t_phase = time.perf_counter()
    nep, t_build = _timed(torch, lambda: nep_gallery(
        "waveguide", nx=cfg["nx"], nz=cfg["nz"],
        benchmark_problem="JARLEBRING", neptype="WEP", device=DEVICE))
    n = nep.n
    check(n == 11655 and isinstance(nep, wg.WEP_FD),
          f"wep-native: built {type(nep).__name__} of size {n}")
    S, t_schur = _timed(torch, lambda: wg.construct_WEP_schur_complement(
        nep, sigma))
    lu, t_lu = _timed(torch, lambda: torch.linalg.lu_factor(S))
    check(bool(torch.isfinite(lu[0]).all()), "wep-native: non-finite LU")
    print(f"[wep-native] WEP_FD n={n} (interior {nep.nx}x{nep.nz}) built in "
          f"{t_build:.3f} s; Schur complement {tuple(S.shape)} complex128 "
          f"({S.numel() * 16 / 1e9:.2f} GB) assembled in {t_schur:.3f} s, "
          f"LU in {t_lu:.3f} s", flush=True)
    del S, lu

    # (a) resinv with the factorized Schur solver
    v0 = np.ones(n) / np.sqrt(n)
    count = _Count()
    (lam, v), t_a = _timed(torch, lambda: resinv(
        nep, lam=sigma, v=v0, errmeasure=EigvalReferenceErrmeasure(nep, ref),
        tol=1e-12, linsolvercreator=WEPLinSolverCreator(), logger=count,
        device=DEVICE))
    lam = complex(lam)
    res = float(torch.linalg.vector_norm(compute_Mlincomb(nep, lam, v))
                / torch.linalg.vector_norm(v))
    print(f"[wep-native] (a) resinv: lambda {lam} in {t_a:.3f} s, "
          f"{count.n} iterations; |lambda - ref| {abs(lam - ref):.3e} (gate "
          f"1e-9), ||M v||/||v|| {res:.3e} (gate 1e-10)", flush=True)
    check(abs(lam - ref) < 1e-9 and res < 1e-10,
          f"wep-native resinv: |lambda - ref| {abs(lam - ref):.3e}, "
          f"residual {res:.3e}")

    # (b) iar with the factorized Schur solver
    (lams, Q, _), t_b = _timed(torch, lambda: iar(
        nep, sigma=sigma, neigs=3, maxit=100, v=v0, tol=1e-8,
        linsolvercreator=WEPLinSolverCreator(solver_type=":factorized"),
        device=DEVICE))
    lams = np.asarray(lams)
    gap = float(np.min(np.abs(lams - ref))) if len(lams) else np.inf
    print(f"[wep-native] (b) iar: {len(lams)} pairs "
          f"{np.array2string(lams, precision=12)} in {t_b:.3f} s; nearest "
          f"to ref at {gap:.3e} (gate 1e-10)", flush=True)
    check(len(lams) >= 3 and gap < 1e-10,
          f"wep-native iar: {len(lams)} pairs, nearest to ref {gap:.3e}")
    del Q

    # (c) GMRES + SMW preconditioner
    precond, t_smw = _timed(torch, lambda: wg.wep_generate_preconditioner(
        nep, cfg["N"], sigma))
    mm = cfg["N"] ** 2 + 4 * cfg["N"]
    x_int = torch.randn(nep.nx * nep.nz, dtype=torch.complex128,
                        device=DEVICE)
    apply_ms = _median_ms(torch, lambda: precond(x_int), reps=10, inner=5)
    b = np.random.default_rng(2).standard_normal(n) + 0j
    solver = wg.WEPGMRESLinSolver(nep, sigma, preconditioner=precond,
                                  reltol=1e-10)
    x, t_c = _timed(torch, lambda: solver.solve(b))
    r = compute_Mlincomb(nep, sigma, x).cpu().numpy()
    rel = float(np.linalg.norm(r - b) / np.linalg.norm(b))
    print(f"[wep-native] (c) GMRES + SMW(N={cfg['N']}, mm={mm}): SMW setup "
          f"{t_smw:.3f} s (one batched Sylvester FFT solve of {mm} columns, "
          f"one {mm}^2 LU), preconditioner apply {apply_ms:.3f} ms; solve "
          f"{t_c:.3f} s, GMRES steps {solver.iterations} (exit "
          f"{solver.info}); ||M x - b||/||b|| {rel:.3e} (gate 1e-8)",
          flush=True)
    check(rel < 1e-8, f"wep-native GMRES: relative residual {rel:.3e}")

    # (d) the SPMF form through the merged bank (float64 pair kernel)
    spmf = nep_gallery("waveguide", nx=cfg["nx"], nz=cfg["nz"],
                       benchmark_problem="JARLEBRING", neptype="SPMF",
                       device=DEVICE)
    mats, fv = collect_spmf_terms(spmf)
    bank = make_mixed_bank(mats, dtype=np.float64, device=DEVICE)
    m, offs, nb = wep_bank_shape(WEP)
    check(tuple(bank.inner.data.shape) == (m, len(offs), nb)
          and tuple(bank.inner.offsets) == tuple(offs),
          f"wep-native: SPMF main bank {tuple(bank.inner.data.shape)} "
          "differs from the checked wep shape")
    fro = np.array([np.sqrt(np.abs(A.multiply(A.conj())).sum())
                    for A in mats])
    before = dict(dia_kernel.DIA_SPMV.entry_counts)

    def through_bank(lam, u):
        w = torch.as_tensor(spmf_fun_scalars(fv, lam), device=DEVICE)
        return bank.lincomb_apply(u[:, None] * w[None, :])

    u = torch.as_tensor(np.random.default_rng(4).standard_normal(n) + 0j,
                        device=DEVICE)
    y1, y2 = through_bank(lam, u), compute_Mlincomb(nep, lam, u)
    rel_rand = float(torch.linalg.vector_norm(y1 - y2)
                     / torch.linalg.vector_norm(y2))
    vn = v / torch.linalg.vector_norm(v)
    y1, y2 = through_bank(lam, vn), compute_Mlincomb(nep, lam, vn)
    scale = float(np.abs(spmf_fun_scalars(fv, lam)) @ fro)
    diff = float(torch.linalg.vector_norm(y1 - y2)) / scale
    bwd = float(torch.linalg.vector_norm(y1)) / scale
    pair64 = (dia_kernel.DIA_SPMV.entry_counts["dia_lincomb_pair_f64"]
              - before["dia_lincomb_pair_f64"])
    print(f"[wep-native] (d) SPMF form ({len(mats)} terms, main bank "
          f"{m}x{len(offs)}x{nb}): on a seeded vector rel {rel_rand:.3e} "
          f"(gate 1e-12); at (a)'s pair difference {diff:.3e} of the scale "
          f"{scale:.6e} (gate 1e-12), backward error through the bank "
          f"{bwd:.3e} (gate 1e-10); f64 pair launches {pair64}", flush=True)
    check(rel_rand <= 1e-12 and diff <= 1e-12 and bwd <= 1e-10,
          f"wep-native SPMF vs native: rel {rel_rand:.3e}, diff {diff:.3e}, "
          f"backward {bwd:.3e}")
    check(pair64 == 2, f"wep-native: {pair64} f64 pair launches for 2 "
                       "bank applies")
    torch.cuda.synchronize()
    launched = dict(dia_kernel.DIA_SPMV.entry_counts)
    t_phase = time.perf_counter() - t_phase
    print(f"[wep-native] phase {t_phase:.3f} s (budget {cfg['budget']:g} s); "
          f"peak_device_mem {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB", flush=True)
    check(t_phase <= cfg["budget"],
          f"wep-native took {t_phase:.1f} s (> {cfg['budget']:g} s)")
    return launched


def deflated_iar_jitted(device):
    """``iar_jitted`` (sigma 0, maxit 30, one pair) on ``pep0`` (n = 200)
    deflated by the pair the same call finds first: the eigenvalue, the
    deflated one, and how each scan's steps ran (``StepGraph.stats()``)."""
    from neptpu_torch import deflate_eigpair, iar_jitted, nep_gallery
    from neptpu_torch.solvers import iar_jit, scan_graph

    made = []

    class Recorded(scan_graph.StepGraph):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    iar_jit.StepGraph = Recorded
    try:
        nep = nep_gallery("pep0", device=device)
        kw = dict(sigma=0.0, neigs=1, maxit=30, device=device)
        l0, Q0, _ = iar_jitted(nep, **kw)
        l1, _, _ = iar_jitted(deflate_eigpair(nep, complex(l0[0]), Q0[:, 0]),
                              **kw)
    finally:
        iar_jit.StepGraph = scan_graph.StepGraph
    return {"lam": complex(l1[0]), "deflated": complex(l0[0]),
            "graph": [run.stats() for run in made]}


def phase_complex_scan(torch, dia_kernel, gun, dep_nep, found,
                       cfg=COMPLEX_SCAN):
    """The complex-dtype scans on the card, complex128, each through its
    entry point with the launch counts set to 0 just before and read just
    after:

    * ``tiar_jitted_spmf`` on gun_like (n = 9956) at SIGMA, GAMMA, maxit 60,
      neigs 6, checks every 20 steps with the host backward error at tol
      1e-9 — gates >= ``need`` distinct pairs under tol, each within rel 1e-8
      of a pinned eigenvalue, one float64 pair launch a step;
    * ``iar_jitted`` and ``tiar_jitted`` on ``dep_symm_double`` n = 1e4 at
      sigma = -1, maxit 60, neigs 6, errmeasure the delay problem's backward
      error at tol 1e-10 — gates: 6 pairs each, backward error <= 1e-10,
      rel gap <= 1e-6 to float64 ``iar_real``'s eigenvalues (modulo
      conjugation), one float64 pair launch a step;
    * ``iar_jitted`` on ``pep0`` (n = 200) deflated by its first pair, a
      problem whose Mlincomb only calls its inner SPMF's - gates: both
      scans replayed (29 replays each) and the eigenvalue within rel 1e-8
      of the same run on the CPU.

    The phase within ``cfg["budget"]`` seconds.  Returns the launch counts
    by path."""
    from neptpu_torch import iar_jitted, nep_gallery, tiar_jitted
    from neptpu_torch import tiar_jitted_spmf

    out = {}
    t_phase = time.perf_counter()
    backward = gun["backward"]
    nep = nep_gallery("gun_like", device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dia_kernel.DIA_SPMV.reset_counts()
    (lams, Q, info), t_gun = _timed(torch, lambda: tiar_jitted_spmf(
        nep, sigma=SIGMA, gamma=GAMMA, maxit=cfg["maxit"], neigs=cfg["neigs"],
        tol=cfg["tol"], check_error_every=cfg["check_every"],
        errmeasure=backward, return_info=True, device=DEVICE))
    launched = dict(dia_kernel.DIA_SPMV.entry_counts)
    out["gun_like"] = launched
    errs = np.array([backward(complex(x), Q[:, i])
                     for i, x in enumerate(lams)])
    sel = distinct_below_tol(lams, errs, cfg["tol"])
    gaps = np.array([np.min(np.abs(GUN_LIKE_PINNED - lams[j]))
                     / abs(lams[j]) for j in sel])
    pair64 = launched["dia_lincomb_pair_f64"]
    print(f"[complex-scan] tiar_jitted_spmf gun_like n={nep.n} complex128: "
          f"{len(sel)} distinct pairs under {cfg['tol']:g} "
          f"{np.array2string(np.asarray(lams)[sel], precision=10)} in "
          f"{t_gun:.3f} s (LU {info['t_factorize']:.3f} s, scan "
          f"{info['t_scan']:.3f} s, {info['k_done']} steps, nconv "
          f"{info['nconv']}); max backward error "
          f"{max(errs, default=np.nan):.3e}; max rel gap to the pinned "
          f"oracle {max(gaps, default=np.nan):.3e} (gate 1e-8); f64 pair "
          f"launches {pair64}; peak_device_mem "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    check(len(sel) >= cfg["need"] and all(gaps <= 1e-8),
          f"complex-scan gun_like: {len(sel)} distinct pairs, gaps {gaps}")
    check(pair64 == info["k_done"] and sum(launched.values()) == pair64,
          f"complex-scan gun_like: launches {launched} for "
          f"{info['k_done']} steps")
    del nep, Q

    bw_dep, _ = dep_backward(dep_nep)

    def dep_err(lam, q):
        return bw_dep(complex(lam), q.cpu().numpy() if hasattr(q, "cpu")
                      else q)

    runs = (("iar_jitted", lambda: iar_jitted(
                dep_nep, sigma=DEP["sigma"], maxit=cfg["maxit"],
                neigs=cfg["neigs"], tol=cfg["dep_tol"], errmeasure=dep_err,
                device=DEVICE)[:2]),
            ("tiar_jitted", lambda: tiar_jitted(
                dep_nep, sigma=DEP["sigma"], maxit=cfg["maxit"],
                neigs=cfg["neigs"], tol=cfg["dep_tol"], errmeasure=dep_err,
                device=DEVICE)))
    for name, run in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dia_kernel.DIA_SPMV.reset_counts()
        (lams, Q), seconds = _timed(torch, run)
        launched = dict(dia_kernel.DIA_SPMV.entry_counts)
        out[f"dep {name}"] = launched
        lams = np.asarray(lams)
        Qh = Q.cpu().numpy() if hasattr(Q, "cpu") else np.asarray(Q)
        errs = [dep_err(x, Qh[:, i]) for i, x in enumerate(lams)]
        gaps = [_conj_gap(x, found) for x in lams]
        pair64 = launched["dia_lincomb_pair_f64"]
        print(f"[complex-scan] {name} dep_symm_double n={dep_nep.n} "
              f"complex128 sigma={DEP['sigma']}: {len(lams)} pairs "
              f"{np.array2string(lams, precision=10)} in {seconds:.3f} s; "
              f"max backward error {max(errs, default=np.nan):.3e} (gate "
              f"{cfg['dep_tol']:g}); max rel gap to float64 iar_real "
              f"{max(gaps, default=np.nan):.3e} (gate 1e-6); f64 pair "
              f"launches {pair64}; peak_device_mem "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
              flush=True)
        check(len(lams) == cfg["neigs"] and max(errs) <= cfg["dep_tol"]
              and max(gaps) <= 1e-6,
              f"complex-scan {name}: {len(lams)} pairs, backward "
              f"{max(errs, default=np.nan):.3e}, gap "
              f"{max(gaps, default=np.nan):.3e}")
        check(pair64 >= 1 and sum(launched.values()) == pair64,
              f"complex-scan {name}: launches {launched}")
        if name == "iar_jitted":
            check(pair64 == cfg["maxit"],
                  f"complex-scan iar_jitted: {pair64} pair launches for "
                  f"{cfg['maxit']} steps")
    # a problem whose Mlincomb only calls another's: iar_jitted on a
    # deflated PEP, captured on the card, against the same run on the CPU
    card, t_card = _timed(torch, lambda: deflated_iar_jitted(DEVICE))
    host = deflated_iar_jitted("cpu")
    gap = abs(card["lam"] - host["lam"]) / abs(host["lam"])
    conj = abs(card["lam"] - np.conj(card["deflated"])) / abs(card["lam"])
    print(f"[complex-scan] iar_jitted on pep0 (n=200) deflated by "
          f"{card['deflated']:.8f}: {card['lam']:.10f} in {t_card:.3f} s, "
          f"rel gap to the CPU run's {gap:.3e} (gate 1e-8), to the "
          f"deflated value's conjugate {conj:.3e}; steps on the card "
          f"{card['graph']}", flush=True)
    check(gap <= 1e-8 and len(card["graph"]) == 2
          and all(st["graphed"] and st["replays"] == 29
                  for st in card["graph"]),
          f"complex-scan deflated iar_jitted: gap {gap:.3e}, steps "
          f"{card['graph']}")
    t_phase = time.perf_counter() - t_phase
    print(f"[complex-scan] phase {t_phase:.3f} s (budget {cfg['budget']:g} "
          "s)", flush=True)
    check(t_phase <= cfg["budget"],
          f"complex-scan took {t_phase:.1f} s (> {cfg['budget']:g} s)")
    return out


def phase_gallery(torch, dia_kernel):
    """Every gallery problem this slice ports, built on the card through
    ``nep_gallery`` and held to the numbers its tests pin:

    * the registry identity Mlincomb(lam, v) = Mder(lam) v at the points of
      tests/test_gallery_sweep.py, rel 1e-12;
    * ``real_quadratic``'s four real eigenvalues through ``polyeig``
      (rel 1e-9); ``orr_sommerfeld`` (n = 128) through
      ``shift_and_scale(scale=100)`` and ``tiar`` at sigma = 0.006: four
      Table 7.1 values within rel 1e-8; the mathieu ``periodicdde`` through
      ``resinv``: -0.24470143590830754 within 1e-10; ``bem_fichera`` (N = 1):
      sigma_min / sigma_max of M at the pinned eigenvalue < 1e-10; the fiber
      eigenvalue 7.139494306065948e-07 through ``augnewton`` within 1e-10;
      ``cd_player`` (newton), ``hadeler`` (mslp), ``pdde_stability``
      (polyeig) and ``beam`` (augnewton) pairs at their tests' residual
      gates.

    The phase within GALLERY_BUDGET seconds.  Returns the launch counts of
    the fiber problem's path (its DIA bank: the float64 pair kernel)."""
    from neptpu_torch import (PEP, augnewton, compute_Mlincomb,
                              compute_resnorm, mslp, nep_gallery, newton,
                              polyeig, resinv, shift_and_scale, tiar)

    def dense(M):
        return M.to_dense() if hasattr(M, "to_dense") else M

    def _host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    t_phase = time.perf_counter()
    out = {}
    rng = np.random.default_rng(7)
    for name, args, kw, lam in GALLERY_SWEEP:
        dia_kernel.DIA_SPMV.reset_counts()
        nep, t_build = _timed(torch, lambda: nep_gallery(
            name, *args, device=DEVICE, **kw))
        v = torch.as_tensor(rng.standard_normal(nep.n), device=DEVICE)
        z1 = compute_Mlincomb(nep, lam, v[:, None], np.ones(1))
        M = dense(nep.Mder(lam))
        z2 = M @ v.to(M.dtype)
        rel = float(torch.linalg.vector_norm(z1.reshape(-1) - z2)
                    / torch.linalg.vector_norm(z2))
        counts = dict(dia_kernel.DIA_SPMV.entry_counts)
        print(f"[gallery] {name}{args or ''}{kw or ''}: n={nep.n} built in "
              f"{t_build:.3f} s; Mlincomb vs Mder v at {lam}: rel {rel:.3e} "
              f"(gate 1e-12); launches "
              f"{ {k: c for k, c in counts.items() if c} }", flush=True)
        check(rel <= 1e-12 and z1.is_cuda and M.is_cuda,
              f"gallery {name}: Mlincomb vs Mder v rel {rel:.3e} on "
              f"{z1.device}, {M.device}")
        if name == "nlevp_native_fiber":
            out[name] = counts
    results = []

    def gate(what, ok, detail):
        results.append(what)
        print(f"[gallery] {what}: {detail}", flush=True)
        check(ok, f"gallery {what}: {detail}")

    lams, _ = polyeig(nep_gallery("real_quadratic", device=DEVICE))
    lams = _host(lams)
    worst = max(np.min(np.abs(lams - r)) / abs(r) for r in (
        -2051.741417993845, -182.101627437811, -39.344930222838,
        -4.039879577113))
    gate("real_quadratic polyeig", worst <= 1e-9,
         f"four real eigenvalues, max rel gap {worst:.3e} (gate 1e-9)")

    nep = nep_gallery("orr_sommerfeld", 128, device=DEVICE)
    nep1 = shift_and_scale(nep, scale=100.0)
    Av = [dense(A) for A in nep1.get_Av()]
    ms = float(torch.linalg.matrix_norm(Av[-1]))
    nep2 = PEP([(A / ms).cpu().numpy() for A in Av], device=DEVICE)
    (lam, _, _), t = _timed(torch, lambda: tiar(
        nep2, sigma=0.006, v=np.ones(nep.n), neigs=10, maxit=200, tol=1e-14,
        device=DEVICE))
    lam = 100.0 * np.asarray(lam)
    worst = max(np.min(np.abs(lam - r)) / abs(r) for r in (
        0.30865495875240445 + 0.008960297181538185j,
        0.3765784040323032 + 0.09959915134763689j,
        0.4087137042139992 + 0.15906877547743775j,
        -0.2863097014631293 - 0.9011417554715162j))
    gate("orr_sommerfeld tiar", worst <= 1e-8,
         f"n={nep.n}, four Table 7.1 values, max rel gap {worst:.3e} (gate "
         f"1e-8) in {t:.3f} s")

    nep = nep_gallery("periodicdde", name="mathieu", device=DEVICE)
    (lam, v), t = _timed(torch, lambda: resinv(
        nep, lam=-0.2447, v=np.array([0.970208 + 0j, -0.242272 + 0j]),
        tol=np.finfo(float).eps * 10, maxit=100, device=DEVICE))
    err = abs(complex(lam) + 0.24470143590830754)
    gate("periodicdde mathieu resinv", err < 1e-10,
         f"lambda {complex(lam)}, |lambda - ref| {err:.3e} (gate 1e-10) in "
         f"{t:.3f} s")

    nep = nep_gallery("bem_fichera", 1, device=DEVICE)
    M = nep.Mder(8.790558462139456 - 0.010815457827738698j)
    s = torch.linalg.svdvals(M).cpu().numpy()
    gate("bem_fichera", s[-1] / s[0] < 1e-10,
         f"n={nep.n}, sigma_min/sigma_max at the pinned eigenvalue "
         f"{s[-1] / s[0]:.3e} (gate 1e-10)")

    nep = nep_gallery("nlevp_native_fiber", device=DEVICE)
    dia_kernel.DIA_SPMV.reset_counts()
    (lam, v), t = _timed(torch, lambda: augnewton(
        nep, lam=7.14e-7, v=np.ones(nep.n), maxit=100, armijo_factor=0.5,
        armijo_max=10, device=DEVICE))
    out["nlevp_native_fiber"] = {
        k: out["nlevp_native_fiber"].get(k, 0) + c
        for k, c in dia_kernel.DIA_SPMV.entry_counts.items()}
    err = abs(complex(lam) - 7.139494306065948e-07)
    gate("fiber augnewton", err < 1e-10,
         f"n={nep.n}, lambda {complex(lam)}, |lambda - ref| {err:.3e} (gate "
         f"1e-10) in {t:.3f} s")

    def unit_res(nep, lam, v):
        return float(compute_resnorm(nep, lam, v)
                     / torch.linalg.vector_norm(v))

    nep = nep_gallery("nlevp_native_cd_player", device=DEVICE)
    lam, v = newton(nep, lam=-1e5, v=np.ones(nep.n), maxit=50, tol=1e-10,
                    device=DEVICE)
    r = unit_res(nep, lam, v)
    gate("cd_player newton", r < 1e-6, f"lambda {complex(lam)}, residual "
                                       f"{r:.3e} (gate 1e-6)")
    nep = nep_gallery("nlevp_native_hadeler", device=DEVICE)
    lam, v = mslp(nep, lam=10.0, tol=1e-10, device=DEVICE)
    r = float(compute_resnorm(nep, lam, v))
    gate("hadeler mslp", r < 1e-6, f"lambda {complex(lam)}, residual "
                                   f"{r:.3e} (gate 1e-6)")
    nep = nep_gallery("nlevp_native_pdde_stability", device=DEVICE)
    lams, V = polyeig(nep)
    lams = _host(lams)
    i = int(np.argmin(np.abs(lams - 1.0)))
    r = unit_res(nep, lams[i], V[:, i])
    gate("pdde_stability polyeig", r < 1e-8,
         f"n={nep.n}, lambda {complex(lams[i])}, residual {r:.3e} (gate "
         "1e-8)")
    nep = nep_gallery("beam", 50, device=DEVICE)
    lam, v = augnewton(nep, lam=-1.0, v=np.ones(nep.n), maxit=50, tol=1e-10,
                       device=DEVICE)
    r = float(compute_resnorm(nep, lam, v)) / float(
        torch.linalg.matrix_norm(dense(nep.Mder(lam))))
    gate("beam augnewton", r < 1e-8, f"lambda {complex(lam)}, residual over "
                                     f"||M|| {r:.3e} (gate 1e-8)")
    t_phase = time.perf_counter() - t_phase
    print(f"[gallery] phase {t_phase:.3f} s (budget {GALLERY_BUDGET:g} s), "
          f"{len(GALLERY_SWEEP)} problems built, {len(results)} oracles",
          flush=True)
    check(t_phase <= GALLERY_BUDGET,
          f"gallery took {t_phase:.1f} s (> {GALLERY_BUDGET:g} s)")
    return out


# [sharded]: the sharded layer (torch.distributed, SPMD).  (a) one rank over
# NCCL in this process at full size; (b) four ranks on the one card, spawned
# processes over gloo with the collectives staged through the host (NCCL
# refuses two ranks on one GPU), all compute on the card.  One H100 gives
# correctness, not scaling.
SHARDED = dict(world=4, maxit=60, wep=dict(sigma=-3 - 3.5j, maxit=36,
                                           neigs=3, tol=1e-8),
               need=10, budget=180.0,
               # (problem, ranks) run: (a) one rank, (b) four on the card
               runs=(("dep", 1), ("gun_like", 1), ("wep", 1), ("dep", 4),
                     ("gun_like", 4), ("wep", 4), ("headline", 4)),
               # (a): the runs in turns, each form with the scans it runs,
               # the first the main path's (wep's runs are ~7 s each of host
               # bank build and factorization: two turns); the Hessenberg
               # gate between the forms
               turns=(("graph", ("dep", "gun_like", "wep")),
                      ("eager", ("dep", "gun_like", "wep")),
                      ("eager", ("dep", "gun_like")),
                      ("graph", ("dep", "gun_like"))), h_tol=1e-12)
# (b)'s per-rank t_scan at four host-staged ranks before the halo overlap
# and the static-shape step (run S1, NVIDIA H100 80GB HBM3 at 700 W),
# printed beside this run's
SHARDED_S1_T_SCAN = {"dep": 1.78, "gun_like": 2.14, "wep": 1.37}


def block_row(key, ranks):
    """The kernel-check row of a [sharded] rank's block."""
    return (f"{key} block{ranks} "
            f"{'f32' if key == 'headline' else 'f64'}")


def sharded_blocks(gun_bank):
    """The blocks ``(m, offsets, blk)`` kernel B1 is launched on in
    [sharded], by key and rank count: each rank's own rows of the bank (the
    bulk of its apply; the boundary corrections from the neighbours' strips
    are plain torch ops)."""
    shapes = {"dep": dep_bank_shape(DEP["nside"]),
              "gun_like": (gun_bank.nterms, gun_bank.offsets, gun_bank.n),
              "wep": wep_bank_shape(WEP)}
    w = int(round(np.sqrt(HEADLINE_N)))
    shapes["headline"] = (HEADLINE_M, (-w - 1, -w, -w + 1, -1, 0, 1, w - 1,
                                       w, w + 1), HEADLINE_N)
    out = {}
    for key, (m, offs, n) in shapes.items():
        for ranks in (1, SHARDED["world"]):
            out[key, ranks] = (m, offs, -(-n // ranks))
    return out


def _sharded_problems(keys):
    """The full-size problems of [sharded], built on the card."""
    from neptpu_torch import nep_gallery

    make = {"dep": lambda: nep_gallery("dep_symm_double", DEP["nside"],
                                       device=DEVICE),
            "gun_like": lambda: nep_gallery("gun_like", device=DEVICE),
            "wep": lambda: wep_nep(WEP)}
    return {k: make[k]() for k in keys}


def _sharded_scans(torch, dia_kernel, mesh, neps, keys, eager=False):
    """The sharded scans of ``keys`` on ``mesh`` (every rank calls this
    alike): per run the eigenvalues, Ritz vectors, info, launches by entry
    point (counts set to 0 just before), peak device memory and wall.
    ``eager``: inside the eager comparator (``_eager_loop``), where a mesh
    that would capture the step runs it eagerly instead."""
    import contextlib

    from neptpu_torch.parallel.mixed_sharded import iar_real_spmf_sharded
    from neptpu_torch.solvers.iar_sharded import iar_real_sharded
    from neptpu_torch.solvers.scan_graph import _eager_loop

    m = SHARDED["maxit"]
    runs = {
        "dep": lambda: iar_real_sharded(
            neps["dep"], mesh, sigma=DEP["sigma"], maxit=m, neigs=m,
            tol=np.inf, dtype=torch.float64, return_info=True),
        "gun_like": lambda: iar_real_spmf_sharded(
            neps["gun_like"], mesh, sigma=SIGMA, gamma=GAMMA, maxit=m,
            neigs=m, tol=np.inf, dtype=torch.float64, return_info=True),
        "wep": lambda: iar_real_spmf_sharded(
            neps["wep"], mesh, dtype=torch.float64, return_info=True,
            **SHARDED["wep"])}
    out = {}
    for key in keys:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dia_kernel.DIA_SPMV.reset_counts()
        t0 = time.perf_counter()
        with _eager_loop() if eager else contextlib.nullcontext():
            lams, Q, info = runs[key]()
        torch.cuda.synchronize()
        out[key] = {"lams": np.asarray(lams), "Q": Q, "info": info,
                    "entry": dict(dia_kernel.DIA_SPMV.entry_counts),
                    "peak": torch.cuda.max_memory_allocated(),
                    "wall": time.perf_counter() - t0}
    return out


def _headline_sharded(torch, dia_kernel, mesh):
    """``sharded_dia_lincomb`` on the SpMV headline bank (the bank and the
    term-major operand of ``phase_spmv_path``, from the same seed), the
    result gathered; launches counted from 0 around the apply."""
    import scipy.sparse as sp

    from neptpu_torch.ops.dia import DiaTermBank
    from neptpu_torch.parallel import (ShardedDiaBank, shard_vector,
                                       sharded_dia_lincomb, unshard_vector)

    rng = np.random.default_rng(0)
    n, w = HEADLINE_N, int(round(np.sqrt(HEADLINE_N)))
    offs = (-w - 1, -w, -w + 1, -1, 0, 1, w - 1, w, w + 1)
    mats = [sp.diags([rng.standard_normal(n - abs(o)).astype(np.float32)
                      for o in offs], offs, shape=(n, n), format="csr")
            for _ in range(HEADLINE_M)]
    WT = rng.standard_normal((HEADLINE_M, n)).astype(np.float32)
    bank = DiaTermBank.from_matrices(mats, dtype=np.float32, device=DEVICE)
    sb = ShardedDiaBank(bank, mesh.size("rows")).device_put(mesh)
    W_d = shard_vector(WT.T, mesh, sb.blk)
    del bank
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dia_kernel.DIA_SPMV.reset_counts()
    t0 = time.perf_counter()
    y_d = sharded_dia_lincomb(sb, W_d, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    entry = dict(dia_kernel.DIA_SPMV.entry_counts)
    return {"y": unshard_vector(y_d, n, mesh).cpu().numpy(), "entry": entry,
            "wall": wall, "peak": torch.cuda.max_memory_allocated(),
            "info": {"bulk": tuple(sb.data.shape)}}


def _sharded_rank(rank, world, init_file, out_dir, keys):
    """One rank of [sharded] (b): gloo over the host, compute on the card."""
    import pickle

    import torch
    import torch.distributed as dist

    from neptpu_torch.ops import dia_kernel
    from neptpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(device=DEVICE, backend="gloo")
        neps = _sharded_problems(keys)
        out = _sharded_scans(torch, dia_kernel, mesh, neps, keys)
        out["headline"] = _headline_sharded(torch, dia_kernel, mesh)
        out["mesh"] = repr(mesh)
        if rank:  # every rank's eigenvalues, rank 0's vectors
            for key in keys:
                out[key]["Q"] = None
            out["headline"]["y"] = None
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def _graph_against_eager(key, runs):
    """(a)'s ``(form, run)`` of one sharded scan in the order they ran: the
    graph runs (one eager warm-up step, then one replay a step) against the
    eager comparator's.  Prints replays, eager steps, capture seconds, a
    step's time and the B1 launches of each form; gates: m - 1 replays a
    graph run, no graph in an eager one, equal launches, the Hessenberg
    within ``SHARDED["h_tol"]``."""
    forms, runs = [f for f, _ in runs], [r for _, r in runs]
    steps = runs[0]["info"].get("steps", SHARDED["maxit"])
    ref = next(r for f, r in zip(forms, runs) if f == "eager")
    H0 = ref["info"]["hessenberg"]
    gaps = [float(np.linalg.norm(r["info"]["hessenberg"] - H0)
                  / np.linalg.norm(H0)) for r in runs]
    launched = [{k: v for k, v in r["entry"].items() if v} for r in runs]

    def step_ms(r):  # the warm-up step included, the capture not
        info = r["info"]
        return (info["t_scan"] - info["graph"]["capture_s"]) / steps * 1e3

    for form in ("graph", "eager"):
        rs = [r for f, r in zip(forms, runs) if f == form]
        stats = [r["info"]["graph"] for r in rs]
        print(f"[sharded] (a) 1 rank {key} {form}: "
              f"{[st['replays'] for st in stats]} replays, "
              f"{[st['eager_steps'] for st in stats]} eager steps, capture "
              + ", ".join(f"{st['capture_s']:.4f}" for st in stats)
              + " s, " + ", ".join(f"{step_ms(r):.3f}" for r in rs)
              + f" ms a step over {steps} steps; B1 launches "
              f"{launched[forms.index(form)]}", flush=True)
    print(f"[sharded] (a) 1 rank {key}: Hessenberg rel gap to the eager "
          f"comparator {max(gaps):.3e} (gate {SHARDED['h_tol']:g}) over "
          f"{len(runs)} runs, in turns {' '.join(forms)}", flush=True)
    for form, r, n in zip(forms, runs, launched):
        st = r["info"]["graph"]
        if form == "graph":
            check(st["graphed"] and st["eager_steps"] == 1
                  and st["replays"] == steps - 1,
                  f"sharded (a) {key}: the graph run's steps ran as {st}")
        else:
            check(not st["graphed"] and st["why"] == "eager comparator"
                  and st["eager_steps"] == steps,
                  f"sharded (a) {key}: the eager run's steps ran as {st}")
        check(n == launched[0], f"sharded (a) {key}: {form} launched {n}, "
                                f"the first run {launched[0]}")
    check(max(gaps) <= SHARDED["h_tol"],
          f"sharded (a) {key}: Hessenberg rel gap {max(gaps):.3e}")


def _nccl_capture_probe(torch, dist):
    """NCCL collectives held in a captured CUDA graph, at this process's
    one rank: an ``all_reduce`` and an ``all_gather_into_tensor`` of a
    device tensor made in the graph, warmed up on the capture's side stream,
    captured once and replayed three times on new inputs; every replay's
    results exact.  A ``batch_isend_irecv`` to this rank itself is tried
    eagerly first and captured too where the build takes it; where it does
    not, the reason is printed."""
    world = dist.get_world_size()
    x = torch.zeros(4096, dtype=torch.float64, device=DEVICE)
    side = torch.cuda.Stream()

    def collectives():
        y = x * 2.0
        dist.all_reduce(y)
        g = torch.empty(world * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(g, y)
        return y, g

    def p2p():
        r = torch.empty_like(x)
        for work in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x * 3.0, dist.get_rank()),
                 dist.P2POp(dist.irecv, r, dist.get_rank())]):
            work.wait()
        return r

    p2p_why = None
    try:
        x.fill_(1.0)
        ok = torch.equal(p2p(), x * 3.0)
        torch.cuda.synchronize()
        if not ok:
            p2p_why = "a send to this rank itself came back different"
    except (RuntimeError, ValueError) as e:
        p2p_why = f"{type(e).__name__}: {e}"
    bodies = [collectives] + ([p2p] if p2p_why is None else [])
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: communicators and buffers
        for body in bodies:
            body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [body() for body in bodies]
    capture = time.perf_counter() - t0
    exact = []
    for i in range(3):
        x.copy_(torch.arange(x.numel(), dtype=x.dtype, device=DEVICE) + i)
        graph.replay()
        torch.cuda.synchronize()
        y, g = outs[0]
        ok = (torch.equal(y, x * 2.0 * world)
              and all(torch.equal(part, y) for part in g.view(world, -1)))
        if len(outs) > 1:
            ok = ok and torch.equal(outs[1], x * 3.0)
        exact.append(ok)
    graph.reset()
    print(f"[sharded] (a) NCCL capture probe, world {world}: all_reduce + "
          f"all_gather_into_tensor"
          + (" + batch_isend_irecv" if p2p_why is None else "")
          + f" captured in {capture:.4f} s, 3 replays exact: {exact}; "
          + ("batch_isend_irecv captured too" if p2p_why is None else
             f"batch_isend_irecv not captured: the build refuses it at one "
             f"rank ({p2p_why})"), flush=True)
    check(all(exact), f"NCCL capture probe: replays exact {exact}")


def phase_sharded(torch, dia_kernel, dep_nep, pairs64, beyn_serial,
                  headline_y, gun_bank):
    """[sharded]: the sharded layer through its entry points.

    (a) ONE rank over NCCL (a world of one on an in-memory store) in this
    process: ``iar_real_sharded`` on the float64 delay problem at [dep]'s
    settings (maxit 60), ``iar_real_spmf_sharded`` on gun_like at
    (SIGMA, GAMMA) and on wep (JARLEBRING 109 x 105) at sigma = -3 - 3.5i
    (maxit 36, 3 pairs), and ``contour_beyn(mesh=...)`` on [rational]'s
    ellipse.  At one rank SPIKE is the dense LU of the whole interleaved
    system (3.2-4.3 GB).  Gates: delay problem >= 10 pairs at backward error
    <= 1e-10 within rel 1e-9 of float64 ``iar_real``'s; gun_like the 4
    converged pairs (backward <= 1e-9) nearest sigma within rel 1e-9 of the
    serial float64 ``iar_real_spmf(scaled=True)`` pairs, its distinct pairs
    <= 1e-9 each within rel 1e-9 of the pinned oracle or of the serial
    scan's (the oracle misses two eigenvalues in its disk), >= 10 on the
    oracle; wep >= 3 converged, each within 1e-10 of a serial pair, residual
    < 1e-8; Beyn the 6 pinned values in the ellipse within rel 1e-8 of the
    serial run.

    Each scan's steps are one captured CUDA graph, replayed (the
    static-shape sharded step; at this one rank its collectives return at
    once, so the graph holds none); each runs in
    turns through the graph and as the eager comparator (``_eager_loop``):
    the graph runs replay m - 1 times after one warm-up step, both forms
    launch the same kernels, meet the gates above and give the same
    Hessenberg to rel 1e-12.  Then a probe captures NCCL's ``all_reduce``
    and ``all_gather_into_tensor`` (and ``batch_isend_irecv`` where the
    build takes one at one rank) and replays them exactly.

    (b) FOUR ranks on the one card (spawned processes, ``backend="gloo"``
    with ``device="cuda"``: every collective copies its tensor to the host
    and back, compute stays on the card): the three scans of (a) with the
    same gates, every step eager (the host-staged mesh's up-front decision,
    printed by every rank), and ``sharded_dia_lincomb`` on the SpMV headline
    bank against the single-card apply (rel 1e-6).

    Every sharded apply is the halo exchange started, one B1 launch on the
    rank's block, then the boundary corrections from the strips: each scan
    launches one float64 B1 pair kernel per step and no single kernel.
    Within SHARDED["budget"] seconds.  Returns the launches by path."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from neptpu_torch import (StandardSPMFErrmeasure, compute_resnorm,
                              contour_beyn, iar_real_spmf)
    from neptpu_torch.parallel import make_mesh
    from neptpu_torch.solvers.spmf_real import collect_spmf_terms

    t_phase = time.perf_counter()
    world, need, maxit = SHARDED["world"], SHARDED["need"], SHARDED["maxit"]
    blocks = sharded_blocks(gun_bank)
    paths = {}
    neps = _sharded_problems(("gun_like", "wep"))
    neps["dep"] = dep_nep
    dep_bw = dep_backward(dep_nep)[0]
    gun_bw = backward_errmeasure(*collect_spmf_terms(neps["gun_like"]))
    l64 = np.asarray(pairs64[0])[pairs64[2] <= 1e-10]

    # the serial float64 references the gates need beyond [dep-protocol]'s
    t0 = time.perf_counter()
    ls, Qs = iar_real_spmf(neps["gun_like"], sigma=SIGMA, gamma=GAMMA,
                           maxit=maxit, neigs=maxit, tol=np.inf,
                           dtype=torch.float64, scaled=True, device=DEVICE)
    es = np.array([gun_bw(complex(x), Qs[:, i]) for i, x in enumerate(ls)])
    gun_serial = np.asarray(ls)[es <= 1e-9]
    wep_serial, _ = iar_real_spmf(neps["wep"], dtype=torch.float64,
                                  scaled=True, device=DEVICE,
                                  **SHARDED["wep"])
    wep_serial = np.asarray(wep_serial)
    print(f"[sharded] serial float64 references in "
          f"{time.perf_counter() - t0:.3f} s: gun_like iar_real_spmf "
          f"(scaled) {len(gun_serial)} pairs at backward <= 1e-9, wep "
          f"{len(wep_serial)} pairs; delay problem {len(l64)} float64 "
          "iar_real pairs at backward <= 1e-10 (from [dep-protocol])",
          flush=True)

    def report(tag, key, run, ranks):
        info = run["info"]
        launched = {k: v for k, v in run["entry"].items() if v}
        steps = info.get("steps", maxit)
        graph = info.get("graph")
        how = "" if graph is None else (
            f" graphed {str(graph['graphed']).lower()}"
            f"{'' if graph['why'] is None else ' (' + graph['why'] + ')'}, "
            f"{graph['replays']} replays + {graph['eager_steps']} eager "
            f"steps, capture {graph['capture_s']:.4f} s;")
        print(f"[sharded] {tag} {key}:{how} B1 bulk (m, ndiag, blk) "
              f"{info['bulk']} SPIKE block {info.get('spike_block')}"
              f" reduced {info.get('reduced')} t_factorize "
              f"{info.get('t_factorize', 0.0):.3f} s t_scan "
              f"{info.get('t_scan', 0.0):.3f} s wall {run['wall']:.3f} s "
              f"launches {launched} peak_device_mem "
              f"{run['peak'] / 2**20:.1f} MiB", flush=True)
        m, offs, blk = blocks[key, ranks]
        check(info["bulk"] == (m, len(offs), blk),
              f"sharded {tag} {key}: B1 bulk {info['bulk']}, the kernel "
              f"checks ran at {(m, len(offs), blk)}")
        if key == "headline":
            check(run["entry"]["dia_lincomb_f32"] == 1
                  and sum(run["entry"].values()) == 1,
                  f"sharded {tag} headline: launches {launched}")
            return
        check(run["entry"]["dia_lincomb_pair_f64"] == steps
              and sum(run["entry"].values()) == steps,
              f"sharded {tag} {key}: {steps} steps launched {launched} "
              "(need one float64 pair launch a step and nothing else)")
        if ranks > 1:  # host-staged: the up-front eager decision
            check(not graph["graphed"] and graph["why"] == "host-staged"
                  and graph["eager_steps"] == steps,
                  f"sharded {tag} {key}: host-staged steps ran as {graph}")

    def gate_dep(tag, run):
        lams, Q = run["lams"], run["Q"]
        errs = np.array([dep_bw(complex(x), Q[:, i])
                         for i, x in enumerate(lams)])
        good = lams[errs <= 1e-10]
        gaps = np.array([_conj_gap(x, l64) for x in good])
        matched = int(np.sum(gaps <= 1e-9))
        print(f"[sharded] {tag} dep: {len(good)} of {len(lams)} Ritz pairs "
              f"at backward error <= 1e-10, {matched} of them within rel "
              f"1e-9 of float64 iar_real's (need {need}; rel gaps "
              f"{np.array2string(np.sort(gaps), precision=2)})", flush=True)
        check(matched >= need, f"sharded {tag} dep: {matched} pairs at "
                               "backward error <= 1e-10 matched to rel 1e-9")

    def gate_gun(tag, run):
        lams, Q = run["lams"], run["Q"]
        errs = np.array([gun_bw(complex(x), Q[:, i])
                         for i, x in enumerate(lams)])
        conv = lams[errs <= 1e-9]
        near = conv[np.argsort(np.abs(conv - SIGMA))][:4]
        gaps = np.array([_conj_gap(x, gun_serial) for x in near])
        found = lams[distinct_below_tol(lams, errs, 1e-9)]
        pin = np.array([np.min(np.abs(GUN_LIKE_PINNED - x)) / abs(x)
                        for x in found])
        other = np.array([_conj_gap(x, gun_serial) for x in found])
        print(f"[sharded] {tag} gun_like: {len(conv)} Ritz pairs at backward "
              f"error <= 1e-9, the 4 nearest sigma "
              f"{np.array2string(near, precision=10)} within rel "
              f"{max(gaps, default=np.nan):.3e} of the serial scan's (gate "
              f"1e-9); {len(found)} distinct, {int(np.sum(pin <= 1e-9))} on "
              f"the pinned oracle (rel 1e-9, need {need}), the others "
              f"{np.array2string(found[pin > 1e-9], precision=10)} within "
              f"rel {max(other[pin > 1e-9], default=0.0):.3e} of the serial "
              "scan's (gate 1e-9)", flush=True)
        check(len(near) == 4 and max(gaps) <= 1e-9
              and np.sum(pin <= 1e-9) >= need
              and all((pin <= 1e-9) | (other <= 1e-9)),
              f"sharded {tag} gun_like: near {near} gaps {gaps}, pinned "
              f"gaps {pin}, gaps to the serial scan {other}")

    def gate_wep(tag, run):
        lams = run["lams"]
        res = [float(compute_resnorm(neps["wep"], complex(x), torch.as_tensor(
            run["Q"][:, i], device=DEVICE))) for i, x in enumerate(lams)]
        gaps = [float(np.min(np.abs(wep_serial - x))) for x in lams]
        print(f"[sharded] {tag} wep: nconv {run['info']['nconv']}, "
              f"eigenvalues {np.array2string(lams, precision=10)}, max |gap| "
              f"to the serial scan {max(gaps, default=np.nan):.3e} (gate "
              f"1e-10), max residual {max(res, default=np.nan):.3e} (gate "
              "1e-8)", flush=True)
        check(run["info"]["nconv"] >= 3 and len(lams) == 3
              and max(gaps) < 1e-10 and max(res) < 1e-8,
              f"sharded {tag} wep: {lams}, gaps {gaps}, res {res}")

    gates = {"dep": gate_dep, "gun_like": gate_gun, "wep": gate_wep}

    # ---- (a) one rank, NCCL, in this process -----------------------------
    check(not dist.is_initialized(), "a process group already exists")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(device=DEVICE)
        print(f"[sharded] (a) {mesh}: backend {mesh.backend}, world size "
              f"{dist.get_world_size()}", flush=True)
        check(mesh.backend == "nccl" and not mesh.host_staged,
              f"(a) runs over {mesh}")
        turns = [(form, _sharded_scans(torch, dia_kernel, mesh, neps, keys,
                                       eager=form == "eager"))
                 for form, keys in SHARDED["turns"]]
        for key in [k for k, r in SHARDED["runs"] if r == 1]:
            runs = [(form, out[key]) for form, out in turns if key in out]
            for form, run in runs:
                report(f"(a) 1 rank {form}", key, run, 1)
                gates[key](f"(a) 1 rank {form}", run)
            paths[f"sharded {key} r1"] = runs[0][1]["entry"]
            _graph_against_eager(key, runs)
        del turns, runs
        _nccl_capture_probe(torch, dist)
        # node-sharded quadrature on [rational]'s ellipse
        cfg = RATIONAL
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lb, _ = contour_beyn(neps["gun_like"], sigma=cfg["center"],
                             radius=cfg["radius"], N=cfg["N"], neigs=6, k=8,
                             errmeasure=StandardSPMFErrmeasure,
                             chunk=cfg["chunk"], mesh=mesh)
        torch.cuda.synchronize()
        lb = np.asarray(lb)
        gaps = [float(np.min(np.abs(beyn_serial - x)) / abs(x)) for x in lb]
        print(f"[sharded] (a) 1 rank contour_beyn(mesh=) N={cfg['N']}: "
              f"{len(lb)} eigenvalues in {time.perf_counter() - t0:.3f} s, "
              f"max rel gap to the serial contour_beyn "
              f"{max(gaps, default=np.nan):.3e} (gate 1e-8), peak_device_mem "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
              flush=True)
        check(len(lb) == len(beyn_serial) == 6 and max(gaps) <= 1e-8,
              f"sharded (a) contour_beyn: {lb} against {beyn_serial}")
    finally:
        dist.destroy_process_group()

    # ---- (b) four ranks on the one card: gloo, host-staged ---------------
    keys = tuple(k for k, r in SHARDED["runs"]
                 if r == world and k != "headline")
    torch.cuda.empty_cache()  # this process's cached blocks, for the ranks
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_sharded_rank, args=(world, os.path.join(tmp, "rdv"), tmp,
                                      keys), nprocs=world, join=True)
        import pickle

        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                ranks.append(pickle.load(fh))
    t_b = time.perf_counter() - t0
    print(f"[sharded] (b) {ranks[0]['mesh']}: backend gloo, world size "
          f"{world}, every collective staged through the host, compute on "
          f"the card; spawn to join {t_b:.3f} s", flush=True)
    tag = f"(b) {world} ranks"
    for key in keys + ("headline",):
        for r, out in enumerate(ranks):
            report(f"{tag} rank {r}", key, out[key], world)
            if key != "headline":
                print(f"[sharded] {tag} rank {r} {key}: t_scan "
                      f"{out[key]['info']['t_scan']:.3f} s with the halo "
                      f"overlap, eager (host-staged); S1 (before them) "
                      f"{SHARDED_S1_T_SCAN[key]:.2f} s", flush=True)
            if key != "headline":
                check(np.array_equal(out[key]["lams"], ranks[0][key]["lams"]),
                      f"sharded {tag} {key}: rank {r}'s eigenvalues differ")
        paths[f"sharded {key} r{world}"] = {
            k: sum(out[key]["entry"][k] for out in ranks)
            for k in ranks[0][key]["entry"]}
    for key in keys:
        gates[key](tag, ranks[0][key])
    y = ranks[0]["headline"]["y"]
    rel = float(np.abs(y - headline_y).max() / np.abs(headline_y).max())
    print(f"[sharded] {tag} headline sharded_dia_lincomb n={HEADLINE_N}: max "
          f"rel err vs the single-card B1 apply {rel:.3e} (gate 1e-6)",
          flush=True)
    check(rel <= 1e-6, f"sharded headline apply off by {rel:.3e}")
    t_phase = time.perf_counter() - t_phase
    print(f"[sharded] phase {t_phase:.3f} s (budget {SHARDED['budget']:g} s)",
          flush=True)
    check(t_phase <= SHARDED["budget"],
          f"sharded took {t_phase:.1f} s (> {SHARDED['budget']:g} s)")
    return paths


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="TRACE.json", default=None,
                    help="also profile one shift's factorization and scan of "
                         "gun_like and of wep; chrome traces go to this file "
                         "and to the same name with '.wep' before the suffix")
    ap.add_argument("--parent", metavar="DIR", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_chip_copy", "parent"),
                    help="an unpacked copy of the parent commit (git archive "
                         "HEAD | tar -x -C DIR): where it is there, its "
                         "kernel body is timed in turns beside the present "
                         "one")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of [generic]'s quartic PEP and operands")
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
    parent = None
    parent_source = os.path.join(args.parent, "neptpu_torch", "csrc",
                                 "dia_spmv.cu")
    if os.path.exists(parent_source):
        parent = ParentBody(torch, dia_kernel, parent_source)
        print(f"[build] parent body {parent_source} built in "
              f"{parent.build_seconds or 0.0:.3f} s", flush=True)
    else:
        print(f"[kernel] no copy of the parent commit under {args.parent}: "
              "its kernel body is not measured in this run", flush=True)
    gun_bank = nep_gallery("gun_like", device=DEVICE).nep1.bank
    rows = phase_kernel_checks(torch, dia_kernel, gun_bank, parent=parent,
                               extra=gallery_dia_banks(torch))

    # launches by C entry point on each main path (counts set to 0 just
    # before a path is driven and read just after)
    spmv = phase_spmv_path(torch, dia_kernel)
    paths = {"spmv": spmv["entry"]}
    # the generic body's path: a quartic PEP at n = 1e6
    paths["generic"] = phase_generic(torch, dia_kernel, args.seed)
    gun = run_time_to_tol(
        torch, dia_kernel, "gun_like",
        lambda: nep_gallery("gun_like", device=DEVICE), SIGMA, gamma=GAMMA,
        maxit=60, neigs=10, tol=1e-6, tol_refine=1e-11,
        pinned=GUN_LIKE_PINNED)
    paths["gun_like"] = gun["entry"]
    wep_refined = None
    for key, cfg in (("wep", WEP), ("wep_large", WEP_LARGE)):
        wep = phase_wep(torch, dia_kernel, key, cfg)
        paths[key] = wep["entry"]
        phase_wep_bank_share(torch, key, cfg, wep)
        if key == "wep":
            wep_refined = wep["refined"]
        del wep
    # the restarted scan with deflation inside the step, on gun_like and wep
    deflated = [
        phase_spmf_deflated(
            torch, dia_kernel, "gun_like",
            lambda: nep_gallery("gun_like", device=DEVICE), SIGMA, GAMMA,
            SPMF_DEFLATED["gun_like"], "host", tol_refine=1e-11,
            pinned=GUN_LIKE_PINNED),
        phase_spmf_deflated(
            torch, dia_kernel, "wep", lambda: wep_nep(WEP), WEP["sigmas"][0],
            1.0, SPMF_DEFLATED["wep"], "chip", reference=wep_refined)]
    for key, out in zip(("gun_like", "wep"), deflated):
        paths[f"spmf-deflated {key}"] = out["entry"]
    t_deflated = sum(out["wall"] for out in deflated)
    print(f"[spmf-deflated] phase {t_deflated:.3f} s (budget 200 s)",
          flush=True)
    check(t_deflated <= 200.0,
          f"spmf-deflated took {t_deflated:.1f} s (> 200 s)")
    dep = phase_dep(torch, dia_kernel, DEP)
    for key, entry in dep["entry"].items():
        paths[f"dep {key}"] = entry
    paths["dep-protocol"], found, pairs64 = phase_dep_protocol(
        torch, dia_kernel, DEP, dep)
    paths["dep-deflation"] = phase_dep_deflation(torch, dia_kernel, DEP, dep,
                                                 found)
    # the Krylov variants and dense Newton solvers: iar_chebyshev's shifted
    # problem has one more term, broyden's a smaller grid, so their launches
    # are kept apart from the delay problem's shape
    krylov = phase_dep_krylov(torch, dia_kernel, DEP, dep, found, pairs64)
    for name, launched in krylov.items():
        prefix = {"iar_chebyshev": "shifted-dep",
                  "broyden": "dep40"}.get(name, "dep-krylov")
        paths[f"{prefix} {name}"] = {
            k: launched.get(k, 0) for k in dia_kernel.DIA_SPMV.entry_counts}
    dep_nep = dep["nep0"]  # the float64 delay problem, for [complex-scan]
    del dep
    # the rational-Krylov, AAA and contour family on gun_like
    rational, beyn = phase_rational(torch, dia_kernel, gun)
    for name, launched in rational.items():
        paths[f"rational {name}"] = {
            k: launched.get(k, 0) for k in dia_kernel.DIA_SPMV.entry_counts}
    phase_refine_chip(torch, gun)
    # this slice's paths: the native waveguide, the complex-dtype scans and
    # the rest of the gallery
    paths["wep-native"] = phase_wep_native(torch, dia_kernel)
    for key, launched in phase_complex_scan(torch, dia_kernel, gun, dep_nep,
                                            found).items():
        paths[f"complex-scan {key}"] = launched
    # every ported scan through its graph beside the eager step loop
    phase_scan_graph(torch, dia_kernel, profile=bool(args.profile))
    for key, launched in phase_gallery(torch, dia_kernel).items():
        paths[f"gallery {key}"] = launched
    # the sharded layer: one rank over NCCL, four ranks on the card
    paths.update(phase_sharded(torch, dia_kernel, dep_nep, pairs64, beyn,
                               spmv["y"], gun_bank))
    if args.profile:
        phase_profile(torch, args.profile, "gun_like",
                      lambda: nep_gallery("gun_like", device=DEVICE), SIGMA,
                      GAMMA, 60, 10, 1e-6)
        stem, dot, ext = args.profile.rpartition(".")
        phase_profile(torch, f"{stem}.wep{dot}{ext}" if dot else
                      args.profile + ".wep", "wep", lambda: wep_nep(WEP),
                      WEP["sigmas"][0], 1.0, 100, 8, 1e-5)
        phase_step_launches(torch)
    print(f"[done] total {time.perf_counter() - t0:.3f} s", flush=True)

    def launches(entries, on):
        """Launches through the C entry points ``entries`` on the main paths
        whose name starts with one of ``on``."""
        return {k: sum(c[e] for e in entries) for k, c in paths.items()
                if k.startswith(on)}

    every = ("spmv", "gun_like", "wep", "dep", "spmf-deflated",
             "shifted-dep", "rational", "complex-scan", "gallery")
    f3264 = ("_f32", "_f64")
    # name, kernel-check row, C entry points, main paths that hand the kernel
    # this shape: first each wrapper at the shape of its busiest path (the
    # single-operand kernel at the SpMV headline, the pair kernel at the
    # wep bank) with the launches of every path, then the delay
    # problem's shape and the bfloat16 kernels
    table = [
        ("dia_lincomb", "headline f32",
         [f"dia_lincomb{x}" for x in f3264], every),
        ("dia_lincomb_pair", "wep f32 pair",
         [f"dia_lincomb_pair{x}" for x in f3264], every),
        ("dia_lincomb_f32@dep", "dep f32", ["dia_lincomb_f32"], ("dep",)),
        ("dia_lincomb_pair_f32@dep", "dep f32 pair",
         ["dia_lincomb_pair_f32"], ("dep",)),
        ("dia_lincomb_f64@dep", "dep f64", ["dia_lincomb_f64"], ("dep",)),
        ("dia_lincomb_pair_f64@dep", "dep f64 pair",
         ["dia_lincomb_pair_f64"], ("dep ", "dep-", "complex-scan dep")),
        ("dia_lincomb_pair_f64@gun_like", "gun_like f64 pair",
         ["dia_lincomb_pair_f64"],
         ("spmf-deflated gun_like", "rational", "complex-scan gun_like")),
        ("dia_lincomb_pair_f64@wep", "wep f64 pair",
         ["dia_lincomb_pair_f64"], ("wep-native",)),
        ("dia_lincomb_pair_f64@shifted_dep", "shifted dep f64 pair",
         ["dia_lincomb_pair_f64"], ("shifted-dep",)),
        ("dia_lincomb_pair_f64@dep40", "dep40 f64 pair",
         ["dia_lincomb_pair_f64"], ("dep40",)),
        ("dia_lincomb_bf16", "headline bf16", ["dia_lincomb_bf16"],
         ("spmv",)),
        ("dia_lincomb_pair_bf16", "headline bf16 pair",
         ["dia_lincomb_pair_bf16"], ("spmv",)),
        ("dia_lincomb_bf16@dep", "dep bf16", ["dia_lincomb_bf16"], ("dep",)),
        ("dia_lincomb_pair_bf16@dep", "dep bf16 pair",
         ["dia_lincomb_pair_bf16"], ("dep",)),
        # the generic body, on [generic]'s quartic PEP (n = 1e6, 5 terms)
        ("dia_lincomb_f32@generic", "quartic f32", ["dia_lincomb_f32"],
         ("generic",)),
        ("dia_lincomb_pair_f32@generic", "quartic f32 pair",
         ["dia_lincomb_pair_f32"], ("generic",)),
        ("dia_lincomb_pair_f64@generic", "quartic f64 pair",
         ["dia_lincomb_pair_f64"], ("generic",)),
        ("dia_lincomb_bf16@generic", "quartic bf16", ["dia_lincomb_bf16"],
         ("generic",)),
    ]
    # the gallery problems' DIA banks: a row for each entry point their
    # paths launched, at least one per bank
    for key, problem in (("fiber", "nlevp_native_fiber"),):
        gal = [(f"dia_lincomb{p}_f64@{key}", f"{key} f64{sfx}",
                [f"dia_lincomb{p}_f64"], (f"gallery {problem}",))
               for p, sfx in (("", ""), ("_pair", " pair"))]
        gal = [row for row in gal if sum(launches(row[2], row[3]).values())]
        check(len(gal) > 0, f"the {key} bank was launched on no path")
        table += gal
    # [sharded]: B1 on each rank's block, at one rank and at four
    for key, ranks in SHARDED["runs"]:
        single = key == "headline"
        entry = "dia_lincomb_f32" if single else "dia_lincomb_pair_f64"
        table.append((f"{entry}@{key}_block{ranks}",
                      block_row(key, ranks) + ("" if single else " pair"),
                      [entry], (f"sharded {key} r{ranks}",)))
    kernels = []
    for name, key, entries, on in table:
        row, by_path = rows[key], launches(entries, on)
        check(sum(by_path.values()) > 0,
              f"kernel {name} was launched on no main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "neptpu_torch/csrc/dia_spmv.cu",
            "replaces": "neptpu/ops/pallas_spmv.py:76",
            "launches": sum(by_path.values()),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            # the same under CUDA-graph replay (n <= 1e5), and the parent
            # commit's body timed in turns with this one (where present)
            "graph_ms": row["graph_ms"],
            "library_graph_ms": row["library_graph_ms"],
            "parent_ms": row["parent_ms"],
            "parent_graph_ms": row["parent_graph_ms"],
            "shape": f"{row['shape']} n={row['n']} m={row['m']} "
                     f"ndiag={row['ndiag']}",
            "body": row["body"],
            "entry_points": entries,
            "launches_by_path": by_path})
    print(json.dumps({"kernels": kernels}), flush=True)
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
