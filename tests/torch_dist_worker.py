"""Rank workers of the sharded-layer parity tests (``test_torch_parallel.py``,
``test_torch_sharded_scans.py``).

A test module spawns ONE world of gloo ranks on the CPU
(:func:`spawn_world`: ``torch.multiprocessing`` spawn, file-based
rendezvous, one intra-op thread a rank) that runs every check it names and
writes each rank's results to a pickle; the tests then compare them with the
JAX package's sharded functions, run in the test process on the same numpy
inputs (the ``*_inputs`` functions here).  This module and what it imports
never load ``jax`` or ``neptpu``: the spawned ranks import only the port.

Run as a script (``python torch_dist_worker.py multihost``) it is one
process of a two-process world wired from the torchrun variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) through
``make_mesh(multihost=True)``; ``python torch_dist_worker.py coordinator
HOST:PORT RANK`` wires one through the JAX package's arguments of
``initialize_distributed`` and ``make_mesh(devices=...)``.
"""
import os
import pickle
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from torch_port_helpers import (CPU, NoHostFunctions, NoScalarReads,  # noqa: E402
                                small_gun_ops)

WORLD = 4
# the delay-problem shift and the small gun's shift of the JAX tests
DEP_SIGMA = -0.2 + 0.1j
GUN_SIGMA = 30 + 1j
SMW_SIGMA = -1.3 - 0.31j


# -- inputs, the same numpy arrays on both sides ---------------------------
def dia_inputs():
    """``test_parallel.py``'s halo case: 3 banded terms at n = 237 with
    offsets (-15, -1, 0, 1, 15) and an operand W (n, 3)."""
    rng = np.random.default_rng(0)
    n, m, w = 237, 3, 15
    offs = [-w, -1, 0, 1, w]
    mats = [sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                     shape=(n, n), format="csr") for _ in range(m)]
    return mats, rng.standard_normal((n, m))


def csr_inputs():
    """``dep0_sparse(100, 0.2)``'s terms (general sparsity) and W (n, 2)."""
    import neptpu_torch

    mats = neptpu_torch.nep_gallery("dep0_sparse", 100, 0.2,
                                    device=CPU).bank.host_csr_terms()
    return mats, np.random.default_rng(0).standard_normal((100, len(mats)))


def gram_inputs():
    rng = np.random.default_rng(1)
    V = rng.standard_normal((64, 5)) + 1j * rng.standard_normal((64, 5))
    return V, rng.standard_normal(64) + 0j


def spike_inputs(complex_=False):
    """``test_parallel.py``'s SPIKE cases: a banded (n = 237, offsets
    (-9, -1, 0, 1, 9)) diagonally weighted matrix and a block RHS; with
    ``complex_`` the complex matrix and RHS of the interleaved case."""
    rng = np.random.default_rng(0)
    n, w = 237, 9
    offs = [-w, -1, 0, 1, w]
    diags = [rng.standard_normal(n - abs(o)) for o in offs]
    diags[2] += 8.0
    A = sp.diags(diags, offs, shape=(n, n)).toarray()
    if not complex_:
        return A, offs, rng.standard_normal((n, 3))
    Ac = A + 1j * sp.diags([rng.standard_normal(n - abs(o)) for o in offs],
                           offs, shape=(n, n)).toarray()
    return Ac, offs, rng.standard_normal(n) + 1j * rng.standard_normal(n)


def smw_rhs(n):
    rng = np.random.default_rng(3)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def moments_inputs():
    rng = np.random.default_rng(10)
    return rng.standard_normal((5, 2)) + 0j


MOMENTS = dict(sigma=-0.16, radius=0.3, N=64, n_moments=2)
BEYN = dict(sigma=-0.2, radius=0.7, neigs=2, N=64, tol=1e-6)
IAR_DEP = dict(n=512, sigma=DEP_SIGMA, maxit=40, neigs=4, tol=1e-6)
IAR_GUN = dict(sigma=GUN_SIGMA, maxit=35, neigs=3, tol=1e-8)


# -- the checks a rank runs ------------------------------------------------
def check_collectives(rows, nodes):
    """The Mesh collectives on rank-numbered tensors."""
    r = rows.rank("rows")
    x = torch.full((2,), float(r + 1), dtype=torch.float64)
    prev, nxt = rows.neighbour_exchange(x * 10, x * 100, "rows")
    # the started form, with work in between
    pending = rows.neighbour_exchange_start(x * 10, x * 100, "rows")
    between = rows.psum(x, "rows")
    prev2, nxt2 = pending.wait()
    return {"rank": (r, nodes.rank("nodes"), rows.rank("nodes")),
            "started": (prev2.numpy(), nxt2.numpy(), between.numpy()),
            "psum": rows.psum(x, "rows").numpy(),
            "psum_nodes": rows.psum(x, "nodes").numpy(),
            "gather": nodes.all_gather(x, "nodes").numpy(),
            "from_prev": prev.numpy(), "from_next": nxt.numpy()}


def check_dia(rows, nodes):
    """``sharded_dia_lincomb`` (the bulk/boundary apply), its functional
    form (``halo_exchange`` + ``local_halo_lincomb``) and the one-launch
    window form on the same strips, gathered."""
    from neptpu_torch.ops.dia import DiaTermBank
    from neptpu_torch.parallel import (ShardedDiaBank, halo_exchange,
                                       local_halo_lincomb, shard_vector,
                                       sharded_dia_lincomb, unshard_vector)
    from neptpu_torch.parallel.halo import _window_bank, window_operand

    mats, W = dia_inputs()
    n = W.shape[0]
    bank = DiaTermBank.from_matrices(mats, device=CPU)
    sb = ShardedDiaBank(bank, rows.size("rows")).device_put(rows)
    W_d = shard_vector(W, rows, sb.blk)
    y = unshard_vector(sharded_dia_lincomb(sb, W_d, rows), n, rows)
    prev, nxt = halo_exchange(W_d, sb.halo_lo, sb.halo_hi, rows)
    y2 = local_halo_lincomb(sb.data, sb.offsets, W_d, prev, nxt, sb.halo_lo,
                            sb.halo_hi)
    win = _window_bank(sb.data, sb.offsets, sb.halo_lo, sb.halo_hi)
    y3 = win.lincomb_apply_t(window_operand(W_d.T, prev.T, nxt.T))
    y3 = y3[sb.halo_lo: sb.halo_lo + sb.blk]
    return {"y": y.numpy(), "y_functional":
            unshard_vector(y2, n, rows).numpy(),
            "y_window": unshard_vector(y3, n, rows).numpy(),
            "bulk": tuple(sb.data.shape)}


def check_csr(rows, nodes):
    from neptpu_torch.ops.sparse import SparseTermBank
    from neptpu_torch.parallel import RowShardedBank, sharded_lincomb_apply

    mats, W = csr_inputs()
    sbank = RowShardedBank(SparseTermBank.from_matrices(mats, device=CPU),
                           rows.size("rows")).device_put(rows)
    return {"y": sharded_lincomb_apply(sbank, W, rows).numpy()}


def check_gram(rows, nodes):
    from neptpu_torch.parallel import sharded_gram

    V, w = gram_inputs()
    blk = V.shape[0] // rows.size("rows")
    r = rows.rank("rows")
    mine = slice(r * blk, (r + 1) * blk)
    return {"h": sharded_gram(torch.as_tensor(V[mine]),
                              torch.as_tensor(w[mine]), rows).numpy()}


def check_spike(rows, nodes):
    from neptpu_torch.parallel import (SpikeBandedSolver,
                                       dia_strips_from_dense,
                                       interleave_complex_banded)

    A, offs, B = spike_inputs()
    X = SpikeBandedSolver(dia_strips_from_dense(A, offs), offs, rows).solve(B)
    Ac, offs, bc = spike_inputs(complex_=True)
    rstrips, roffs = interleave_complex_banded(
        dia_strips_from_dense(Ac, offs), offs)
    f = np.zeros(2 * len(bc))
    f[0::2], f[1::2] = bc.real, bc.imag
    xr = SpikeBandedSolver(rstrips, roffs, rows).solve(f).numpy()
    return {"X": X.numpy(), "xc": xr[0::2] + 1j * xr[1::2]}


def check_smw(rows, nodes):
    """The sharded SPIKE + SMW solve of ``test_mixed_sharded.py``'s
    waveguide (TAUSCH, nx 17, nz 11) at sigma = -1.3 - 0.31i."""
    import neptpu_torch
    from neptpu_torch.ops.partitioned import complex_lowrank_to_interleaved
    from neptpu_torch.parallel import (SpikeBandedSolver, shard_vector,
                                       unshard_vector)
    from neptpu_torch.parallel.mixed_sharded import (_assemble_sigma,
                                                     _smw_solve_local)
    from neptpu_torch.solvers.iar_sharded import pad_sigma_strips
    from neptpu_torch.solvers.spmf_real import collect_spmf_terms
    from neptpu_torch.parallel.spike import interleave_complex_banded

    nep = neptpu_torch.nep_gallery("waveguide", nx=17, nz=11,
                                   benchmark_problem="TAUSCH",
                                   neptype="SPMF", device=CPU)
    mats, fv = collect_spmf_terms(nep)
    n = mats[0].shape[0]
    ndev = rows.size("rows")
    blk = -(-n // ndev)
    cstrips, coffs, Lc, Uc = _assemble_sigma(mats, fv, SMW_SIGMA)
    rstrips, roffs = interleave_complex_banded(
        pad_sigma_strips(cstrips, coffs, ndev * blk), coffs)
    spike = SpikeBandedSolver(rstrips, roffs, rows, dtype=np.float64)
    Ltil, Util = complex_lowrank_to_interleaved(Lc, Uc)
    X_d = spike.solve_sharded(shard_vector(Ltil, rows, 2 * blk))
    Util_d = shard_vector(Util, rows, 2 * blk)
    K = torch.eye(Util.shape[1], dtype=torch.float64) + rows.psum(
        Util_d.T @ X_d, "rows")
    f = smw_rhs(n)
    fr = np.zeros(2 * n)
    fr[0::2], fr[1::2] = f.real, f.imag
    x_d = _smw_solve_local(spike, X_d, Util_d, torch.linalg.inv(K),
                           shard_vector(fr, rows, 2 * blk), rows, "rows")
    x = unshard_vector(x_d, 2 * n, rows).numpy()
    return {"x": x[0::2] + 1j * x[1::2], "b": spike.b,
            "reduced": spike.reduced_size}


def check_moments(rows, nodes):
    import neptpu_torch
    from neptpu_torch.parallel import sharded_contour_moments

    nep = neptpu_torch.nep_gallery("dep0", device=CPU)
    A = sharded_contour_moments(nep, MOMENTS["sigma"], MOMENTS["radius"],
                                moments_inputs(), MOMENTS["N"],
                                MOMENTS["n_moments"], nodes)
    return {"A": A.numpy()}


def check_beyn(rows, nodes):
    import neptpu_torch

    nep = neptpu_torch.nep_gallery("dep0", device=CPU)
    lam_p, _ = neptpu_torch.contour_beyn(nep, mesh=nodes, device=CPU, **BEYN)
    lam_s, _ = neptpu_torch.contour_beyn(nep, device=CPU, **BEYN)
    return {"lam": np.asarray(lam_p), "lam_serial": np.asarray(lam_s)}


def check_iar_dep(rows, nodes):
    import neptpu_torch
    from neptpu_torch.solvers.iar_sharded import iar_real_sharded

    cfg = dict(IAR_DEP)
    nep = neptpu_torch.nep_gallery("dep0_tridiag", cfg.pop("n"), device=CPU)
    lam, Q, info = iar_real_sharded(nep, rows, dtype=torch.float64,
                                    return_info=True, **cfg)
    lam_s, _ = neptpu_torch.iar_real(nep, dtype=torch.float64, device=CPU,
                                     **cfg)
    return {"lam": lam, "Q": Q, "lam_serial": np.asarray(lam_s),
            "nconv": info["nconv"], "bulk": info["bulk"],
            "hessenberg": info["hessenberg"], "graph": info["graph"]}


def check_iar_gun(rows, nodes):
    import neptpu_torch
    from neptpu_torch.parallel.mixed_sharded import iar_real_spmf_sharded

    nep = _small_gun()
    lam, Q, info = iar_real_spmf_sharded(nep, rows, dtype=torch.float64,
                                         return_info=True, **IAR_GUN)
    res = [float(neptpu_torch.compute_resnorm(
        nep, lam[s], torch.as_tensor(Q[:, s]))) for s in range(len(lam))]
    return {"lam": lam, "nconv": info["nconv"], "res": res,
            "bulk": info["bulk"], "hessenberg": info["hessenberg"],
            "graph": info["graph"], "steps": info["steps"]}


def _small_gun():
    """``small_gun_ops``' PEP plus the two square-root terms, on the CPU."""
    import neptpu_torch
    from neptpu_torch.models.gallery.nlevp import _i_sqrt_shifted

    K, mM, W1, W2 = small_gun_ops()
    return neptpu_torch.SumNEP(
        neptpu_torch.PEP([K, mM], device=CPU),
        neptpu_torch.SPMF_NEP([W1, W2], [_i_sqrt_shifted(0.0),
                                         _i_sqrt_shifted(9.0)], device=CPU))


STEPS = 3  # steps of the step checks


def _guarded_steps(m, inputs, mesh):
    """:data:`STEPS` sharded steps from the scan's start carry, each under
    the modes that fail on any host read of a tensor or upload of host data;
    the Hessenberg columns they wrote."""
    from neptpu_torch.solvers.iar_real import _hessenberg
    from neptpu_torch.solvers.iar_sharded import (sharded_carry,
                                                  sharded_step_fn)

    carry = sharded_carry(m, *inputs[7:], mesh, "rows")
    step = sharded_step_fn(m, *inputs[:7], mesh, "rows")
    k = torch.ones((), dtype=torch.int64)
    for _ in range(STEPS):
        with NoHostFunctions(), NoScalarReads():
            step(carry, k)
            k.add_(1)
    return {"H": _hessenberg(carry)[:, :STEPS], "k": int(k)}


def check_step_dep(rows, nodes):
    """The delay problem's sharded step (``check_iar_dep``'s inputs), run
    step by step under the host-read guards."""
    import neptpu_torch
    from neptpu_torch.solvers.iar_sharded import dep_scan_inputs

    nep = neptpu_torch.nep_gallery("dep0_tridiag", IAR_DEP["n"], device=CPU)
    m = IAR_DEP["maxit"]
    inputs, _ = dep_scan_inputs(nep, rows, IAR_DEP["sigma"], 1.0, m, None,
                                torch.float64, "rows")
    return _guarded_steps(m, inputs, rows)


def check_step_gun(rows, nodes):
    """The small gun's sharded mixed step (``check_iar_gun``'s inputs), run
    step by step under the host-read guards."""
    from neptpu_torch.parallel.mixed_sharded import mixed_scan_inputs
    from neptpu_torch.solvers.spmf_real import collect_spmf_terms

    mats, fv = collect_spmf_terms(_small_gun())
    inputs, setup = mixed_scan_inputs(mats, fv, rows, IAR_GUN["sigma"], 1.0,
                                      IAR_GUN["maxit"], None, torch.float64,
                                      "rows")
    return _guarded_steps(setup["steps"], inputs, rows)


CHECKS = {f.__name__[len("check_"):]: f for f in (
    check_collectives, check_dia, check_csr, check_gram, check_spike,
    check_smw, check_moments, check_beyn, check_iar_dep, check_iar_gun,
    check_step_dep, check_step_gun)}


# -- the world -------------------------------------------------------------
def _rank_main(rank, world, init_file, out_dir, names):
    import torch.distributed as dist

    from neptpu_torch.parallel import make_mesh

    torch.set_num_threads(1)  # the oneMKL float32 inv hang with more
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        rows = make_mesh(rows=world, nodes=1, device=CPU)
        nodes = make_mesh(rows=1, nodes=world, device=CPU)
        out = {"backend": rows.backend, "shape": (rows.shape, nodes.shape)}
        for name in names:
            t0 = time.perf_counter()
            out[name] = CHECKS[name](rows, nodes)
            out[name]["seconds"] = time.perf_counter() - t0
        out["loaded"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib",
                                                      "neptpu"))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def spawn_world(tmp_dir, names, world=WORLD):
    """Run the checks ``names`` on a world of ``world`` gloo ranks on the
    CPU; returns every rank's results, in rank order.  A failing rank fails
    the spawn."""
    import torch.multiprocessing as mp

    tmp_dir = str(tmp_dir)
    mp.spawn(_rank_main, args=(world, os.path.join(tmp_dir, "rendezvous"),
                               tmp_dir, list(names)),
             nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def multihost_main():
    """One process of the torchrun-wired world: ``sharded_dia_lincomb`` on
    ``dep0_tridiag`` (n = 512) through ``make_mesh(multihost=True)``,
    against the serial bank apply."""
    import torch.distributed as dist

    import neptpu_torch
    from neptpu_torch.parallel import (ShardedDiaBank, make_mesh,
                                       shard_vector, sharded_dia_lincomb,
                                       unshard_vector)

    torch.set_num_threads(1)
    mesh = make_mesh(multihost=True, device=CPU)
    world = dist.get_world_size()
    assert world == int(os.environ["WORLD_SIZE"]) == mesh.size("rows")
    n = 512
    bank = neptpu_torch.nep_gallery("dep0_tridiag", n, device=CPU).bank
    W = np.random.default_rng(0).standard_normal((n, bank.nterms))
    sb = ShardedDiaBank(bank, world).device_put(mesh)
    y = unshard_vector(sharded_dia_lincomb(sb, shard_vector(W, mesh, sb.blk),
                                           mesh), n, mesh).numpy()
    ref = bank.lincomb_apply(torch.as_tensor(W)).numpy()
    err = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
    assert err < 1e-12, err
    print(f"[rank {dist.get_rank()}] multihost sharded lincomb OK "
          f"rel err {err:.2e}", flush=True)
    dist.destroy_process_group()


def coordinator_main(address, rank):
    """One process of a two-rank world wired through the JAX package's
    arguments, ``initialize_distributed(coordinator_address=...,
    num_processes=2, process_id=rank)``, and a mesh over
    ``make_mesh(devices=[cpu, cpu])``; prints the mesh and a psum."""
    import torch.distributed as dist

    from neptpu_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    assert initialize_distributed(coordinator_address=address,
                                  num_processes=2, process_id=rank,
                                  device=CPU)
    mesh = make_mesh(devices=[CPU, CPU])
    total = float(mesh.psum(torch.tensor([rank + 1.0]), "rows")[0])
    print(f"[rank {dist.get_rank()}] coordinator mesh world "
          f"{dist.get_world_size()} shape {mesh.shape} rank "
          f"{mesh.rank('rows')} device {mesh.device} backend {mesh.backend} "
          f"psum {total}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:] == ["multihost"]:
    multihost_main()
elif __name__ == "__main__" and sys.argv[1:2] == ["coordinator"]:
    coordinator_main(sys.argv[2], int(sys.argv[3]))
