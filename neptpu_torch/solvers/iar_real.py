"""Complex-as-real infinite Arnoldi (IAR) scan.

The iteration is carried in split re/im channels, as the JAX package does it,
so the port can be held against it step by step:

* the Mlincomb of a step is a small complex coefficient table applied as four
  real GEMMs + one split bank apply (on the card ONE launch of the DIA SpMV
  pair kernel for the re and im channels of the main bank);
* the shifted solve is a ``solve_pair(zre, zim)`` object factored once
  (:class:`neptpu_torch.ops.partitioned.InterleavedSMW`, or the dense
  :class:`DenseBlockLU` fallback);
* DGKS orthogonalization against the stacked basis is paired real GEMMs.

A step has the JAX package's static-shape form (its ``_step_fn``): the step
index ``k`` is a 0-dim int64 tensor on the device, the block shift is a mask
``jblk < k`` and a roll over the full ``(m+1, n)`` block, and the step reads
``V[k-1]`` and writes ``V[k]`` and Hessenberg column ``k-1`` by index ops
with that tensor, IN PLACE into the preallocated ``(m+1, m+1, n)`` basis pair
and ``(m+1, m)`` Hessenberg pair (the JAX ``.at[].set`` updates).  Where the
JAX package compiles the steps into one ``lax.scan``, the port captures one
step as a CUDA graph per scan call and replays it once a step
(:mod:`neptpu_torch.solvers.scan_graph`); on the CPU the same step runs in an
eager loop.  Ritz extraction runs on the host every ``check_error_every``
steps.

Front ends: :func:`iar_real` for a delay eigenproblem (``DEP``: the table
``C[i, j] = gamma^j (-tau_i)^j e^{-tau_i sigma}``, the dense real 2n x 2n
block LU of M(sigma), the ``-lam I`` term carried as the scan's identity
term), and ``neptpu_torch.solvers.spmf_real.iar_real_spmf`` for SPMFs.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import finfo_max, to_torch_dtype
from ..core import trace
from ..core.nep import compute_resnorm
from .common import solver_device
from .scan_graph import StepGraph

__all__ = ["iar_real", "iar_real_scan", "run_iar_real", "dep_shift_block_lu",
           "dep_coeff_table", "block_assemble_lu", "DenseBlockLU",
           "as_pair_solver", "auto_theta", "apply_theta", "DeflationOps"]


def _dep_host_resnorm(nep):
    """Host-side (numpy/scipy) DEP residual ``||M(lam) q||`` in complex128
    against scipy mirrors of the bank terms."""
    tau = np.asarray(nep.tauv, dtype=float)
    terms = [A.astype(np.float64) for A in nep.bank.host_csr_terms()]

    def resnorm(lam, q):
        y = -lam * q
        for t, A in zip(tau, terms):
            y = y + np.exp(-t * lam) * (A @ q)
        return float(np.linalg.norm(y))

    return resnorm


def dep_coeff_table(nep, sigma, gamma, m, scaled=False):
    """C[i, j] = gamma^j (-tau_i)^j e^{-tau_i sigma} (j = 0..m, column 0
    zeroed: the IAR linear combination starts at the first derivative).
    ``scaled`` divides column j by j! (the Taylor-normalized table), built by
    a progressive row recurrence so no intermediate over/underflows.
    Returns (Cre, Cim) numpy float64."""
    tau = np.asarray(nep.tauv, dtype=float)
    C = np.zeros((len(tau), m + 1), dtype=complex)
    C[:, 0] = np.exp(-tau * complex(sigma))
    r = -complex(gamma) * tau  # per-row column ratio
    for j in range(1, m + 1):
        C[:, j] = C[:, j - 1] * (r / j if scaled else r)
    C[:, 0] = 0.0
    return np.ascontiguousarray(C.real), np.ascontiguousarray(C.imag)


def block_assemble_lu(M0, dtype, device):
    """LU of the real 2n x 2n block form ``[[Re M, -Im M], [Im M, Re M]]`` of
    a complex scipy sparse matrix ``M0``: the blocks are scattered and
    factored (``torch.linalg.lu_factor``) on ``device``.  Applied to
    ``[re; im]`` the block matrix gives the re/im parts of ``M (re + i im)``.
    Returns ``(lu, piv)``."""
    M0 = M0.tocoo()
    n = M0.shape[0]
    dt = to_torch_dtype(dtype)
    rows = torch.as_tensor(M0.row.astype(np.int64), device=device)
    cols = torch.as_tensor(M0.col.astype(np.int64), device=device)
    re = torch.as_tensor(M0.data.real, dtype=dt, device=device)
    im = torch.as_tensor(M0.data.imag, dtype=dt, device=device)
    blk = torch.zeros((2 * n, 2 * n), dtype=dt, device=device)
    blk.index_put_((rows, cols), re, accumulate=True)
    blk.index_put_((rows, cols + n), -im, accumulate=True)
    blk.index_put_((rows + n, cols), im, accumulate=True)
    blk.index_put_((rows + n, cols + n), re, accumulate=True)
    return torch.linalg.lu_factor(blk)


def dep_shift_block_lu(nep, sigma, dtype=torch.float32, device=None):
    """Real 2n x 2n block LU of a DEP's M(sigma): assembled on the host in
    complex128 from the bank's scipy mirrors, factored on ``device``
    (default: the card)."""
    import scipy.sparse as sp

    device = solver_device(nep, device)
    sigma = complex(sigma)
    n = nep.n
    with trace.span("nt.factorize.assemble"):
        M0 = sp.coo_matrix(
            (np.full(n, -sigma), (np.arange(n), np.arange(n))),
            shape=(n, n)).tocsr()
        for t, A in zip(np.asarray(nep.tauv, dtype=float),
                        nep.bank.host_csr_terms()):
            M0 = M0 + np.exp(-t * sigma) * A
    return block_assemble_lu(M0, dtype, device)


class DenseBlockLU:
    """Dense real 2n x 2n block LU of ``[[Re M, -Im M], [Im M, Re M]]``
    exposing the ``solve_pair`` contract of the scan."""

    def __init__(self, lu, piv):
        self.lu, self.piv = lu, piv

    @property
    def n(self):
        return self.lu.shape[0] // 2

    def astype(self, dt):
        return DenseBlockLU(self.lu.to(to_torch_dtype(dt)), self.piv)

    def solve_pair(self, zre, zim):
        n = zre.shape[0]
        rhs = torch.cat([zre, zim])
        sol = torch.linalg.lu_solve(self.lu, self.piv,
                                    rhs[:, None] if rhs.ndim == 1 else rhs)
        sol = sol[:, 0] if rhs.ndim == 1 else sol
        return sol[:n], sol[n:]


def as_pair_solver(lu_piv):
    """(lu, piv) tuple -> DenseBlockLU; solver objects pass through."""
    if hasattr(lu_piv, "solve_pair"):
        return lu_piv
    return DenseBlockLU(*lu_piv)


class DeflationOps:
    """Scan operands of an Effenberger invariant pair (X, S) for the
    theta-scaled complex-as-real IAR.

    The extended problem ``Mtil(lam)[v; w] = [M v + M X (lam I - S)^{-1} w;
    X^H v]`` enters the scan through three precomputed pieces, each built in
    complex128 on the host and held as re/im parts on the scan's device in
    its dtype:

    * ``T``: the block-Toeplitz ``((m+1)p, (m+1)p)`` map from the stacked
      w-blocks to ``t_l = sum_k (-gamma theta)^k R^{k+1} w_{l+k}``,
      ``R = (sigma I - S)^{-1}`` - so the step's bank contraction is the
      ordinary one (length n, the bank's own shape) on
      ``v'_l = v_l + X t_l``;
    * ``X``: the invariant-pair basis ``(n, p)``, orthonormal;
    * ``P0 = (X^H X)^{-1} X^H`` and ``G0 = (sigma I - S) P0``: the bordered
      solve is ``g = M(sigma)^{-1} z``, ``v0 = g - X (P0 g)``,
      ``w0 = G0 g`` - the one shifted factorization serves every sweep.
    """

    def __init__(self, Tre, Tim, Xre, Xim, Pre, Pim, Gre, Gim, p):
        self.Tre, self.Tim = Tre, Tim
        self.Xre, self.Xim = Xre, Xim
        self.Pre, self.Pim = Pre, Pim
        self.Gre, self.Gim = Gre, Gim
        self.p = int(p)

    @classmethod
    def build(cls, X, S, sigma, gamma_theta, m, dt, device=None):
        """Assembly in complex128 on the host from the complex invariant
        pair ``(X (n, p), S (p, p))``; the parts go to ``device`` (default:
        the card) in ``dt``."""
        from ..config import resolve_device

        device = resolve_device(device)
        X = np.asarray(X, dtype=complex)
        S = np.asarray(S, dtype=complex)
        p = X.shape[1]
        A = complex(sigma) * np.eye(p) - S
        R = np.linalg.inv(A)
        # block diagonal k carries P[k] = (-gamma theta)^k R^{k+1}
        T = np.zeros(((m + 1) * p, (m + 1) * p), dtype=complex)
        Pk = R.copy()
        for k in range(m + 1):
            for l in range(m + 1 - k):
                T[l * p:(l + 1) * p, (l + k) * p:(l + k + 1) * p] = Pk
            Pk = (-complex(gamma_theta)) * (R @ Pk)
        P0 = np.linalg.solve(X.conj().T @ X, X.conj().T)
        G0 = A @ P0
        dt = to_torch_dtype(dt)

        def parts(a):
            return (torch.as_tensor(a.real, dtype=dt, device=device),
                    torch.as_tensor(a.imag, dtype=dt, device=device))

        return cls(*parts(T), *parts(X), *parts(P0), *parts(G0), p)

    def max_abs_T(self):
        """``max |T|`` over the re/im parts (a deflated eigenvalue near sigma
        makes ``R`` large)."""
        return float(torch.maximum(self.Tre.abs().max(), self.Tim.abs().max()))

    def extend(self, ytre, ytim):
        """``(v'_re, v'_im)`` of a work block ``(m+1, n+p)``: its p tail
        columns (the w-blocks, a slice) through ``T``, folded into the n
        head columns by ``X``."""
        p = self.p
        wre = ytre[:, -p:].reshape(-1)  # (m+1) p values
        wim = ytim[:, -p:].reshape(-1)
        tre = (self.Tre @ wre - self.Tim @ wim).reshape(-1, p)
        tim = (self.Tre @ wim + self.Tim @ wre).reshape(-1, p)
        vpre = ytre[:, :-p] + tre @ self.Xre.T - tim @ self.Xim.T
        vpim = ytim[:, :-p] + tre @ self.Xim.T + tim @ self.Xre.T
        return vpre, vpim

    def border(self, xre, xim):
        """The bordered solve's tail: ``[g - X (P0 g); (sigma I - S) P0 g]``
        for the shifted solve's ``g (n,)``; returns length-(n+p) parts."""
        pgre = self.Pre @ xre - self.Pim @ xim
        pgim = self.Pre @ xim + self.Pim @ xre
        w0re = self.Gre @ xre - self.Gim @ xim
        w0im = self.Gre @ xim + self.Gim @ xre
        return (torch.cat([xre - (self.Xre @ pgre - self.Xim @ pgim), w0re]),
                torch.cat([xim - (self.Xre @ pgim + self.Xim @ pgre), w0im]))


def _step_fn(bank, m, Cre, Cim, gre, gim, solver, dt, scaled=False,
             inv_theta=1.0, defl=None):
    """One complex-as-real IAR step as ``step(carry, k)`` (the JAX
    package's ``_step_fn``): ``k`` is the 1-based step index, a 0-dim int64
    tensor on the carry's device; the step updates the carry ``(Vre, Vim,
    Hre, Him)`` in place and returns beta.  Every shape is static and the
    step reads ``k`` only on the device, so one captured CUDA graph serves
    every ``k``.

    ``scaled``: run in the Taylor-normalized space ``u_j = (j!/theta^j) y_j``
    — the block shift carries a constant ``1/theta`` factor instead of
    ``1/(j+1)`` and the coefficient table must be the scaled table.
    ``defl``: a :class:`DeflationOps`; the basis then has length n + p while
    the bank and the shifted solve stay at length n."""
    dev = Cre.device
    jblk = torch.arange(m + 1, device=dev)
    if scaled:
        sj = torch.full((m + 1,), inv_theta, dtype=dt, device=dev)
    else:
        sj = (1.0 / (jblk.to(torch.float64) + 1.0)).to(dt)
    zero = torch.zeros((), dtype=dt, device=dev)

    def step(carry, k):
        Vre, Vim, Hre, Him = carry
        km1 = (k - 1).view(1)
        # block shift of the last basis vector: row j+1 of y = s_j V[k-1][j]
        # for j < k, the mask and roll of the JAX step (row 0 filled below)
        scale = torch.where(jblk < k, sj, zero)[:, None]
        ytre = torch.roll(Vre.index_select(0, km1)[0] * scale, 1, 0)
        ytim = torch.roll(Vim.index_select(0, km1)[0] * scale, 1, 0)

        if defl is not None:
            # Effenberger extension: the invariant-pair coupling folds into
            # the same bank contraction via v'_l = v_l + X t_l
            vpre, vpim = defl.extend(ytre, ytim)
        else:
            vpre, vpim = ytre, ytim
        # term weights: W = Y @ C^T, complex split into four small GEMMs
        WreT = Cre @ vpre - Cim @ vpim  # (terms, n)
        WimT = Cre @ vpim + Cim @ vpre
        if hasattr(bank, "lincomb_apply_split_t"):
            zre, zim = bank.lincomb_apply_split_t(WreT, WimT)  # as held
        else:
            zre = bank.lincomb_apply(WreT.T)
            zim = bank.lincomb_apply(WimT.T)
        zre, zim = zre.to(dt), zim.to(dt)
        # identity term: -gamma * y_1 (on the extended v'_1)
        zre = zre - gre * vpre[1] + gim * vpim[1]
        zim = zim - gre * vpim[1] - gim * vpre[1]

        xre, xim = solver.solve_pair(zre, zim)
        if defl is not None:
            xre, xim = defl.border(xre, xim)
        ytre[0] = -xre
        ytim[0] = -xim

        # DGKS (two-pass classical Gram-Schmidt) in paired-real arithmetic
        wre, wim = ytre.reshape(-1), ytim.reshape(-1)
        VreM = Vre.reshape(m + 1, -1)
        VimM = Vim.reshape(m + 1, -1)

        def cgs(wre, wim):
            hre = VreM @ wre + VimM @ wim  # Re(conj(V) @ w)
            him = VreM @ wim - VimM @ wre  # Im(conj(V) @ w)
            wre = wre - (VreM.T @ hre - VimM.T @ him)
            wim = wim - (VreM.T @ him + VimM.T @ hre)
            return wre, wim, hre, him

        wre, wim, h1re, h1im = cgs(wre, wim)
        wre, wim, h2re, h2im = cgs(wre, wim)
        hre, him = h1re + h2re, h1im + h2im
        beta = torch.sqrt(torch.sum(wre**2) + torch.sum(wim**2))
        kk = k.view(1)
        Vre.index_copy_(0, kk, (wre / beta).reshape(1, m + 1, -1))
        Vim.index_copy_(0, kk, (wim / beta).reshape(1, m + 1, -1))
        top = jblk == k
        Hre.index_copy_(1, km1, torch.where(top, beta, hre)[:, None])
        Him.index_copy_(1, km1, torch.where(top, zero, him)[:, None])
        return beta

    return step


def _init_carry(m, v0re, v0im, dt):
    """Zero basis pair (m+1, m+1, n) with the unit start vector in slot
    (0, 0), and a zero Hessenberg pair (m+1, m)."""
    n, dev = v0re.shape[0], v0re.device
    nrm0 = torch.sqrt(torch.sum(v0re**2) + torch.sum(v0im**2))
    Vre = torch.zeros((m + 1, m + 1, n), dtype=dt, device=dev)
    Vim = torch.zeros_like(Vre)
    Vre[0, 0] = v0re / nrm0
    Vim[0, 0] = v0im / nrm0
    Hre = torch.zeros((m + 1, m), dtype=dt, device=dev)
    return (Vre, Vim, Hre, torch.zeros_like(Hre))


def _scan_chunk(bank, m, nsteps, k0, carry, Cre, Cim, gre, gim, solver,
                scaled=False, inv_theta=1.0, defl=None):
    """Advance ``nsteps`` IAR steps starting at (1-based) step ``k0``; the
    carry is updated in place and returned.  On the card the steps after
    the first are replays of one captured graph."""
    dt = carry[0].dtype
    step = _step_fn(bank, m, Cre, Cim, gre, gim, solver, dt, scaled=scaled,
                    inv_theta=inv_theta, defl=defl)
    k = torch.full((), int(k0), dtype=torch.int64, device=carry[0].device)
    with StepGraph(step, carry, k) as run:
        run.advance(nsteps)
    return carry


def iar_real_scan(bank, m, Cre, Cim, gre, gim, v0re, v0im, lu, piv=None,
                  scaled=False, inv_theta=1.0):
    """Run m complex-as-real IAR steps from the start vector pair
    ``(v0re, v0im)`` (tensors on the bank's device).

    ``lu``: a ``solve_pair`` solver, or with ``piv`` the dense block LU.
    Returns ``(Vre, Vim, Hre, Him)``: the padded basis pair
    ``(m+1, m+1, n)`` and the ``(m+1, m)`` Hessenberg pair."""
    dt = torch.promote_types(v0re.dtype, torch.as_tensor(Cre).dtype)
    solver = lu if piv is None else DenseBlockLU(lu, piv)
    carry = _init_carry(m, v0re.to(dt), v0im.to(dt), dt)
    dev = v0re.device
    return _scan_chunk(bank, m, m, 1, carry,
                       torch.as_tensor(Cre, dtype=dt, device=dev),
                       torch.as_tensor(Cim, dtype=dt, device=dev),
                       float(gre), float(gim), solver, scaled=scaled,
                       inv_theta=float(inv_theta))


def _hessenberg(carry):
    """The carry's Hessenberg pair as one complex128 host array."""
    Hre, Him = carry[-2:]
    return (Hre.cpu().numpy().astype(np.float64)
            + 1j * Him.cpu().numpy().astype(np.float64))


def _extract_ritz(carry, k_done, m, n, sigma, gamma):
    """Host Ritz extraction from the first ``k_done`` Krylov steps:
    lam = sigma + gamma / theta, Q = V0[:, :k] @ Z (unit columns), and the
    Arnoldi residual estimates ``|H[k, k-1]| |Z[k-1, s]|`` (a cheap ranking
    of which Ritz pairs deserve an exact residual check)."""
    Vre, Vim, Hre, Him = carry
    Hre_h = Hre.cpu().numpy().astype(np.float64)
    Him_h = Him.cpu().numpy().astype(np.float64)
    H = Hre_h[:k_done, :k_done] + 1j * Him_h[:k_done, :k_done]
    D, Z = np.linalg.eig(H)
    lams = complex(sigma) + complex(gamma) / D
    beta_k = abs(Hre_h[k_done, k_done - 1] + 1j * Him_h[k_done, k_done - 1])
    ests = beta_k * np.abs(Z[k_done - 1, :])
    V0 = (Vre[:, 0, :].cpu().numpy().astype(np.float64)
          + 1j * Vim[:, 0, :].cpu().numpy().astype(np.float64)).T  # (nv, m+1)
    Q = V0[:n, :k_done] @ Z
    qn = np.linalg.norm(Q, axis=0, keepdims=True)
    Q = Q / qn
    # estimate per unit of recovered eigvector norm: similarity-invariant
    # ranking in the theta-scaled space
    ests = ests / np.maximum(qn[0], np.finfo(float).tiny)
    return lams, Q, ests


def _filtered_errs(lams, Q, ests, resnorm, neigs):
    """Exact residuals for the ``max(4 neigs, 16)`` most promising pairs by
    Arnoldi estimate; the rest are inf (sort last, never converged).  The
    pairs measured are counted under ``nt.scan.check.pairs``: at each peek
    of the scan, or once at the end of a scan run without checks."""
    cap = max(4 * int(neigs), 16)
    errs = np.full(len(lams), np.inf)
    idx = np.argsort(ests)[:cap] if len(lams) > cap else range(len(lams))
    trace.count("nt.scan.check.pairs", len(idx))
    for s in idx:
        errs[s] = resnorm(lams[s], Q[:, s])
    return errs


def auto_theta(Sre, Sim, m, dt):
    """Fit the Taylor-space scale ``theta`` to a per-factorial table
    ``S[i, j] = gamma^j f_i^{(j)}(sigma) / j!``: ``theta = exp(-slope of
    log max_i |S_ij|)`` makes ``S_j theta^j`` O(1) across columns, clamped so
    ``theta^{+-m}`` keeps ~1e6 headroom inside ``dt``'s range."""
    g = np.maximum(np.abs(Sre), np.abs(Sim)).max(axis=0)[1:]
    jj = np.arange(1, len(g) + 1, dtype=float)
    ok = np.isfinite(g) & (g > 0)
    if ok.sum() < 2:
        return 1.0
    slope = np.polyfit(jj[ok], np.log(g[ok]), 1)[0]
    theta = float(np.exp(-slope))
    lim = (finfo_max(dt) / 1e6) ** (1.0 / max(m, 1))
    if lim <= 1.0:
        return 1.0
    return float(np.clip(theta, 1.0 / lim, lim))


def apply_theta(Sre, Sim, theta):
    """Multiply column j of a table by theta^j (progressive product)."""
    Sre = np.array(Sre, dtype=np.float64, copy=True)
    Sim = np.array(Sim, dtype=np.float64, copy=True)
    acc = 1.0
    for j in range(1, Sre.shape[1]):
        acc *= theta
        Sre[:, j] *= acc
        Sim[:, j] *= acc
    return Sre, Sim


def run_iar_real(bank, m, Cre, Cim, id_coeff, v, lu_piv, dt, *, sigma, gamma,
                 neigs, tol, resnorm, n=None, check_error_every=None,
                 scaled=False, theta=1.0, defl=None, device=None,
                 precision=None):
    """Shared complex-as-real IAR loop.

    ``id_coeff``: coefficient of the virtual ``-coeff * y_1`` identity term
    (pure-bank SPMFs pass 0).  ``check_error_every``: if set (and ``tol`` is
    finite) the m-step scan runs in chunks of that many steps; after each the
    Hessenberg pair and first-block basis rows come to the host, Ritz pairs
    are extracted and ``resnorm`` measured, and the run stops once ``neigs``
    pairs are below ``tol``.  ``defl``: a :class:`DeflationOps` extending
    the scan by an invariant pair (``v`` and ``n`` are then of length
    n + p).  ``precision`` is accepted for parity with the
    JAX package and does nothing: TF32 is off (``neptpu_torch.config``), so
    float32 products already run in full float32.  Returns ``(lams, Q,
    info)`` over the converged pairs, residual-sorted; ``info``: ``t_scan``,
    ``t_check``, ``nconv``, ``k_done``, ``errs``, ``graph`` (how the steps
    ran, :meth:`~neptpu_torch.solvers.scan_graph.StepGraph.stats`) and
    ``hessenberg`` (the final Hessenberg pair, complex128 on the host)."""
    del precision  # see docstring
    dt = to_torch_dtype(dt)
    solver = as_pair_solver(lu_piv)
    if hasattr(solver, "astype"):
        solver = solver.astype(dt)
    if n is None:
        n = int(solver.n)
    if device is None:
        device = bank.device
    v = np.asarray(v, dtype=complex)
    id_coeff = complex(id_coeff)
    inv_theta = 1.0 / float(theta)
    Cre_t = torch.as_tensor(np.asarray(Cre), dtype=dt, device=device)
    Cim_t = torch.as_tensor(np.asarray(Cim), dtype=dt, device=device)
    step = _step_fn(bank, m, Cre_t, Cim_t, id_coeff.real, id_coeff.imag,
                    solver, dt, scaled=scaled, inv_theta=inv_theta,
                    defl=defl)

    t_check = 0.0
    with trace.clock("nt.scan") as scan:
        carry = _init_carry(
            m, torch.as_tensor(v.real, dtype=dt, device=device),
            torch.as_tensor(v.imag, dtype=dt, device=device), dt)
        k = torch.ones((), dtype=torch.int64, device=device)
        with StepGraph(step, carry, k) as run:
            if check_error_every and np.isfinite(tol):
                chunk = int(check_error_every)
                k_done = 0
                best = None  # keep the BEST peek: at deep Krylov degree the
                # f32 basis can degrade, and the final extraction must not
                # lose pairs that an earlier peek had already certified
                while k_done < m:
                    steps = min(chunk, m - k_done)
                    run.advance(steps)
                    k_done += steps
                    run.wait()  # the checks' time is the host's alone
                    with trace.clock("nt.scan.check") as check:
                        with trace.span("nt.scan.check.extract"):
                            lams, Q, ests = _extract_ritz(
                                carry, k_done, m, n, sigma, gamma)
                        with trace.span("nt.scan.check.measure"):
                            errs = _filtered_errs(lams, Q, ests, resnorm,
                                                  neigs)
                    t_check += check.seconds
                    ncv = int(np.sum(errs < tol))
                    top = np.sort(errs)[: int(neigs)]
                    score = (ncv, -float(np.sum(np.log10(
                        np.maximum(top, 1e-300)))))
                    if best is None or score > best[0]:
                        best = (score, lams, Q, errs)
                    if ncv >= neigs:
                        break
                _, lams, Q, errs = best
            else:
                run.advance(m)
                k_done = m
                lams, Q, ests = _extract_ritz(carry, k_done, m, n, sigma,
                                              gamma)
                errs = _filtered_errs(lams, Q, ests, resnorm, neigs)
    t_scan = scan.seconds

    idx = np.argsort(errs)
    nconv = int(np.sum(errs < tol)) if np.isfinite(tol) else len(errs)
    take = idx[: min(neigs, nconv)]
    info = {"t_scan": t_scan, "t_check": t_check, "nconv": nconv,
            "k_done": k_done, "errs": errs[idx], "graph": run.stats(),
            "hessenberg": _hessenberg(carry)}
    return lams[take], Q[:, take], info


def iar_real(nep, sigma=0.0, gamma=1.0, maxit=30, neigs=6, tol=None, v=None,
             dtype=torch.float32, lu_piv=None, check_error_every=None,
             errmeasure=None, return_info=False, scaled="auto", device=None):
    """Complex-as-real IAR on a DEP: returns the converged ``(lams, Q)``,
    sorted by residual.

    ``lu_piv``: optionally a prefactored result of
    :func:`dep_shift_block_lu` (the factorization-reuse path).
    ``check_error_every``: stop as soon as ``neigs`` Ritz pairs pass ``tol``,
    checking every that many scan steps (host peek of the small Hessenberg
    and first-block rows); default runs all ``maxit`` steps.
    ``errmeasure``: optional ``(lam, q) -> float`` (``q`` a numpy vector)
    replacing the residual norm in convergence counting; the default is
    ``compute_resnorm`` through the problem's own Mlincomb, on the device.
    ``scaled="auto"`` moves to the theta-scaled Taylor space when the classic
    table would overflow ``dtype`` before ``maxit``.  ``device=None`` is the
    card; the problem must live there."""
    from .spmf_real import finite_table_prefix

    device = solver_device(nep, device)
    n = nep.n
    m = int(maxit)
    dt = to_torch_dtype(dtype)
    if tol is None:
        tol = 1e4 * float(torch.finfo(dt).eps)

    with trace.clock("nt.factorize") as fact:
        if lu_piv is None:
            lu_piv = dep_shift_block_lu(nep, sigma, dtype=dt, device=device)
            # time the factorization, not its enqueue
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    t_fact = fact.seconds

    with trace.span("nt.scan.table"):
        if scaled == "auto":
            Cre, Cim = dep_coeff_table(nep, sigma, gamma, m, scaled=False)
            scaled = finite_table_prefix(Cre, Cim, dt) < m
        else:
            scaled = bool(scaled)
        Cre, Cim = dep_coeff_table(nep, sigma, gamma, m, scaled=scaled)
        theta = 1.0
        if scaled:
            theta = auto_theta(Cre, Cim, m, dt)
            Cre, Cim = apply_theta(Cre, Cim, theta)

        m_fin = finite_table_prefix(Cre, Cim, dt)
        if m_fin < m:
            warnings.warn(
                f"DEP coefficient table overflows {dt} past derivative order "
                f"{m_fin}; truncating maxit {m} -> {m_fin}")
            m = m_fin
            Cre, Cim = Cre[:, : m + 1], Cim[:, : m + 1]
    if v is None:
        v = np.ones(n)

    if errmeasure is not None:
        rn = errmeasure
    else:
        def rn(lam, q):
            return float(compute_resnorm(
                nep, complex(lam), torch.as_tensor(q, device=device)))

    lams, Q, info = run_iar_real(
        nep.bank, m, Cre, Cim, gamma * theta, v, lu_piv, dt,
        sigma=sigma, gamma=gamma, neigs=neigs, tol=tol, resnorm=rn, n=n,
        check_error_every=check_error_every, scaled=scaled, theta=theta,
        device=device)
    info["t_factorize"] = t_fact
    info["scaled"] = scaled
    info["theta"] = theta
    if return_info:
        return lams, Q, info
    return lams, Q
