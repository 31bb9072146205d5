"""Plain float64 reference of the ``wep`` configuration: the waveguide
eigenvalue problem (WEP) of Jarlebring, Mele and Runborg, "The waveguide
eigenvalue problem and the tensor infinite Arnoldi method", SIAM J. Sci.
Comput. 39(3), 2017, in the finite-difference SPMF form of NEP-PACK's
gallery problem ``waveguide`` (``nep_gallery("waveguide", nx, nz, wg,
"SPMF")``), assembled here from that description.

The Helmholtz equation u_xx + u_zz + 2 lam u_z + (lam^2 + K(x, z)) u = 0 on
x in [xm, xp] (the wavenumber's interior plus ``delta`` on each side) and
z in [0, 1], periodic in z, closed at x = xm and x = xp by the
Dirichlet-to-Neumann maps of the two homogeneous half-planes.  The interior
is an nx x nz grid (z step hz = 1/nz, the node z = 0 identified with z = 1;
x step hx over nx + 2 equispaced nodes, the two ends being the boundary).
An interior unknown X[iz, ix] is row ``ix nz + iz`` (column-major order of
the nz x nx grid); the 2 nz boundary unknowns follow, x = xm first.  With
second differences Dxx (Dirichlet) and Dzz (periodic), the periodic centred
difference Dz and the identity,

    M(lam) = [Q0 C1; C2^T 0] + lam [Q1 0; 0 0] + lam^2 [Q2 0; 0 0]
             + sum_{side, j} f_{side, j}(lam) [0 0; 0 E_j E_j^H / nz]

    Q0 = I (x) Dzz + Dxx (x) I + diag(K),  Q1 = I (x) 2 Dz,  Q2 = I,

C1 = [e_1 (x) I, e_nx (x) I] / hx^2 (the boundary values entering the first
and last interior columns) and C2^T the one-sided second-order derivative
rows (2/hx at the boundary's neighbour, -1/(2 hx) at the next).  The
boundary is expanded in the nz Fourier modes k = -p..p, p = (nz - 1)/2:
E_j = R e_j on its side's nz rows, R x = reverse(b .* fft(x)) with
b_l = exp(2 pi i l p / nz), and

    f_j(lam) = i sqrt(lam^2 + b_j lam + c_j) + d0,
    b_j = 4 pi i k,  c_j = K_side^2 - 4 pi^2 k^2,  d0 = -3 / (2 hx),

K_side the wavenumber of the half-plane (x -> -inf or x -> +inf).

The square root is the branch with non-negative imaginary part: the
principal root, negated where its imaginary part is negative.  NEP-PACK
takes the same branch (``sqrt_schur_pos_imag``, and ``sqrt_pos_imag`` for a
scalar); it selects the outgoing solution in each half-plane.  The
principal branch differs wherever Im(lam^2 + b_j lam + c_j) < 0.

The JARLEBRING wavenumber (the paper's Section 6.2 waveguide): on x in
[-1, 1], z in [0, 1], k = 4 sqrt(3) pi and 2 sqrt(3) pi in the two regions
of the left half cut by the lines z = 1 + x/2 and z = -x/2, 4 sqrt(3) pi on
0 < x <= 1/2 and on 1/2 < x <= 1 above z = 0.4, pi below it; sqrt(2.3) pi
for x <= -1 and pi for x > 1 (the half-planes).  The matrix carries k^2.

Departures from the paper, all as NEP-PACK's gallery has them: the domain
is widened by ``delta`` (0.1) on each side; the boundary condition is
expanded in Fourier modes with the FFT's scaling and order above; the
backward error is NEP-PACK's default for an SPMF (``_spmf.py``).  Only the
JARLEBRING wavenumber is built here.  Everything is assembled in float64
and complex128 torch tensors on the CPU, and handed to the measure as SciPy
CSR matrices.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch

from ._spmf import SPMFReference

F64, C128 = torch.float64, torch.complex128


def sqrt_pos_imag(a):
    """Square root of the complex tensor ``a`` on the branch with
    non-negative imaginary part."""
    r = torch.sqrt(torch.as_tensor(a, dtype=C128))
    return torch.where(r.imag < 0, -r, r)


def wavenumber(x, z):
    """The JARLEBRING wavenumber k(x, z) on broadcast float64 tensors."""
    x, z = torch.broadcast_tensors(torch.as_tensor(x, dtype=F64),
                                   torch.as_tensor(z, dtype=F64))
    k1, k2, k3, k4 = (torch.full_like(x, v) for v in (
        math.sqrt(2.3) * math.pi, 2 * math.sqrt(3) * math.pi,
        4 * math.sqrt(3) * math.pi, math.pi))
    left = (x > -1) & (x <= 0)
    k = torch.where(left & (z > 0.5), torch.where(z - x / 2 <= 1, k3, k2),
                    k1)
    k = torch.where(left & (z <= 0.5), torch.where(z + x / 2 > 0, k3, k2), k)
    k = torch.where((x > 0) & (x <= 0.5), k3, k)
    k = torch.where((x > 0.5) & (x <= 1), torch.where(z > 0.4, k3, k4), k)
    return torch.where(x > 1, k4, k)


def nodes(start, stop, num):
    """``num`` equispaced float64 nodes, ``start + i (stop - start) /
    (num - 1)`` and ``stop`` last: NumPy's ``linspace`` arithmetic, so that
    a node on an interface of the wavenumber falls on the side it falls on
    in NEP-PACK's and the port's grids."""
    out = (torch.arange(num, dtype=F64) * ((stop - start) / (num - 1))
           + start)
    out[-1] = stop
    return out


def grid(nx, nz, delta):
    """``(x, z, hx, hz)``: the interior nodes and the steps."""
    xs = nodes(-1.0 - delta, 1.0 + delta, nx + 2)
    zs = nodes(0.0, 1.0, nz + 1)
    return xs[1:-1], zs[1:], float(xs[1] - xs[0]), float(zs[1] - zs[0])


def _csr(rows, cols, vals, shape):
    """A SciPy CSR matrix from coordinate tensors (duplicates summed)."""
    return sp.csr_matrix((vals.numpy(), (rows.numpy(), cols.numpy())),
                         shape=shape)


def polynomial_terms(nx, nz, delta):
    """``[A0, A1, A2]``, the interior and its boundary coupling, n x n."""
    x, z, hx, hz = grid(nx, nz, delta)
    nzz = nx * nz
    n = nzz + 2 * nz
    ix, iz = torch.meshgrid(torch.arange(nx), torch.arange(nz),
                            indexing="ij")
    ix, iz = ix.reshape(-1), iz.reshape(-1)
    row = ix * nz + iz
    up, down = ix * nz + (iz + 1) % nz, ix * nz + (iz - 1) % nz
    K2 = wavenumber(x[ix], z[iz]) ** 2
    one = torch.ones(nzz, dtype=F64)
    rows, cols, vals = [row, row, row], [row, up, down], [
        K2 - 2 / hz**2 - 2 / hx**2 * one, one / hz**2, one / hz**2]
    for step in (-1, 1):                        # Dxx: Dirichlet in x
        inner = (ix + step >= 0) & (ix + step < nx)
        rows.append(row[inner])
        cols.append(row[inner] + step * nz)
        vals.append(one[inner] / hx**2)
    j = torch.arange(nz)
    first, last = j, (nx - 1) * nz + j          # interior rows at the ends
    bm, bp = nzz + j, nzz + nz + j              # boundary unknowns
    ends = torch.ones(nz, dtype=F64)
    rows += [first, last, bm, bm, bp, bp]       # C1, then C2^T
    cols += [bm, bp, first, first + nz, last, last - nz]
    vals += [ends / hx**2, ends / hx**2, 2 / hx * ends, -0.5 / hx * ends,
             2 / hx * ends, -0.5 / hx * ends]
    A0 = _csr(torch.cat(rows), torch.cat(cols), torch.cat(vals), (n, n))
    A1 = _csr(torch.cat([row, row]), torch.cat([up, down]),
              torch.cat([one, -one]) / hz, (n, n))       # I (x) 2 Dz
    A2 = _csr(row, row, one, (n, n))
    return [A0, A1, A2]


def boundary_vectors(nz):
    """``(nz, nz)`` complex128: column j is R e_j."""
    p = (nz - 1) // 2
    b = torch.exp(2j * math.pi * torch.arange(nz, dtype=F64) * p / nz)
    return torch.flip(b[:, None] * torch.fft.fft(
        torch.eye(nz, dtype=C128), dim=0), dims=(0,))


def boundary_terms(nx, nz):
    """The 2 nz rank-one terms, x = xm's side first."""
    nzz = nx * nz
    n = nzz + 2 * nz
    R = boundary_vectors(nz)
    r, c = torch.meshgrid(torch.arange(nz), torch.arange(nz), indexing="ij")
    r, c = r.reshape(-1), c.reshape(-1)
    out = []
    for base in (nzz, nzz + nz):
        for j in range(nz):
            E = R[:, j]
            block = (E[:, None] * E.conj()[None, :] / nz).reshape(-1)
            out.append(_csr(base + r, base + c, block, (n, n)))
    return out


def coefficients(nx, nz, delta):
    """``(b, c, d0)``: b (2 nz,), c (2 nz,) complex128 in the order of
    :func:`boundary_terms`, and d0."""
    _, _, hx, _ = grid(nx, nz, delta)
    p = (nz - 1) // 2
    k = torch.arange(-p, p + 1, dtype=F64)
    k_side = [float(wavenumber(-math.inf, 0.5)),
              float(wavenumber(math.inf, 0.5))]
    b = (4j * math.pi * k).to(C128)
    c = torch.cat([(ks**2 - 4 * math.pi**2 * k**2).to(C128)
                   for ks in k_side])
    return torch.cat([b, b]), c, -3.0 / (2.0 * hx)


def weights(lams, b, c, d0):
    """(213, k) complex128 f_i(lams[j]) as NumPy: 1, lam, lam^2, then
    i sqrt(lam^2 + b lam + c) + d0 on the non-negative imaginary branch."""
    lam = torch.as_tensor(np.asarray(lams, dtype=complex))
    s = sqrt_pos_imag(lam[None, :] ** 2 + b[:, None] * lam[None, :]
                      + c[:, None])
    return torch.cat([torch.ones_like(lam)[None], lam[None], lam[None] ** 2,
                      1j * s + d0]).numpy()


def matrices(cfg):
    """The 3 + 2 nz term matrices of the configuration, SciPy CSR."""
    nx, nz, delta = int(cfg["nx"]), int(cfg["nz"]), float(cfg["delta"])
    if cfg["waveguide"] != "JARLEBRING":
        raise ValueError(f"only the JARLEBRING waveguide is built here, "
                         f"not {cfg['waveguide']!r}")
    mats = polynomial_terms(nx, nz, delta) + boundary_terms(nx, nz)
    if mats[0].shape[0] != cfg["n"]:
        raise ValueError(f"{mats[0].shape[0]} unknowns; the configuration "
                         f"says {cfg['n']}")
    return mats


def build(cfg, root=None):
    b, c, d0 = coefficients(int(cfg["nx"]), int(cfg["nz"]),
                            float(cfg["delta"]))
    return SPMFReference(matrices(cfg), lambda lams: weights(lams, b, c, d0))
