"""Boundary-element Helmholtz problem on the Fichera corner (Steinlechner
2010, Effenberger & Kressner 2012): a cube-with-corner surface mesh,
Gauss-quadrature assembly of the de Hoop fundamental solution.
``compute_Mder`` assembles a dense matrix per lambda on the problem's
device, vectorized over all triangle pairs; the singular-kernel integrals do
not depend on lambda and are assembled once.
"""
from __future__ import annotations

import numpy as np
import torch

from ...config import resolve_device
from ...core.nep import NEP, mlincomb_from_mder

__all__ = ["BEM_NEP", "bem_fichera", "gen_ficheramesh", "precompute_quad",
           "assemble_BEM"]


def gen_ficheramesh(N=3):
    """Fichera-corner surface mesh (host numpy): a dict of stacked triangle
    data — vertices ``P1``/``P2``/``P3``, the shared ``area``, edge tangents
    ``tau*``, ``normal``, in-plane edge normals ``nu*`` and ``midpoint``."""
    if N % 2 != 0:
        N = N + 1
    nn = N // 2
    area = 0.25 / N / N
    grid = np.arange(N + 1) / N
    fixdim = [0, 1, 2, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2]
    fixdim_val = [0, 0, 0, 1, 1, 1, 0.5, 1, 1, 1, 0.5, 1, 1, 1, 0.5]
    freedims = [(1, 2), (2, 0), (0, 1), (1, 2), (1, 2), (1, 2), (1, 2),
                (2, 0), (2, 0), (2, 0), (2, 0), (0, 1), (0, 1), (0, 1), (0, 1)]
    Nvals = [
        (1, N, 1, N), (1, N, 1, N), (1, N, 1, N),
        (1, nn, 1, nn), (nn + 1, N, 1, nn), (1, nn, nn + 1, N), (nn + 1, N, nn + 1, N),
        (1, nn, 1, nn), (nn + 1, N, 1, nn), (1, nn, nn + 1, N), (nn + 1, N, nn + 1, N),
        (1, nn, 1, nn), (nn + 1, N, 1, nn), (1, nn, nn + 1, N), (nn + 1, N, nn + 1, N),
    ]
    P1s, P2s, P3s = [], [], []

    def addtri(center, l, fd, fv, free, ii, jj, a, b, c, d):
        P2 = center.copy()
        P1 = np.zeros(3)
        P1[fd] = fv
        P3 = P1.copy()
        P1[free[0]] = grid[ii + a - 1]
        P1[free[1]] = grid[jj + b - 1]
        P3[free[0]] = grid[ii + c - 1]
        P3[free[1]] = grid[jj + d - 1]
        P1s.append(P1)
        P2s.append(P2)
        P3s.append(P3)

    for l in range(15):
        i0, i1, j0, j1 = Nvals[l]
        for ii in range(i0, i1 + 1):
            for jj in range(j0, j1 + 1):
                center = np.zeros(3)
                center[fixdim[l]] = fixdim_val[l]
                free = freedims[l]
                center[free[0]] = (grid[ii - 1] + grid[ii]) / 2
                center[free[1]] = (grid[jj - 1] + grid[jj]) / 2
                if l < 3:
                    for (a, b, c, d) in [(0, 0, 1, 0), (1, 0, 1, 1), (1, 1, 0, 1), (0, 1, 0, 0)]:
                        addtri(center, l, fixdim[l], fixdim_val[l], free, ii, jj, a, b, c, d)
                else:
                    for (a, b, c, d) in [(0, 0, 0, 1), (0, 1, 1, 1), (1, 1, 1, 0), (1, 0, 0, 0)]:
                        addtri(center, l, fixdim[l], fixdim_val[l], free, ii, jj, a, b, c, d)

    P1 = np.array(P1s)
    P2 = np.array(P2s)
    P3 = np.array(P3s)

    def normalize(v):
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    tau1 = normalize(P2 - P1)
    tau2 = normalize(P3 - P2)
    tau3 = normalize(P1 - P3)
    normal = normalize(np.cross(tau1, tau2))
    nu1 = normalize(np.cross(tau1, normal))
    nu2 = normalize(np.cross(tau2, normal))
    nu3 = normalize(np.cross(tau3, normal))
    return dict(P1=P1, P2=P2, P3=P3, area=area, tau1=tau1, tau2=tau2, tau3=tau3,
                normal=normal, nu1=nu1, nu2=nu2, nu3=nu3,
                midpoint=(P1 + P2 + P3) / 3)


def precompute_quad(mesh, gauss_order=3):
    """Add the Gauss points ``gaussP (n, 3 dims, 3 points)`` and weights
    ``gaussW`` of each triangle to ``mesh``."""
    if gauss_order != 3:
        raise ValueError(
            "The Gauss quadrature order you specified is not implemented")
    pt = np.array([[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6],
                   [1 / 6, 1 / 6, 2 / 3]])
    wg = np.array([1 / 3, 1 / 3, 1 / 3])
    VK = np.stack([mesh["P1"], mesh["P2"], mesh["P3"]], axis=1)
    mesh["gaussP"] = np.einsum("qv,nvd->ndq", pt, VK)
    mesh["gaussW"] = mesh["area"] * wg  # shared by all triangles
    return mesh


def _t(mesh, key, device):
    return torch.as_tensor(mesh[key], dtype=torch.float64, device=device)


def _solid_angle(R1, R2, R3):
    """Solid angle of the triangles seen from the points: ``R*`` (.., 3)."""
    numer = torch.abs(
        R1[..., 0] * R2[..., 1] * R3[..., 2]
        - R1[..., 0] * R2[..., 2] * R3[..., 1]
        + R1[..., 1] * R2[..., 2] * R3[..., 0]
        - R1[..., 1] * R2[..., 0] * R3[..., 2]
        + R1[..., 2] * R2[..., 0] * R3[..., 1]
        - R1[..., 2] * R2[..., 1] * R3[..., 0])
    l1 = torch.linalg.vector_norm(R1, dim=-1)
    l2 = torch.linalg.vector_norm(R2, dim=-1)
    l3 = torch.linalg.vector_norm(R3, dim=-1)
    denom = (l1 * l2 * l3 + l1 * torch.sum(R2 * R3, dim=-1)
             + l2 * torch.sum(R1 * R3, dim=-1)
             + l3 * torch.sum(R1 * R2, dim=-1))
    sol = 2 * torch.atan2(numer, denom)
    return torch.where(sol < 0, sol + 2 * np.pi, sol)


def _deHoop_all(mesh, device):
    """Singular-kernel integrals: ``out[r, c]`` = the de Hoop integral over
    triangle c at the Gauss points of triangle r, weighted."""
    G = _t(mesh, "gaussP", device)  # (n, 3, 3pts)
    x = G.permute(0, 2, 1)  # (n, pts, dim)
    P1, P2, P3 = (_t(mesh, k, device) for k in ("P1", "P2", "P3"))
    # R*: (c, r, pts, dim) = P*_c - x_r
    R1 = P1[:, None, None, :] - x[None]
    R2 = P2[:, None, None, :] - x[None]
    R3 = P3[:, None, None, :] - x[None]
    n1 = torch.linalg.vector_norm(R1, dim=-1)
    n2 = torch.linalg.vector_norm(R2, dim=-1)
    n3 = torch.linalg.vector_norm(R3, dim=-1)

    def dot(key, R):
        return torch.einsum("cd,crpd->crp", _t(mesh, key, device), R)

    dist = torch.abs(dot("normal", R1))
    solang = _solid_angle(R1, R2, R3)
    F = (-dist * solang
         + torch.nan_to_num(dot("nu1", R1) * torch.log(
             (n2 + dot("tau1", R2)) / (n1 + dot("tau1", R1))))
         + torch.nan_to_num(dot("nu2", R2) * torch.log(
             (n3 + dot("tau2", R3)) / (n2 + dot("tau2", R2))))
         + torch.nan_to_num(dot("nu3", R3) * torch.log(
             (n1 + dot("tau3", R1)) / (n3 + dot("tau3", R3)))))
    W = torch.as_tensor(mesh["gaussW"], dtype=torch.float64, device=device)
    return torch.einsum("crp,p->rc", F, W)


def _pair_distances(mesh, device):
    """``(dist, zero)``: distances between the Gauss points of every
    triangle pair, ``(n, n, 9)``, the coincident ones set to 1 and marked
    in ``zero``."""
    G = _t(mesh, "gaussP", device)
    rowind = torch.arange(3, device=device).repeat_interleave(3)
    colind = torch.arange(3, device=device).repeat(3)
    A = G[:, :, rowind]  # (n, 3, 9)
    B = G[:, :, colind]
    diff = A[:, None, :, :] - B[None, :, :, :]
    dist = torch.sqrt(torch.sum(diff**2, dim=2))
    zero = dist == 0
    return torch.where(zero, torch.ones_like(dist), dist), zero


def assemble_BEM(lam, mesh, gauss_order=3, der=0, device=None,
                 dehoop=None, pairs=None):
    """Dense BEM matrix T(lam) (or its ``der``-th derivative) on ``device``,
    vectorized over all triangle pairs.  ``dehoop`` and ``pairs``: the
    lambda-independent parts (:func:`_deHoop_all`, :func:`_pair_distances`)
    when the caller keeps them."""
    device = resolve_device(device)
    if "gaussP" not in mesh:
        precompute_quad(mesh, gauss_order)
    dist, zero = pairs if pairs is not None else _pair_distances(mesh, device)
    lam = complex(lam)
    if der == 0:
        E = torch.exp(1j * lam * dist) - 1
        E = torch.where(zero, torch.full_like(E, 1j * lam), E)
    elif der == 1:
        E = (1j * dist) * torch.exp(1j * lam * dist)
        E = torch.where(zero, torch.full_like(E, 1j), E)
    else:
        E = ((1j * dist) ** der) * torch.exp(1j * lam * dist)
        E = torch.where(zero, torch.zeros_like(E), E)
    W = np.asarray(mesh["gaussW"])
    aa = torch.as_tensor(np.repeat(W, 3) * np.tile(W, 3), device=device)
    T = torch.einsum("rck,k->rc", E / dist, aa.to(E.dtype)) / (4 * np.pi)
    if der == 0:
        if dehoop is None:
            dehoop = _deHoop_all(mesh, device)
        T = T + dehoop / (4 * np.pi)
    # the upper triangle mirrored
    return torch.triu(T) + torch.triu(T, 1).T


class BEM_NEP(NEP):
    def __init__(self, mesh, gauss_order=3, device=None):
        self.device = resolve_device(device)
        self.mesh = precompute_quad(mesh, gauss_order)
        self.n = mesh["P1"].shape[0]
        self.gauss_order = gauss_order
        self._pairs = _pair_distances(self.mesh, self.device)
        self._dehoop = _deHoop_all(self.mesh, self.device)

    def Mder(self, lam, der: int = 0):
        return assemble_BEM(lam, self.mesh, self.gauss_order, der,
                            device=self.device, dehoop=self._dehoop,
                            pairs=self._pairs)

    Mder_dense = Mder

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        return mlincomb_from_mder(self, lam, V, a, startder)


def bem_fichera(N=3, device=None):
    return BEM_NEP(gen_ficheramesh(N), device=device)
