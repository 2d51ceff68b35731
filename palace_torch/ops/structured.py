"""Structured-mesh H(curl) fast path (counterpart of palace_tpu/ops/structured.py).

On a uniform box hex mesh with uniform coefficients the assembled operator is
translation invariant, so dofs live on a per-cell channel lattice
u[c, ix, iy, iz] with C = 3 p^3 channels and every element-local dof is
(cell + delta, channel) with delta in {0,1}^3.  The apply needs no gather:
the JAX package runs it as a 3-D convolution with the stencil kernel W; the
port runs it through the hand-written flat-lattice kernel
(ops/structured_kernel.py), and keeps the convolution (`structured_apply_conv`)
as a plain reference.  The solver's term apply takes either lattice channel
order: natural (`structured_apply_flat`, Pallas kernel #1's counterpart) or
carry-class (`structured_apply_flat_v2`, Pallas kernel #2's counterpart).
The top-boundary lattice planes (no owning cell) must be essential (PEC)
dofs.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from palace_torch.fem.reference import Geom
from palace_torch.ops.structured_kernel import (
    _class_tables, from_flat, structured_apply_flat, structured_apply_flat_v2,
    structured_apply_lattice, to_flat,
)


def _channel_id(p: int, d: int, i: int, j: int, k: int) -> int:
    return ((d * p + i) * p + j) * p + k


def hex_local_map(p: int):
    """Per local dof: (delta (3,) cell offset, channel id)."""
    from palace_torch.fem.nd_hex import hex_nd_dofs

    dofs = hex_nd_dofs(p)
    nd = len(dofs)
    deltas = np.zeros((nd, 3), np.int64)
    chan = np.zeros(nd, np.int64)
    for n, (d, i, j, k) in enumerate(dofs):
        o = [a for a in range(3) if a != d]
        jj, kk = j, k
        if j == p:
            deltas[n, o[0]] = 1
            jj = 0
        if k == p:
            deltas[n, o[1]] = 1
            kk = 0
        chan[n] = _channel_id(p, d, i, jj, kk)
    return deltas, chan


def _stencil(p: int, Af: np.ndarray) -> np.ndarray:
    """(C, C, 3, 3, 3) convolution kernel of the element matrix Af."""
    C = 3 * p ** 3
    deltas, chan = hex_local_map(p)
    W = np.zeros((C, C, 3, 3, 3))
    nd = len(chan)
    for a in range(nd):
        for bb in range(nd):
            off = deltas[bb] - deltas[a] + 1
            W[chan[a], chan[bb], off[0], off[1], off[2]] += Af[a, bb]
    return W


@dataclass
class StructuredNDOperator:
    """Flat-kernel apply of an ND operator on a uniform box hex mesh.  Tables
    are host numpy arrays; applies run on the device of their input."""

    p: int
    shape: Tuple[int, int, int]  # cells (nx, ny, nz)
    W: np.ndarray  # (C, C, 3, 3, 3) stencil kernel
    lat_gdof: np.ndarray  # (C, nx, ny, nz) lattice -> global dof
    ess_lat: np.ndarray  # (C, nx, ny, nz) essential-dof mask
    num_dofs: int
    Af: np.ndarray  # (nd, nd) signed element matrix

    @staticmethod
    def build(space, op, ess_mask: Optional[np.ndarray] = None
              ) -> "StructuredNDOperator":
        """From a hex NDSpace + element-mode operator (buckets with A and
        signs) on a uniform grid.  Raises ValueError unless the mesh is a
        single hex bucket on a full box grid with identical element matrices
        and signs."""
        mesh = space.mesh
        if len(mesh.buckets) != 1:
            raise ValueError("structured path: single hex bucket required")
        b = op.buckets[0]
        A = np.asarray(b.A)
        E = A.shape[0]
        cents = mesh.nodes[mesh.buckets[0].conn].mean(axis=1)
        uniq = [np.unique(np.round(cents[:, a], 9)) for a in range(3)]
        nx, ny, nz = (len(u) for u in uniq)
        if nx * ny * nz != E:
            raise ValueError("structured path: not a full box grid")
        ex = np.searchsorted(uniq[0], np.round(cents[:, 0], 9))
        ey = np.searchsorted(uniq[1], np.round(cents[:, 1], 9))
        ez = np.searchsorted(uniq[2], np.round(cents[:, 2], 9))
        if np.abs(A - A[0]).max() > 1e-12 * np.abs(A[0]).max():
            raise ValueError("structured path: element matrices not uniform "
                             "(geometry or coefficient varies)")
        Af = A[0]
        if b.signs is not None:
            sg = np.asarray(b.signs)
            if not (sg == sg[0]).all():
                raise ValueError("structured path: orientation signs not "
                                 "uniform")
            Af = Af * sg[0][:, None] * sg[0][None, :]

        p = space.order
        C = 3 * p ** 3
        deltas, chan = hex_local_map(p)
        gdofs = np.asarray(space.elem_dofs[0])  # (E, nd)
        lat = np.full((C, nx, ny, nz), -1, np.int64)
        cells = np.stack([ex, ey, ez], axis=1)
        tgt = cells[:, None, :] + deltas[None, :, :]  # (E, nd, 3)
        inside = ((tgt[..., 0] < nx) & (tgt[..., 1] < ny)
                  & (tgt[..., 2] < nz))
        ei, ni = np.nonzero(inside)
        lat[chan[ni], tgt[ei, ni, 0], tgt[ei, ni, 1], tgt[ei, ni, 2]] = \
            gdofs[ei, ni]
        if not (lat >= 0).all():
            raise ValueError("structured path: unassigned lattice slot")
        covered = np.zeros(space.num_dofs, bool)
        covered[lat.ravel()] = True
        if ess_mask is None:
            ess_mask = np.zeros(space.num_dofs, bool)
        if not covered[~np.asarray(ess_mask, bool)].all():
            raise ValueError(
                "structured path requires the unowned top-boundary dofs to "
                "be essential (PEC box)")
        ess_lat = np.asarray(ess_mask, bool)[lat]
        return StructuredNDOperator(p, (nx, ny, nz), _stencil(p, Af), lat,
                                    ess_lat, space.num_dofs, Af)

    @staticmethod
    def build_uniform(p: int, shape: Tuple[int, int, int], h: float,
                      curl: float = 1.0, mass: float = 0.0
                      ) -> "StructuredNDOperator":
        """Direct constructor for a uniform PEC box grid: one reference-cell
        element matrix and the analytic PEC lattice mask, O(nd^2) host work."""
        from palace_torch.fem.nd import NDSpace
        from palace_torch.mesh.generate import box_hex
        from palace_torch.fem.nd_operators import nd_operator

        space1 = NDSpace(box_hex(1, 1, 1, lx=h, ly=h, lz=h), p)
        op1 = nd_operator(space1, curl_coef={1: curl * np.eye(3)},
                          mass_coef=({1: mass * np.eye(3)} if mass else None))
        b = op1.buckets[0]
        Af = np.asarray(b.A)[0]
        if b.signs is not None:
            s = np.asarray(b.signs)[0]
            Af = Af * s[:, None] * s[None, :]
        nx, ny, nz = shape
        C = 3 * p ** 3
        npx, npy, npz = nx * p, ny * p, nz * p
        num_dofs = (npx * (npy + 1) * (npz + 1)
                    + (npx + 1) * npy * (npz + 1)
                    + (npx + 1) * (npy + 1) * npz)
        lat_gdof = np.arange(C * nx * ny * nz,
                             dtype=np.int64).reshape(C, nx, ny, nz)
        return StructuredNDOperator(p, tuple(shape), _stencil(p, Af),
                                    lat_gdof, pec_ess_lat(p, shape), num_dofs,
                                    Af)

    # -- vector layout ------------------------------------------------------

    def to_lattice(self, u: np.ndarray) -> np.ndarray:
        """Global (num_dofs,) or (num_dofs, B) -> (B, C, nx, ny, nz)."""
        u = np.asarray(u)
        if u.ndim == 1:
            u = u[:, None]
        return u[self.lat_gdof.ravel()].T.reshape(
            (u.shape[1], ) + self.lat_gdof.shape)

    def from_lattice(self, lat: np.ndarray) -> np.ndarray:
        """(B, C, nx, ny, nz) -> (num_dofs, B) (unowned dofs get 0)."""
        lat = np.asarray(lat)
        B = lat.shape[0]
        out = np.zeros((self.num_dofs, B), lat.dtype)
        out[self.lat_gdof.ravel()] = lat.reshape(B, -1).T
        return out

    def __call__(self, lat: torch.Tensor) -> torch.Tensor:
        """Apply on the lattice layout (B, C, nx, ny, nz), PEC-masked, through
        the flat kernel (plain version on a CPU tensor)."""
        return structured_apply_lattice(self, lat)

    def conv_apply(self, lat: torch.Tensor) -> torch.Tensor:
        """The same apply as a 3-D convolution (plain reference)."""
        return structured_apply_conv(
            torch.as_tensor(self.W, dtype=lat.dtype, device=lat.device), lat,
            torch.as_tensor(self.ess_lat, device=lat.device))


def structured_apply_conv(W: torch.Tensor, lat: torch.Tensor,
                          ess: torch.Tensor) -> torch.Tensor:
    """Plain stencil-convolution apply (the JAX package's
    `_structured_apply`): cross-correlation with the (C, C, 3, 3, 3) kernel,
    zero padding, PEC-masked in and out.  On the card, set
    torch.backends.cudnn.allow_tf32 = False before comparing float32."""
    free = torch.where(ess[None], 0, lat)
    y = F.conv3d(free, W, padding=1)
    return torch.where(ess[None], 0, y)


#: Lattice channel orders of `StructuredTermApply`.
LAYOUTS = ("natural", "class")


class StructuredTermApply:
    """Fine-level term apply for `BlockedDeviceSolver` on a uniform box hex
    mesh: y = sum_t coefs[t] * X_t u with every X_t the same stencil pattern,
    one flat-kernel launch per term on the real/imag-stacked (2F, C, Lu)
    batch, with no gather/scatter when the solver keeps its fine-level
    vectors in lattice order (`perm`).

    `layout` picks the lattice channel order and with it the kernel:
    "natural" (channels as `hex_local_map` numbers them) or "class" (the
    carry-class order of `_class_tables`, folded into `perm`, so the class
    layout costs no permutation per apply)."""

    def __init__(self, p: int, shape: Tuple[int, int, int],
                 Afs: List[torch.Tensor], ess_lat: torch.Tensor,
                 perm: np.ndarray, layout: str = "natural"):
        self.p = p
        self.shape = tuple(shape)
        self.Afs = Afs  # per-term (nd, nd) in the layout's local order
        self.ess_lat = ess_lat  # (C, nx, ny, nz) bool in the layout's order
        self.perm = perm  # (L,) lattice-order dof ids (L = C nx ny nz)
        self.layout = layout

    @staticmethod
    def build(space, terms, ess_mask, device: torch.device,
              dtype: torch.dtype = torch.float64,
              layout: str = "natural") -> "StructuredTermApply":
        """Raises ValueError unless every term is a single uniform domain
        element table on a single-hex-bucket box grid that is not periodic.
        A periodic mesh is refused outright: the zero-padded lattice stencil
        drops the couplings across the wrap and cannot carry a Bloch
        phase.  So is a 2D mesh, or a bucket of another geometry, before
        the lattice probe indexes three centroid axes."""
        if layout not in LAYOUTS:
            raise ValueError(f"unknown lattice layout {layout!r}")
        if space.mesh.node_ident is not None:
            raise ValueError(
                "structured: periodic mesh (the zero-padded lattice stencil "
                "drops the wrap couplings and cannot carry a Bloch phase)")
        if len(space.mesh.buckets) != 1:
            raise ValueError("structured: single-bucket mesh required")
        if space.mesh.nodes.shape[1] != 3 or \
                space.mesh.buckets[0].geom is not Geom.HEX:
            raise ValueError("structured: a 3D hexahedral mesh is required")
        gd = np.asarray(space.elem_dofs[0])
        ops = []
        for t in terms:
            if len(t.tables) != 1:
                raise ValueError(f"term {t.name}: needs one domain table")
            gidx, A = t.tables[0]
            if np.asarray(gidx).shape != gd.shape or \
                    not np.array_equal(np.asarray(gidx), gd):
                raise ValueError(f"term {t.name}: not the domain table")
            fake = SimpleNamespace(buckets=[SimpleNamespace(
                A=np.real(np.asarray(A)), signs=None)])
            ops.append(StructuredNDOperator.build(space, fake, ess_mask))
        st0 = ops[0]
        perm_c = np.arange(3 * st0.p ** 3)
        Afs = [op.Af for op in ops]
        if layout == "class":
            perm_c, perm_l, _ = _class_tables(st0.p, st0.shape)
            Afs = [Af[np.ix_(perm_l, perm_l)] for Af in Afs]
        return StructuredTermApply(
            st0.p, st0.shape,
            [torch.as_tensor(Af, dtype=dtype, device=device).contiguous()
             for Af in Afs],
            torch.as_tensor(st0.ess_lat[perm_c], device=device),
            st0.lat_gdof[perm_c].ravel(), layout)

    def __call__(self, coefs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """u: (L, F) complex in lattice order; coefs: (T, F) complex."""
        nx, ny, nz = self.shape
        C = self.ess_lat.shape[0]
        Fc = u.shape[1]
        lat = u.T.reshape(Fc, C, nx, ny, nz)
        real = torch.cat([lat.real, lat.imag], dim=0)
        real = torch.where(self.ess_lat[None], 0, real)
        u_flat = to_flat(real, self.p, self.shape)
        kernel = (structured_apply_flat_v2 if self.layout == "class"
                  else structured_apply_flat)
        y = torch.zeros_like(u)
        for t, Af in enumerate(self.Afs):
            v = from_flat(kernel(Af, u_flat, p=self.p, shape=self.shape),
                          self.p, self.shape)
            v = torch.where(self.ess_lat[None], 0, v)
            vc = torch.complex(v[:Fc], v[Fc:]).reshape(Fc, -1).T
            y = y + coefs[t][None, :] * vc
        return y


def pec_ess_lat(p: int, shape: Tuple[int, int, int]) -> np.ndarray:
    """Analytic PEC (all-faces essential) mask on the dof lattice: a
    d-family dof with intra-cell cross indices (j, k) lies on a low boundary
    plane iff its cross index is 0 in a cell with cross-cell index 0 (the
    high faces are the unowned top lattice planes)."""
    nx, ny, nz = shape
    C = 3 * p ** 3
    ess = np.zeros((C, nx, ny, nz), bool)
    for d in range(3):
        o = [a for a in range(3) if a != d]
        for i in range(p):
            for j in range(p):
                for k in range(p):
                    c = _channel_id(p, d, i, j, k)
                    if j == 0:
                        sl = [slice(None)] * 3
                        sl[o[0]] = 0
                        ess[(c, *sl)] = True
                    if k == 0:
                        sl = [slice(None)] * 3
                        sl[o[1]] = 0
                        ess[(c, *sl)] = True
    return ess
