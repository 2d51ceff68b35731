"""Matrix-free operator core: batched element matrices + gather/scatter
(counterpart of palace_tpu/ops/partial.py, element mode, with
`_assemble_element_matrices`, `EliminatedOperator` and `make_ess_mask`).

Each apply is t-dofs -> gather -> batched per-element matmul -> sorted
segment-sum scatter (index_add_ over the sorted permutation) -> t-dofs, with
DofTransformation signs folded into per-(element, dof) sign tables.  Host
tables stay numpy (`BucketTables`); `PAOperator` assembles the dense element
matrices of quadrature-data buckets on the host and copies every table once
to its device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch


@dataclass
class Scatter:
    """Sorted segment-sum scatter-add from element-local to global dofs."""

    num_dofs: int
    perm: np.ndarray
    seg_ids: np.ndarray

    @staticmethod
    def build(elem_dofs: Sequence[np.ndarray], num_dofs: int) -> "Scatter":
        flat = np.concatenate([np.asarray(ed).reshape(-1) for ed in elem_dofs])
        perm = np.argsort(flat, kind="stable")
        return Scatter(num_dofs, perm.astype(np.int64),
                       flat[perm].astype(np.int64))


def _scatter_apply(perm: torch.Tensor, seg_ids: torch.Tensor, num_dofs: int,
                   local_vals: List[torch.Tensor]) -> torch.Tensor:
    flat = torch.cat([v.reshape((-1,) + v.shape[2:]) for v in local_vals])
    out = torch.zeros((num_dofs,) + flat.shape[1:], dtype=flat.dtype,
                      device=flat.device)
    return out.index_add_(0, seg_ids, flat[perm])


def detect_dof_group(gidx_arrays: Sequence[np.ndarray], num_dofs: int) -> int:
    """Largest g in (4, 3, 2) such that every element dof list is a
    concatenation of aligned, consecutive g-blocks (and num_dofs % g == 0),
    so gather/scatter can run at g-dof group granularity."""
    for g in (4, 3, 2):
        if num_dofs % g:
            continue
        ok = True
        for gidx in gidx_arrays:
            gidx = np.asarray(gidx)
            nd = gidx.shape[1]
            if nd % g:
                ok = False
                break
            a = gidx.reshape(gidx.shape[0], nd // g, g)
            if (a[:, :, 0] % g).any():
                ok = False
                break
            base = a[:, :, 0]
            for k in range(1, g):
                if not np.array_equal(a[:, :, k], base + k):
                    ok = False
                    break
            if not ok:
                break
        if ok:
            return g
    return 1


@dataclass
class BucketTables:
    """Host tables of one element bucket (element mode)."""

    gidx: np.ndarray  # (E, nd) gather indices
    A: Optional[np.ndarray] = None  # (E, nd, nd) element matrices
    signs: Optional[np.ndarray] = None  # (E, nd)
    # Quadrature data, folded into A by `_assemble_element_matrices`:
    B: Optional[np.ndarray] = None  # (nq, nd) basis values
    G: Optional[np.ndarray] = None  # (nq, nd, d) reference gradients
    qd_mass: Optional[np.ndarray] = None  # (E, nq)
    qd_diffp: Optional[np.ndarray] = None  # (d, d, E, nq) planar layout


def signed_tables(buckets: Sequence[BucketTables]
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(gidx, A) per bucket with the orientation signs folded into A."""
    out = []
    for b in buckets:
        A = np.asarray(b.A)
        if b.signs is not None:
            s = np.asarray(b.signs)
            A = A * s[:, :, None] * s[:, None, :]
        out.append((np.asarray(b.gidx), A))
    return out


def tables_csr(tables, num_dofs: int) -> sp.csr_matrix:
    """Global sparse matrix (scipy CSR, host) of (gidx, A) element tables
    with their signs folded in; duplicate entries are summed."""
    rows, cols, vals = [], [], []
    for gidx, A in tables:
        E, nd = gidx.shape
        rows.append(np.repeat(gidx, nd, axis=1).ravel())
        cols.append(np.tile(gidx, (1, nd)).ravel())
        vals.append(np.asarray(A).reshape(E, -1).ravel())
    if not rows:
        return sp.csr_matrix((num_dofs, num_dofs))
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(num_dofs, num_dofs)).tocsr()


def _apply(tables: List[dict], perm: torch.Tensor, seg_ids: torch.Tensor,
           u: torch.Tensor, num_dofs: int) -> torch.Tensor:
    """Real apply (the counterpart of `_apply_jit`, element mode)."""
    locals_ = []
    for t in tables:
        ul = u[t["gidx"]]
        if "signs" in t:
            ul = ul * t["signs"]
        vl = torch.einsum("enm,em->en", t["A"], ul)
        if "signs" in t:
            vl = vl * t["signs"]
        locals_.append(vl)
    return _scatter_apply(perm, seg_ids, num_dofs, locals_)


class PAOperator:
    """Symmetric bilinear-form operator over the buckets of one space, with
    its element tables on `device` in `dtype`.  Buckets given as quadrature
    data get their dense element matrices here (element mode; palace_tpu's
    qdata mode has no driver caller and is not ported)."""

    def __init__(self, num_dofs: int, buckets: List[BucketTables],
                 device: torch.device = torch.device("cpu"),
                 dtype: torch.dtype = torch.float64):
        self.num_dofs = num_dofs
        self.buckets = buckets
        self.device = torch.device(device)
        self.dtype = dtype
        for b in buckets:
            if b.A is None:
                b.A = _assemble_element_matrices(b)
            b.B = b.G = b.qd_mass = b.qd_diffp = None
        sc = Scatter.build([b.gidx for b in buckets], num_dofs)
        self._perm = torch.as_tensor(sc.perm, device=self.device)
        self._seg = torch.as_tensor(sc.seg_ids, device=self.device)
        self._tables = []
        for b in buckets:
            t = {"gidx": torch.as_tensor(np.asarray(b.gidx, np.int64),
                                         device=self.device),
                 "A": torch.as_tensor(np.asarray(b.A), dtype=dtype,
                                      device=self.device)}
            if b.signs is not None:
                t["signs"] = torch.as_tensor(np.asarray(b.signs), dtype=dtype,
                                             device=self.device)
            self._tables.append(t)

    def _tensor(self, u) -> torch.Tensor:
        return torch.as_tensor(u, device=self.device)

    def __call__(self, u) -> torch.Tensor:
        u = self._tensor(u)
        if u.is_complex():
            return torch.complex(self(u.real), self(u.imag))
        return _apply(self._tables, self._perm, self._seg,
                      u.to(self.dtype), self.num_dofs)

    def diagonal(self) -> torch.Tensor:
        locals_ = []
        for t in self._tables:
            dl = torch.diagonal(t["A"], dim1=1, dim2=2)
            if "signs" in t:
                dl = dl * t["signs"] * t["signs"]
            locals_.append(dl)
        return _scatter_apply(self._perm, self._seg, self.num_dofs, locals_)

    def element_energy(self, u) -> List[torch.Tensor]:
        """Per-bucket, per-element quadratic forms 0.5 u_e^H A_e u_e."""
        u = self._tensor(u)
        if u.is_complex():
            re, im = u.real.contiguous(), u.imag.contiguous()
            out = []
            for t in self._tables:
                xr, xi = self._local(t, re), self._local(t, im)
                Axr = torch.einsum("enm,em->en", t["A"], xr)
                Axi = torch.einsum("enm,em->en", t["A"], xi)
                e = torch.complex((xr * Axr).sum(1) + (xi * Axi).sum(1),
                                  (xr * Axi).sum(1) - (xi * Axr).sum(1))
                out.append(0.5 * e)
            return out
        u = u.to(self.dtype)
        out = []
        for t in self._tables:
            ul = self._local(t, u)
            out.append(0.5 * torch.einsum("en,enm,em->e", ul, t["A"], ul))
        return out

    @staticmethod
    def _local(t: dict, u: torch.Tensor) -> torch.Tensor:
        ul = u[t["gidx"]]
        return ul * t["signs"] if "signs" in t else ul

    def assemble_csr(self) -> sp.csr_matrix:
        """Global sparse matrix (scipy CSR, host; for direct solves)."""
        return tables_csr(signed_tables(self.buckets), self.num_dofs)


def _assemble_element_matrices(b: BucketTables) -> np.ndarray:
    """A_e = sum_q G_q^T W_q G_q + B_q^T qm_q B_q on the host, one dgemm per
    term against a static assembly tensor:
      A[e, n*m] = sum_{d,k,q} W[e, d*k*q] * S[d*k*q, n*m],
      S[d,k,q,n,m] = G[q,n,d] G[q,m,k]."""
    E, nd = np.asarray(b.gidx).shape
    A = np.zeros((E, nd * nd))
    if b.qd_diffp is not None:
        G = np.asarray(b.G)  # (nq, nd, d)
        nq, _, d = G.shape
        # Rows ordered (dd, k, q) to match the planar qdata layout.
        S = (
            G.transpose(2, 0, 1)[:, None, :, :, None]
            * G.transpose(2, 0, 1)[None, :, :, None, :]
        ).reshape(d * d * nq, nd * nd)
        W = np.ascontiguousarray(
            np.moveaxis(np.asarray(b.qd_diffp).reshape(d * d, E, nq), 1, 0)
        ).reshape(E, d * d * nq)
        A += W @ S
    if b.qd_mass is not None:
        B = np.asarray(b.B)  # (nq, nd)
        nq = B.shape[0]
        SB = (B[:, :, None] * B[:, None, :]).reshape(nq, nd * nd)
        A += np.asarray(b.qd_mass) @ SB
    return A.reshape(E, nd, nd)


class EliminatedOperator:
    """Essential-BC elimination wrapper (reference: palace/linalg/rap.hpp:18-39,
    DiagonalPolicy::DIAG_ONE): y = A u on free dofs, y[ess] = u[ess].  The
    mask lives on the operator's device."""

    def __init__(self, op: PAOperator, ess_mask: np.ndarray):
        self.op = op
        self.ess_mask = torch.as_tensor(np.asarray(ess_mask, bool),
                                        device=op.device)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        y = self.op(u * (~self.ess_mask))
        return torch.where(self.ess_mask, u, y)

    def eliminate_rhs(self, b: torch.Tensor, x_bc: torch.Tensor
                      ) -> torch.Tensor:
        """b <- b - A x_bc on free dofs; b[ess] <- x_bc[ess]."""
        ax = self.op(x_bc * self.ess_mask)
        return torch.where(self.ess_mask, x_bc, b - ax)


def make_ess_mask(num_dofs: int, ess_dofs: np.ndarray) -> np.ndarray:
    m = np.zeros(num_dofs, bool)
    m[np.asarray(ess_dofs, np.int64)] = True
    return m
