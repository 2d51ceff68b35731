"""Matrix-free operator core: batched element kernels + gather/scatter
(counterpart of palace_tpu/ops/partial.py, with `_assemble_element_matrices`,
`EliminatedOperator` and `make_ess_mask`).

Each apply is t-dofs -> gather -> batched per-element kernel -> sorted
segment-sum scatter (index_add_ over the sorted permutation) -> t-dofs, with
DofTransformation signs folded into per-(element, dof) sign tables.  Host
tables stay numpy (`BucketTables`) and are copied once to the operator's
device.  Two element-kernel modes, as in palace_tpu:

- "element" (default): dense element matrices A_e (assembled on the host
  from quadrature data where a bucket carries it), one batched matmul.
- "qdata": quadrature-point partial assembly B^T (qd) B with the basis
  tables B, G and G2 shared across the bucket: nd q d numbers per element
  instead of nd^2.  Every quadrature table a bucket carries enters the
  apply, the diagonal and the assembled matrices (palace_tpu's qdata apply
  drops the planar H1 diffusion table and its assembly drops G2 / qd_diff2,
  the ND mass; ROADMAP.md section 3).
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
    """Host tables of one element bucket: element matrices, or quadrature
    data with shared basis tables."""

    gidx: np.ndarray  # (E, nd) gather indices
    A: Optional[np.ndarray] = None  # (E, nd, nd) element matrices
    signs: Optional[np.ndarray] = None  # (E, nd)
    B: Optional[np.ndarray] = None  # (nq, nd) basis values
    G: Optional[np.ndarray] = None  # (nq, nd, d) first basis table
    qd_mass: Optional[np.ndarray] = None  # (E, nq)
    qd_diff: Optional[np.ndarray] = None  # (E, nq, d, d) with G
    qd_diffp: Optional[np.ndarray] = None  # (d, d, E, nq) planar, with G
    G2: Optional[np.ndarray] = None  # (nq, nd, d2) second basis table
    qd_diff2: Optional[np.ndarray] = None  # (E, nq, d2, d2) with G2

    def qdata_terms(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(G, W) per quadrature term, W in the (E, nq, d, d) layout (the
        planar diffusion table converted)."""
        out = []
        if self.qd_diffp is not None:
            out.append((self.G, np.moveaxis(np.asarray(self.qd_diffp),
                                            (0, 1), (2, 3))))
        if self.qd_diff is not None:
            out.append((self.G, self.qd_diff))
        if self.qd_diff2 is not None:
            out.append((self.G2, self.qd_diff2))
        return out

    def element_matrices(self) -> np.ndarray:
        return np.asarray(self.A if self.A is not None
                          else _assemble_element_matrices(self))


def signed_tables(buckets: Sequence[BucketTables]
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(gidx, A) per bucket with the orientation signs folded into A."""
    out = []
    for b in buckets:
        A = b.element_matrices()
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


def _local_apply(t: dict, ul: torch.Tensor) -> torch.Tensor:
    """A_e u_e for every element of one bucket (u_e signed): the element
    matmul, or B^T (qd) B over the shared basis tables."""
    if "A" in t:
        return torch.einsum("enm,em->en", t["A"], ul)
    E, nd = ul.shape
    vl = torch.zeros_like(ul)
    for G, W in t["qd"]:
        nq, _, d = G.shape
        Gm = G.transpose(1, 2).reshape(nq * d, nd)
        du = (ul @ Gm.T).reshape(E, nq, d)
        h = torch.einsum("eqdk,eqk->eqd", W, du)
        vl = vl + h.reshape(E, nq * d) @ Gm
    if "qd_mass" in t:
        bu = ul @ t["B"].T
        vl = vl + (t["qd_mass"] * bu) @ t["B"]
    return vl


def _apply(tables: List[dict], perm: torch.Tensor, seg_ids: torch.Tensor,
           u: torch.Tensor, num_dofs: int) -> torch.Tensor:
    """Real apply (the counterpart of `_apply_jit`)."""
    locals_ = []
    for t in tables:
        ul = u[t["gidx"]]
        if "signs" in t:
            ul = ul * t["signs"]
        vl = _local_apply(t, ul)
        if "signs" in t:
            vl = vl * t["signs"]
        locals_.append(vl)
    return _scatter_apply(perm, seg_ids, num_dofs, locals_)


class PAOperator:
    """Symmetric bilinear-form operator over the buckets of one space, with
    its tables on `device` in `dtype`.  mode="element" applies dense element
    matrices (buckets given as quadrature data get theirs here); mode="qdata"
    keeps the quadrature data and the shared basis tables."""

    def __init__(self, num_dofs: int, buckets: List[BucketTables],
                 device: torch.device = torch.device("cpu"),
                 dtype: torch.dtype = torch.float64, mode: str = "element"):
        if mode not in ("element", "qdata"):
            raise ValueError(f"unknown PAOperator mode {mode!r}")
        self.num_dofs = num_dofs
        self.buckets = buckets
        self.device = torch.device(device)
        self.dtype = dtype
        self.mode = mode
        if mode == "element":
            for b in buckets:
                if b.A is None:
                    b.A = _assemble_element_matrices(b)
                b.B = b.G = b.qd_mass = b.qd_diff = b.qd_diffp = None
                b.G2 = b.qd_diff2 = None
        sc = Scatter.build([b.gidx for b in buckets], num_dofs)
        self._perm = torch.as_tensor(sc.perm, device=self.device)
        self._seg = torch.as_tensor(sc.seg_ids, device=self.device)

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        self._tables = []
        for b in buckets:
            t = {"gidx": torch.as_tensor(np.asarray(b.gidx, np.int64),
                                         device=self.device)}
            if b.A is not None:
                t["A"] = dev(b.A)
            else:
                t["qd"] = [(dev(G), dev(W)) for G, W in b.qdata_terms()]
                if b.qd_mass is not None:
                    t["B"], t["qd_mass"] = dev(b.B), dev(b.qd_mass)
            if b.signs is not None:
                t["signs"] = dev(b.signs)
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
            if "A" in t:
                dl = torch.diagonal(t["A"], dim1=1, dim2=2)
            else:
                dl = torch.zeros(t["gidx"].shape, dtype=self.dtype,
                                 device=self.device)
                for G, W in t["qd"]:
                    dl = dl + torch.einsum("qnd,eqdk,qnk->en", G, W, G)
                if "qd_mass" in t:
                    dl = dl + torch.einsum("qn,eq,qn->en", t["B"],
                                           t["qd_mass"], t["B"])
            if "signs" in t:
                dl = dl * t["signs"] * t["signs"]
            locals_.append(dl)
        return _scatter_apply(self._perm, self._seg, self.num_dofs, locals_)

    def element_energy(self, u) -> List[torch.Tensor]:
        """Per-bucket, per-element quadratic forms 0.5 u_e^H A_e u_e (in
        qdata mode through the quadrature apply; palace_tpu raises there)."""
        u = self._tensor(u)
        if u.is_complex():
            re, im = u.real.contiguous(), u.imag.contiguous()
            out = []
            for t in self._tables:
                xr, xi = self._local(t, re), self._local(t, im)
                Axr, Axi = _local_apply(t, xr), _local_apply(t, xi)
                e = torch.complex((xr * Axr).sum(1) + (xi * Axi).sum(1),
                                  (xr * Axi).sum(1) - (xi * Axr).sum(1))
                out.append(0.5 * e)
            return out
        u = u.to(self.dtype)
        out = []
        for t in self._tables:
            ul = self._local(t, u)
            out.append(0.5 * (ul * _local_apply(t, ul)).sum(1))
        return out

    @staticmethod
    def _local(t: dict, u: torch.Tensor) -> torch.Tensor:
        ul = u[t["gidx"]]
        return ul * t["signs"] if "signs" in t else ul

    def assemble_dense_local(self) -> List[np.ndarray]:
        """Per-bucket (E, nd, nd) element matrices with the signs folded in
        (host numpy)."""
        return [A for _, A in signed_tables(self.buckets)]

    def assemble_csr(self) -> sp.csr_matrix:
        """Global sparse matrix (scipy CSR, host; for direct solves)."""
        return tables_csr(signed_tables(self.buckets), self.num_dofs)


def _assemble_element_matrices(b: BucketTables) -> np.ndarray:
    """A_e = sum_q G_q^T W_q G_q (+ the same with G2) + B_q^T qm_q B_q on the
    host, one dgemm per term against a static assembly tensor:
      A[e, n*m] = sum_{q,d,k} W[e, q*d*k] * S[q*d*k, n*m],
      S[q,d,k,n,m] = G[q,n,d] G[q,m,k]
    (rows ordered (d, k, q) for the planar diffusion table)."""
    E, nd = np.asarray(b.gidx).shape
    A = np.zeros((E, nd * nd))
    if b.qd_diffp is not None:
        G = np.asarray(b.G)  # (nq, nd, d)
        nq, _, d = G.shape
        S = (
            G.transpose(2, 0, 1)[:, None, :, :, None]
            * G.transpose(2, 0, 1)[None, :, :, None, :]
        ).reshape(d * d * nq, nd * nd)
        W = np.ascontiguousarray(
            np.moveaxis(np.asarray(b.qd_diffp).reshape(d * d, E, nq), 1, 0)
        ).reshape(E, d * d * nq)
        A += W @ S
    for G, W in ((b.G, b.qd_diff), (b.G2, b.qd_diff2)):
        if W is None:
            continue
        G = np.asarray(G)  # (nq, nd, d)
        nq, _, d = G.shape
        S = (
            G.transpose(0, 2, 1)[:, :, None, :, None]
            * G.transpose(0, 2, 1)[:, None, :, None, :]
        ).reshape(nq * d * d, nd * nd)
        A += np.asarray(W).reshape(E, nq * d * d) @ S
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
