"""Dof-sharded operators and Jacobi-CG over torch.distributed ranks: the
multi-GPU layer (counterpart of palace_tpu/parallel/dofsharded.py, "the
production multi-chip layer").

The numpy parts are palace_tpu's: the Morton (Z-order) element partition,
`TermBuckets` and `DofPartition` (`build`, `scatter_vector`,
`gather_vector`, `shard_term`), so both packages split a mesh alike.

* **Partition.**  Elements are ordered along a Morton curve of their
  centroids and cut into S contiguous, count-balanced chunks (the SFC analog
  of upstream Palace's METIS partition).  A dof touched by one shard's
  elements is interior to it; a dof touched by two or more is an interface
  dof.
* **Layout.**  Rank s holds its interior block (max_int rows, zero-padded)
  and the whole interface block (n_ifc rows), concatenated as one local
  vector [interior | interface] of max_int + n_ifc rows; the interface rows
  are replicated on every rank.  A rank holds only its own shard's element
  tables.
* **Halo exchange.**  After the local gather, element matmul and
  scatter-add, one all-reduce over the interface rows (`parallel.psum`)
  completes the apply.
* **Replicated-scalar CG.**  Each dot is the all-reduce of the interior
  contraction plus the interface contraction, which every rank computes once
  on identical data and never all-reduces.  The convergence test reads that
  all-reduced value, identical on every rank, so all ranks take the same
  branch.  A Python loop replaces palace_tpu's `lax.while_loop`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from palace_torch import parallel
from palace_torch.ops.partial import Scatter

# ---------------------------------------------------------------------------
# Morton (Z-order) element partition
# ---------------------------------------------------------------------------


def _spread_bits(v: np.ndarray, ndim: int) -> np.ndarray:
    """Interleave-ready bit spreading of 21-bit ints (ndim=2 or 3)."""
    v = v.astype(np.uint64)
    if ndim == 3:
        v &= np.uint64(0x1FFFFF)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    else:
        v &= np.uint64(0xFFFFFFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
        v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """Z-order codes of points (n, d), d in {2, 3}."""
    d = centroids.shape[1]
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-300)
    bits = 21 if d == 3 else 31
    q = np.minimum(
        ((centroids - lo) / span * (2**bits - 1)).astype(np.uint64),
        np.uint64(2**bits - 1),
    )
    code = np.zeros(len(centroids), np.uint64)
    for k in range(d):
        code |= _spread_bits(q[:, k], d) << np.uint64(k)
    return code


# ---------------------------------------------------------------------------
# Partition
# ---------------------------------------------------------------------------


@dataclass
class TermBuckets:
    """Per-shard apply tables of one bilinear-form term (one bucket list)."""

    gidx: List[np.ndarray]  # per bucket: (S, E_max, nd) local indices
    A: List[np.ndarray]  # per bucket: (S, E_max, nd, nd)
    signs: List[Optional[np.ndarray]]  # per bucket: (S, E_max, nd) or None


@dataclass
class DofPartition:
    """SFC element partition + interior/interface dof split for S shards."""

    n_shards: int
    num_dofs: int
    max_int: int
    n_ifc: int
    int_global: np.ndarray  # (S, max_int) global dof ids, -1 padding
    int_valid: np.ndarray  # (S, max_int) bool
    ifc_global: np.ndarray  # (n_ifc,)
    local_maps: np.ndarray  # (S, num_dofs) global -> local (-1 if absent)
    shard_of: List[np.ndarray]  # per input bucket: (E_b,) shard id

    @staticmethod
    def build(num_dofs: int, gidx_list: Sequence[np.ndarray],
              centroid_list: Sequence[np.ndarray], n_shards: int
              ) -> "DofPartition":
        S = n_shards
        counts_b = [len(c) for c in centroid_list]
        cents = np.concatenate([np.asarray(c, float) for c in centroid_list])
        order = np.argsort(morton_codes(cents), kind="stable")
        E_tot = len(cents)
        # Balanced contiguous chunks along the SFC.
        bounds = (np.arange(1, S) * E_tot) // S
        shard_global = np.empty(E_tot, np.int32)
        shard_global[order] = np.searchsorted(bounds, np.arange(E_tot),
                                              side="right")
        shard_of, off = [], 0
        for nb in counts_b:
            shard_of.append(shard_global[off:off + nb])
            off += nb

        # dof -> set of touching shards via unique (dof, shard) keys.
        keys = np.concatenate([
            g.astype(np.int64).ravel() * S + np.repeat(s.astype(np.int64),
                                                       g.shape[1])
            for g, s in zip(gidx_list, shard_of)
        ])
        u = np.unique(keys)
        dofs_u, shards_u = u // S, (u % S).astype(np.int32)
        touch = np.bincount(dofs_u, minlength=num_dofs)
        single = np.full(num_dofs, -1, np.int32)
        m1 = touch[dofs_u] == 1
        single[dofs_u[m1]] = shards_u[m1]
        interface = touch >= 2
        # Unused dofs (essential-only or orphaned) go interior to shard 0.
        single[touch == 0] = 0

        int_ids = [np.where(~interface & (single == s))[0] for s in range(S)]
        max_int = max(len(i) for i in int_ids)
        int_global = np.full((S, max_int), -1, np.int64)
        int_valid = np.zeros((S, max_int), bool)
        for s, ids in enumerate(int_ids):
            int_global[s, : len(ids)] = ids
            int_valid[s, : len(ids)] = True
        ifc_global = np.where(interface)[0]
        n_ifc = len(ifc_global)

        local_maps = np.full((S, num_dofs), -1, np.int64)
        local_maps[:, ifc_global] = max_int + np.arange(n_ifc)
        for s, ids in enumerate(int_ids):
            local_maps[s, ids] = np.arange(len(ids))
        return DofPartition(S, num_dofs, max_int, n_ifc, int_global,
                            int_valid, ifc_global, local_maps, shard_of)

    # -- vector layout ------------------------------------------------------

    def scatter_vector(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Global (num_dofs,) -> ((S, max_int), (n_ifc,))."""
        x = np.asarray(x)
        xi = np.where(self.int_valid, x[np.clip(self.int_global, 0, None)],
                      np.zeros((), x.dtype))
        return xi, x[self.ifc_global]

    def gather_vector(self, x_int, x_ifc) -> np.ndarray:
        x_int, x_ifc = np.asarray(x_int), np.asarray(x_ifc)
        out = np.zeros(self.num_dofs, x_int.dtype)
        out[self.int_global[self.int_valid]] = x_int[self.int_valid]
        out[self.ifc_global] = x_ifc
        return out

    # -- one rank's local vectors ---------------------------------------------

    @property
    def n_local(self) -> int:
        """Rows of a rank's local vector: max_int + n_ifc."""
        return self.max_int + self.n_ifc

    def local_rows(self, rank: int) -> np.ndarray:
        """Global row of each local row of `rank` ([interior | interface];
        -1 on the interior padding)."""
        return np.concatenate([self.int_global[rank], self.ifc_global])

    def to_local(self, x: np.ndarray, rank: int) -> np.ndarray:
        """Global (num_dofs, ...) -> rank's local (max_int + n_ifc, ...),
        zero on the interior padding."""
        x = np.asarray(x)
        rows = self.local_rows(rank)
        out = x[np.clip(rows, 0, None)]
        out[rows < 0] = 0
        return out

    def to_global(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        """Every rank's local (max_int + n_ifc, ...) -> the global vector on
        every rank: each rank places its interior rows, rank 0 the (replicated)
        interface rows, and one all-reduce sums the disjoint pieces."""
        valid = torch.as_tensor(self.int_valid[rank], device=x.device)
        ids = torch.as_tensor(self.int_global[rank], device=x.device)
        out = torch.zeros((self.num_dofs,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        out[ids[valid]] = x[:self.max_int][valid]
        if rank == 0:
            out[torch.as_tensor(self.ifc_global, device=x.device)] = \
                x[self.max_int:]
        return parallel.psum(out)

    # -- table layout -------------------------------------------------------

    def shard_term(self, gidx_list, A_list, signs_list=None, dtype=None,
                   bucket_ids: Optional[Sequence[int]] = None) -> TermBuckets:
        """Pack one term's element tables into per-shard padded arrays.

        ``bucket_ids`` maps each entry to the partition bucket (defaults to
        positional).  Padded rows get zero element matrices and local index
        0, so they contribute nothing to the scatter-add.
        """
        S = self.n_shards
        g_out, A_out, s_out = [], [], []
        for k, (g, A) in enumerate(zip(gidx_list, A_list)):
            b = bucket_ids[k] if bucket_ids is not None else k
            sh = self.shard_of[b]
            g = np.asarray(g)
            A = np.asarray(A)
            sg = None if signs_list is None or signs_list[k] is None \
                else np.asarray(signs_list[k])
            if sg is not None and sg.dtype == object:
                sg = None  # np.asarray(None) from sign-free buckets
            if sg is not None and sg.ndim < 2:
                sg = np.broadcast_to(sg, g.shape)
            if dtype is not None:
                A = A.astype(dtype)
            E_max = int(np.bincount(sh, minlength=S).max())
            nd = g.shape[1]
            gi = np.zeros((S, E_max, nd), np.int64)
            Ai = np.zeros((S, E_max) + A.shape[1:], A.dtype)
            si = np.ones((S, E_max, nd), sg.dtype) if sg is not None else None
            for s in range(S):
                sel = np.where(sh == s)[0]
                gi[s, : len(sel)] = self.local_maps[s][g[sel]]
                Ai[s, : len(sel)] = A[sel]
                if si is not None:
                    si[s, : len(sel)] = sg[sel]
            g_out.append(gi)
            A_out.append(Ai)
            s_out.append(si)
        return TermBuckets(g_out, A_out, s_out)


# ---------------------------------------------------------------------------
# Sharded operator
# ---------------------------------------------------------------------------


class DofShardedOperator:
    """A(c) = sum_t c_t * X_t with the dof-sharded apply: this rank's
    element tables of every term on `device`, one sorted scatter over them,
    and one all-reduce of the interface rows.  Terms share the partition but
    may have distinct bucket sets (domain elements, boundary facets);
    `coefs` is a (T,) tensor, so one operator serves every frequency."""

    def __init__(self, part: DofPartition, terms: Sequence[TermBuckets],
                 device: torch.device, rank: Optional[int] = None):
        self.part = part
        self.rank = parallel.current().rank if rank is None else rank
        self.device = torch.device(device)
        r = self.rank
        self._entries = []  # (term index, gidx, A, signs or None)
        for ti, term in enumerate(terms):
            for g, A, s in zip(term.gidx, term.A, term.signs):
                self._entries.append((
                    ti, torch.as_tensor(g[r], device=self.device),
                    torch.as_tensor(np.ascontiguousarray(A[r]),
                                    dtype=torch.float64, device=self.device),
                    None if s is None else torch.as_tensor(
                        np.ascontiguousarray(s[r]), dtype=torch.float64,
                        device=self.device)))
        sc = Scatter.build([g[r] for t in terms for g in t.gidx],
                           part.n_local)
        self._perm = torch.as_tensor(sc.perm, device=self.device)
        self._seg = torch.as_tensor(sc.seg_ids, device=self.device)

    def apply(self, coefs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y = A(coefs) x on this rank's local vector (max_int + n_ifc,)."""
        locals_ = []
        for ti, g, A, s in self._entries:
            ul = x[g]
            if s is not None:
                ul = ul * s
            vl = torch.einsum("enm,em->en", A, ul)
            if s is not None:
                vl = vl * s
            locals_.append(coefs[ti] * vl.reshape(-1))
        flat = torch.cat(locals_)
        y = torch.zeros(self.part.n_local, dtype=flat.dtype,
                        device=self.device)
        y.index_add_(0, self._seg, flat[self._perm])
        parallel.psum(y[self.part.max_int:])
        return y


# ---------------------------------------------------------------------------
# Jacobi PCG on the sharded layout
# ---------------------------------------------------------------------------


def sharded_pcg(op: DofShardedOperator, coefs: torch.Tensor, b: torch.Tensor,
                diag: torch.Tensor, ess: torch.Tensor, *, tol: float = 1e-10,
                max_its: int = 1000) -> Tuple[torch.Tensor, float, int]:
    """Jacobi-preconditioned CG on this rank's local vectors.  Essential
    dofs act as an identity block (the `EliminatedOperator` convention): b
    carries the BC value there and the solution reproduces it.  Returns
    (x local, relres, iterations), relres and iterations equal on every
    rank."""
    mi = op.part.max_int

    def A(x):
        y = op.apply(coefs, torch.where(ess, torch.zeros_like(x), x))
        return torch.where(ess, x, y)

    bad = diag == 0
    dinv = torch.where(ess, torch.ones_like(diag), torch.where(
        bad, torch.zeros_like(diag),
        1.0 / torch.where(bad, torch.ones_like(diag), diag)))

    def dots(*pairs):
        """[a^H b for (a, b) in pairs]: the interior contractions in one
        all-reduce, plus the replicated interface contractions."""
        di = torch.stack([torch.vdot(a[:mi], c[:mi]) for a, c in pairs])
        df = torch.stack([torch.vdot(a[mi:], c[mi:]) for a, c in pairs])
        return parallel.psum(di) + df

    bb, = dots((b, b))
    bnorm = float(torch.sqrt(torch.real(bb)))
    rnorm = bnorm
    bnorm = bnorm if bnorm != 0 else 1.0
    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r
    p = z
    rz, = dots((z, b))
    it = 0
    while rnorm > tol * bnorm and it < max_its:
        Ap = A(p)
        alpha = rz / dots((p, Ap))[0]
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new, rr = dots((z, r), (r, r))
        p = z + (rz_new / rz) * p
        rz = rz_new
        rnorm = float(torch.sqrt(torch.real(rr)))
        it += 1
    return x, rnorm / bnorm, it


# ---------------------------------------------------------------------------
# Glue: build from PAOperator(s) + mesh geometry
# ---------------------------------------------------------------------------


def bucket_centroids(mesh_obj) -> List[np.ndarray]:
    return [mesh_obj.nodes[b.conn].mean(axis=1) for b in mesh_obj.buckets]


def partition_for_space(space, n_shards: int) -> DofPartition:
    """Partition a FE space's dofs using its mesh's domain buckets."""
    gidx = [np.asarray(g) for g in space.elem_dofs]
    cents = bucket_centroids(space.mesh)
    return DofPartition.build(space.num_dofs, gidx, cents, n_shards)


def shard_pa_operator(op, part: DofPartition, dtype=None
                      ) -> DofShardedOperator:
    """DofShardedOperator (single term, coef [1.0]) on `op`'s device from an
    element-mode PAOperator whose buckets align with the partition
    buckets."""
    gidx = [np.asarray(b.gidx) for b in op.buckets]
    A = [np.asarray(b.A) for b in op.buckets]
    signs = [None if b.signs is None else np.asarray(b.signs)
             for b in op.buckets]
    term = part.shard_term(gidx, A, signs, dtype=dtype)
    return DofShardedOperator(part, [term], op.device)


def solve_spd_sharded(op, b, ess_mask, *, tol: float = 1e-10,
                      max_its: int = 1000,
                      part: Optional[DofPartition] = None,
                      sharded: Optional[DofShardedOperator] = None):
    """Multi-rank CG solve of an element-mode PAOperator system (b and the
    mask global, as every rank holds them; rank 0's b is the one solved).
    Returns (x global on op's device, iterations, relres, sharded_op); the
    sharded operator can be reused across right-hand sides (the
    per-terminal static solves)."""
    if sharded is None:
        if part is None:
            raise ValueError("pass part= or sharded=")
        sharded = shard_pa_operator(op, part)
    partn, r, dev = sharded.part, sharded.rank, sharded.device

    def local(v, dtype):
        return torch.as_tensor(partn.to_local(np.asarray(v), r), dtype=dtype,
                               device=dev)

    def rank0(v):
        """Rank 0's copy of a global vector: the interface rows that every
        rank holds then agree to the last bit (a CUDA scatter-add, as in
        the diagonal, does not)."""
        return parallel.broadcast(torch.as_tensor(
            v, dtype=torch.float64, device=dev).clone()).cpu().numpy()

    x, relres, its = sharded_pcg(
        sharded, torch.ones(1, dtype=torch.float64, device=dev),
        local(rank0(b), torch.float64),
        local(rank0(op.diagonal()), torch.float64),
        local(np.asarray(ess_mask, bool), torch.bool), tol=tol,
        max_its=max_its)
    return partn.to_global(x, r), its, relres, sharded
