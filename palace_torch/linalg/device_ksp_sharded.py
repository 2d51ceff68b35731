"""Multi-rank (dof-sharded) variant of the blocked device FGMRES + p-MG
solver: the complex driven and eigen hot path over torch.distributed ranks
(counterpart of palace_tpu/linalg/device_ksp_sharded.py).

The same math, term structure and V-cycle as `BlockedDeviceSolver`, of which
this is a subclass, with the dof-sharded layout of
`parallel/dofsharded.py`:

* **Fine-level vectors** are each rank's local [interior | interface] rows
  (max_int + n_ifc, F); the interface rows are replicated.
* **Fine-level linear maps** (the term-structured system apply, the
  discrete gradient G / G^T of Hiptmair smoothing, and the transfers P / P^T
  to level 1) are split into per-shard ELL tables in which every nonzero is
  assigned to exactly one shard whose local dof map holds both its row and
  its column (`_assign`).  A local ELL SpMV followed by one all-reduce over
  the interface rows (or over the whole output, for a fine -> replicated
  map) is the halo exchange.  Like palace_tpu's, this route runs the ELL
  fine level, never the structured kernels.
* **Coarse p-MG levels are replicated** on every rank and run the
  single-device code.  The coarsest complex solve is a host `splu` solve on
  every rank: each rank factors its own copy, so the SuperLU thread guard
  palace_tpu needs around its shared factorization (`_coarse_cb`, called
  from several devices' runtime threads of one process) has no counterpart
  across processes.
* **FGMRES** is the single-device recurrence: each per-column dot is the
  all-reduce of the interior contraction plus the replicated interface
  contraction, and the small least-squares problems stay
  `numpy.linalg.lstsq` on identical inputs on every rank.  The Arnoldi
  step orthogonalizes by classical Gram-Schmidt twice (two all-reduces)
  in place of modified Gram-Schmidt (one a basis vector; palace_tpu's).

Every rank must call `solve` and `apply_fine` together; both take rank 0's
right-hand side and return the global result on every rank.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from palace_torch import parallel
from palace_torch.linalg.device_ksp import (_ELL_CHUNK_ELEMS,
                                            BlockedDeviceSolver,
                                            EllTermOperator, Term,
                                            _col_dots, _csr_to_ell,
                                            _ell_apply, _real_view, mg_orders)
from palace_torch.parallel.dofsharded import DofPartition, partition_for_space

# ---------------------------------------------------------------------------
# Partitions and entry->shard assignment
# ---------------------------------------------------------------------------


def partition_from_space(space, n_shards: int) -> DofPartition:
    """Element-SFC dof partition of a FE space (domain buckets)."""
    return partition_for_space(space, n_shards)


def _member(part: DofPartition) -> np.ndarray:
    """(S, N) bool: dof present in shard s's local map."""
    return part.local_maps >= 0


def _assign(rows: np.ndarray, cols: np.ndarray, mem_r: Optional[np.ndarray],
            mem_c: Optional[np.ndarray], S: int) -> np.ndarray:
    """Unique shard per entry: the lowest s whose local map contains both the
    row (if row-partitioned) and the column (if column-partitioned)."""
    n = len(rows)
    out = np.full(n, -1, np.int32)
    for s in range(S):
        ok = out < 0
        if mem_r is not None:
            ok &= mem_r[s][rows]
        if mem_c is not None:
            ok &= mem_c[s][cols]
        out[ok] = s
    if (out < 0).any():
        raise RuntimeError(
            "sharded map entry with no shard containing both endpoints "
            "(map does not respect the element partition)")
    return out


def _shard_ell(A: sp.spmatrix, row_part: Optional[DofPartition],
               col_part: Optional[DofPartition], S: int,
               shard: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Per-shard ELL tables (S, R, k) for y = A x with the local layout, or
    only shard `shard`'s (R, k) tables.

    Rows map to the shard-local layout [interior | interface] when
    ``row_part`` is given (R = max_int + n_ifc), else to global rows
    (replicated output, all-reduced whole).  Columns likewise.  Every nonzero
    is assigned to exactly one shard (see _assign), so summing the per-shard
    partial results reproduces A x exactly.
    """
    A = A.tocoo()
    rows, cols, vals = A.row, A.col, A.data
    mem_r = _member(row_part) if row_part is not None else None
    mem_c = _member(col_part) if col_part is not None else None
    shard_of = _assign(rows, cols, mem_r, mem_c, S)
    R = (row_part.max_int + row_part.n_ifc) if row_part is not None \
        else A.shape[0]
    C = (col_part.max_int + col_part.n_ifc) if col_part is not None \
        else A.shape[1]
    lrow = (row_part.local_maps[shard_of, rows] if row_part is not None
            else rows.astype(np.int64))
    lcol = (col_part.local_maps[shard_of, cols] if col_part is not None
            else cols.astype(np.int64))
    if shard is not None:
        keep = shard_of == shard
        shard_of, lrow, lcol, vals = (shard_of[keep], lrow[keep], lcol[keep],
                                      vals[keep])
    # ELL width = max entries of one (shard, local row).
    order = np.lexsort((lrow, shard_of))
    sh_s, r_s, c_s, v_s = (shard_of[order], lrow[order], lcol[order],
                           vals[order])
    key = sh_s.astype(np.int64) * R + r_s
    uniq, start, cnt = np.unique(key, return_index=True, return_counts=True)
    k = max(1, int(cnt.max()) if len(cnt) else 1)
    pos = np.arange(len(key)) - np.repeat(start, cnt)
    at = (r_s, pos) if shard is not None else (sh_s, r_s, pos)
    shape = (R, k) if shard is not None else (S, R, k)
    ell_c = np.zeros(shape, np.int32)
    ell_v = np.zeros(shape, np.float64)
    ell_c[at] = c_s
    ell_v[at] = np.real(v_s)
    return ell_c, ell_v, R, C


# ---------------------------------------------------------------------------
# Local-layout helpers (host side)
# ---------------------------------------------------------------------------


def scatter_cols(part: DofPartition, x: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Global (N, F) -> ((S, max_int, F), (n_ifc, F)); padded lanes zero."""
    x = np.asarray(x)
    xi = np.where(part.int_valid[:, :, None],
                  x[np.clip(part.int_global, 0, None)],
                  np.zeros((), x.dtype))
    return xi, x[part.ifc_global]


def gather_cols(part: DofPartition, xi, xf) -> np.ndarray:
    xi, xf = np.asarray(xi), np.asarray(xf)
    F = xi.shape[-1]
    out = np.zeros((part.num_dofs, F), xi.dtype)
    out[part.int_global[part.int_valid]] = xi[part.int_valid]
    out[part.ifc_global] = xf
    return out


def _device_ell(ell, device: torch.device):
    cols, vals = ell[0], ell[1]
    return (torch.as_tensor(cols, dtype=torch.int64, device=device),
            torch.as_tensor(vals, dtype=torch.float64, device=device))


def _union_ell(As: Sequence[sp.spmatrix], part: DofPartition, S: int,
               shard: int) -> Tuple[np.ndarray, np.ndarray]:
    """Shard `shard`'s ELL tables of T matrices on the union of their
    sparsity patterns: cols (R, k) and vals (T, R, k), R = max_int + n_ifc
    in both the row and the column layout.  An entry's shard depends only on
    its (row, column), so each term's slots are the ones `_shard_ell` gives
    it, and one gather of u serves every term."""
    coo = [A.tocoo() for A in As]
    key = np.concatenate([c.row.astype(np.int64) * part.num_dofs + c.col
                          for c in coo])
    ukey, inv = np.unique(key, return_inverse=True)
    U = sp.coo_matrix((np.arange(1, len(ukey) + 1, dtype=np.float64),
                       (ukey // part.num_dofs, ukey % part.num_dofs)),
                      shape=As[0].shape)
    cols, slot, _, _ = _shard_ell(U, part, part, S, shard=shard)
    # slot holds 1 + the union index of each ELL entry (0 where padded).
    where = np.full(len(ukey), -1, np.int64)
    flat = slot.ravel().astype(np.int64)
    where[flat[flat > 0] - 1] = np.flatnonzero(flat > 0)
    vals = np.zeros((len(As),) + cols.shape)
    off = 0
    for t, c in enumerate(coo):
        # An assembled CSR holds each (row, column) once.
        idx = where[inv[off:off + c.nnz]]
        vals[t].reshape(-1)[idx[idx >= 0]] = c.data[idx >= 0]
        off += c.nnz
    return cols, vals


class ShardedTermApply:
    """y = sum_t coefs[t] * X_t @ u on a rank's local vectors: one gather of
    u through the union ELL pattern of the terms, the per-term contractions,
    then one all-reduce over the interface rows."""

    def __init__(self, As: Sequence[sp.spmatrix], part: DofPartition, S: int,
                 shard: int, device: torch.device):
        cols, vals = _union_ell(As, part, S, shard)
        self._cols = torch.as_tensor(cols, dtype=torch.int64, device=device)
        self._vals = torch.as_tensor(vals, device=device)
        self.max_int = part.max_int

    def __call__(self, coefs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        n, k = self._cols.shape
        T = self._vals.shape[0]
        ur = _real_view(u)
        y = torch.empty_like(u)
        step = max(1, _ELL_CHUNK_ELEMS // max(1, k * ur.shape[1]))
        for s in range(0, n, step):
            e = min(n, s + step)
            w = torch.einsum("trk,rkf->trf", self._vals[:, s:e],
                             ur[self._cols[s:e]])  # (T, rows, 2F) real
            wc = torch.view_as_complex(w.reshape(T, e - s, -1, 2))
            y[s:e] = torch.einsum("tf,trf->rf", coefs, wc)
        parallel.psum(y[self.max_int:])
        return y


# ---------------------------------------------------------------------------
# The sharded solver
# ---------------------------------------------------------------------------


class ShardedBlockedDeviceSolver(BlockedDeviceSolver):
    """FGMRES + p-MG over the ranks of `parallel.current()` for term systems
    A(omega) x = b over a block of frequencies; this rank's tables on
    `device`.  Drop-in for `BlockedDeviceSolver` (same constructor
    semantics, no structured fine level)."""

    fine_level = "sharded-ell"

    def __init__(self, space, materials_pec_attrs, terms: List[Term],
                 omegas: Sequence[float], ess_mask: np.ndarray, *,
                 tol: float = 1e-6, max_its: int = 200, restart: int = 30,
                 smooth_order: int = 4, smooth_its: int = 1,
                 use_aux: bool = True, coarsening: str = "Logarithmic",
                 max_levels: int = 100, max_block: int = 8,
                 log: Optional[Callable] = None,
                 device: torch.device = torch.device("cpu")):
        from palace_torch.fem.h1 import H1Space
        from palace_torch.fem.nd import NDSpace
        from palace_torch.fem.nd_operators import nd_h1_gradient
        from palace_torch.linalg.ndmg import nd_prolongation

        ranks = parallel.current()
        self.S = S = ranks.n_shards
        self.rank = r = ranks.rank
        self.device = dev = torch.device(device)
        self.tol = tol
        self.max_its = max_its
        self.restart = min(restart, max_its)
        self.max_block = max_block
        self.log = log or (lambda s: None)
        self.terms = terms
        self.structured = None
        self._fine_perm = None
        mesh = space.mesh
        n = space.num_dofs
        pec = list(materials_pec_attrs)

        self.part = part = partition_from_space(space, S)
        orders = mg_orders(space.order, coarsening, max_levels)
        spaces = [space] + [NDSpace(mesh, q) for q in orders[1:]]

        # Per-level term CSRs (Galerkin-coarsened) and essential masks, as in
        # the single-device solver.
        csrs = [[t.csr(n) for t in terms]]
        ess_masks = [np.asarray(ess_mask)]
        Ps: List[Optional[sp.csr_matrix]] = [None]
        for li in range(1, len(spaces)):
            ess = np.zeros(spaces[li].num_dofs, bool)
            if pec:
                ess[spaces[li].boundary_dofs(pec)] = True
            Pl = nd_prolongation(spaces[li], spaces[li - 1])
            ff = sp.diags((~ess_masks[li - 1]).astype(float))
            fc = sp.diags((~ess).astype(float))
            Ps.append((ff @ Pl @ fc).tocsr())
            ess_masks.append(ess)
            csrs.append([(Ps[li].T @ X @ Ps[li]).tocsr()
                         for X in csrs[li - 1]])

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        def shard_ell(A, rp, cp):
            return _device_ell(_shard_ell(A, rp, cp, S, shard=r), dev)

        # ---- fine level: this rank's tables, local layout ------------------
        # The term apply is a sharded ELL of the assembled CSRs on their
        # union pattern (the assembled CSR gathers fewer rows than element
        # tables, and the entry->shard assignment is uniform).  Padded
        # interior lanes are pinned (free = 0), so they hold zeros
        # throughout.
        fine = {"n": part.n_local,
                "apply": ShardedTermApply(csrs[0], part, S, r, dev),
                "diags": f64(np.stack([part.to_local(X.diagonal(), r)
                                       for X in csrs[0]])),
                "free": f64(part.to_local((~ess_masks[0]).astype(float), r))}
        self.part_h1 = None
        aux_csrs_all = []
        if use_aux:
            h1 = H1Space(mesh, space.order)
            self.part_h1 = ph = partition_from_space(h1, S)
            G = nd_h1_gradient(space, h1)
            essg = np.zeros(h1.num_dofs, bool)
            if pec:
                essg[h1.boundary_dofs(pec)] = True
            Gf = (sp.diags((~ess_masks[0]).astype(float)) @ G
                  @ sp.diags((~essg).astype(float))).tocsr()
            aux0 = [(Gf.T @ X @ Gf).tocsr() for X in csrs[0]]
            aux_csrs_all.append(aux0)
            fine["aux_apply"] = ShardedTermApply(aux0, ph, S, r, dev)
            fine["aux_diags"] = f64(np.stack([ph.to_local(X.diagonal(), r)
                                              for X in aux0]))
            fine["aux_free"] = f64(ph.to_local((~essg).astype(float), r))
            fine["aux_ess"] = essg
            fine["G"] = shard_ell(Gf, part, ph)
            fine["Gt"] = shard_ell(Gf.T.tocsr(), ph, part)
        else:
            aux_csrs_all.append(None)
        self._levels = [fine]

        # ---- coarse levels (replicated), the single-device tables ----------
        for li in range(1, len(spaces)):
            ess = ess_masks[li]
            lvl = {"n": spaces[li].num_dofs,
                   "apply": EllTermOperator(csrs[li], dev),
                   "diags": f64(np.stack([X.diagonal() for X in csrs[li]])),
                   "free": f64(~ess)}
            if use_aux:
                h1l = H1Space(mesh, spaces[li].order)
                Gl = nd_h1_gradient(spaces[li], h1l)
                essgl = np.zeros(h1l.num_dofs, bool)
                if pec:
                    essgl[h1l.boundary_dofs(pec)] = True
                Glf = (sp.diags((~ess).astype(float)) @ Gl
                       @ sp.diags((~essgl).astype(float))).tocsr()
                aux = [(Glf.T @ X @ Glf).tocsr() for X in csrs[li]]
                aux_csrs_all.append(aux)
                lvl["aux_apply"] = EllTermOperator(aux, dev)
                lvl["aux_diags"] = f64(np.stack([X.diagonal() for X in aux]))
                lvl["aux_free"] = f64(~essgl)
                lvl["aux_ess"] = essgl
                lvl["G"] = _csr_to_ell(Glf, dev)
                lvl["Gt"] = _csr_to_ell(Glf.T.tocsr(), dev)
            else:
                aux_csrs_all.append(None)
            if li == 1:
                # Fine <-> level 1: local rows <-> replicated (_transfer).
                lvl["P"] = shard_ell(Ps[1], part, None)
                lvl["Pt"] = shard_ell(Ps[1].T.tocsr(), None, part)
            else:
                lvl["P"] = _csr_to_ell(Ps[li], dev)
                lvl["Pt"] = _csr_to_ell(Ps[li].T.tocsr(), dev)
            self._levels.append(lvl)

        # ---- frequency tables: `add_omega`, replicated on every rank -------
        L = len(self._levels)
        T = len(terms)
        self._setup_csrs = csrs
        self._setup_aux_csrs = aux_csrs_all
        self._setup_ess_masks = ess_masks
        self._use_aux = use_aux
        self._smooth_order = smooth_order
        self._smooth_its = smooth_its
        self._coefs_all = np.zeros((T, 0), complex)
        self._bcoefs_all = np.zeros((T, 0), complex)
        self._lmax_all = np.ones((L, 0))
        self._aux_lmax_all = np.ones((L, 0))
        self._coarse_lus = []
        self._active_lus: List = []
        self.omegas: List[float] = []
        for w in omegas:
            self.add_omega(w)

    def describe(self) -> dict:
        """The partition the solver runs on, for the provenance."""
        return {**parallel.describe(), "num_dofs": self.part.num_dofs,
                "max_int": self.part.max_int, "n_ifc": self.part.n_ifc}

    # -- sharded maps ----------------------------------------------------------

    def _transfer(self, li: int, key: str, u: torch.Tensor) -> torch.Tensor:
        if li == 0:  # G: H1 local -> ND local; Gt: ND local -> H1 local
            y = _ell_apply(self._levels[0][key], u)
            out = self.part if key == "G" else self.part_h1
            parallel.psum(y[out.max_int:])
            return y
        if li == 1 and key == "Pt":  # fine local -> replicated level 1
            return parallel.psum(_ell_apply(self._levels[1]["Pt"], u))
        if li == 1 and key == "P":  # replicated level 1 -> fine local
            y = _ell_apply(self._levels[1]["P"], u)
            parallel.psum(y[self.part.max_int:])
            return y
        return super()._transfer(li, key, u)

    def _dots(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        mi = self.part.max_int
        return (parallel.psum(_col_dots(a[:mi], b[:mi]))
                + _col_dots(a[mi:], b[mi:]))

    def _orthogonalize(self, Vj, w):
        """Classical Gram-Schmidt, twice (CGS2): two all-reduces an Arnoldi
        step where modified Gram-Schmidt takes one a basis vector.  On ranks
        that share a card each all-reduce costs milliseconds, and the
        collectives, not the card, bound a step; the basis stays orthogonal
        to working precision as with MGS (palace_tpu's sharded solver runs
        MGS)."""
        mi = self.part.max_int
        h = torch.zeros((Vj.shape[0], w.shape[1]), dtype=w.dtype,
                        device=w.device)
        for _ in range(2):
            c = parallel.psum(torch.einsum("knf,nf->kf", torch.conj(
                Vj[:, :mi]), w[:mi])) + torch.einsum(
                "knf,nf->kf", torch.conj(Vj[:, mi:]), w[mi:])
            w = w - torch.einsum("knf,kf->nf", Vj, c)
            h = h + c
        return w, h

    def _vcycle(self, li, ctx, r):
        if li > 0 or len(self._levels) > 1:
            return super()._vcycle(li, ctx, r)
        # One level (an Order 1 fine space): smoothing around a direct
        # correction of the gathered residual, as in palace_tpu.
        fine = self._levels[0]
        free = fine["free"][:, None]
        z = self._smooth(0, ctx, r, None, post=False)
        res = r - free * fine["apply"](ctx["coefs"], free * z)
        zg = self._coarse_solve(self.part.to_global(res, self.rank))
        z = z + free * self._local(zg)
        return self._smooth(0, ctx, r, z, post=True)

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """Global (N, F) tensor -> this rank's local rows (zero padding)."""
        rows = torch.as_tensor(self.part.local_rows(self.rank),
                               device=x.device)
        out = x[rows.clamp(min=0)]
        out[rows < 0] = 0
        return out

    # -- public interface --------------------------------------------------------

    def apply_fine(self, coef_vec: np.ndarray, X: np.ndarray) -> np.ndarray:
        """y = (sum_t coef_vec[t] X_t) @ X on the fine level, free-restricted
        (rank 0's X; the global y on every rank)."""
        fine = self._levels[0]
        free = fine["free"][:, None]
        Xg = parallel.broadcast(torch.as_tensor(
            np.ascontiguousarray(X), dtype=torch.complex128,
            device=self.device))
        c = torch.as_tensor(np.tile(np.asarray(coef_vec, complex)[:, None],
                                    (1, Xg.shape[1])), device=self.device)
        y = free * fine["apply"](c, free * self._local(Xg))
        return self.part.to_global(y, self.rank).cpu().numpy()

    def solve(self, rhs: np.ndarray, omega_idx: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, dict]:
        """The contract of `BlockedDeviceSolver.solve` over the ranks: rank
        0's rhs (n, F) in, the global X on every rank out."""
        b = parallel.broadcast(torch.as_tensor(
            np.ascontiguousarray(rhs), dtype=torch.complex128,
            device=self.device))
        X_l, info = self._solve_lattice(self._local(b).cpu().numpy(),
                                        omega_idx)
        X = self.part.to_global(torch.as_tensor(X_l, device=self.device),
                                self.rank)
        return X.cpu().numpy(), info
