"""Device-resident blocked FGMRES + p-multigrid for term-structured systems
(counterpart of palace_tpu/linalg/device_ksp.py).

A(omega) = sum_t c_t(omega) X_t with every X_t real and constant across the
sweep; all frequencies of a block are solved together as one (n, F) complex
system.  The preconditioner is a p-multigrid V-cycle: 4th-kind Chebyshev
smoothing with Hiptmair (discrete-gradient) auxiliary correction, Galerkin
coarse levels P^T X_t P, and a host sparse-direct (scipy splu) coarse solve.
On a uniform PEC box hex mesh the fine level is `StructuredTermApply`, which
runs one of the two hand-written flat-lattice kernels (the caller's `layout`:
"natural" for the driven sweep, "class" for the eigensolver); otherwise
`ElemTermOperator`.

PyTorch runs eagerly: the Arnoldi scan and the restart loop are Python loops,
and the small (m+1) x m least-squares problems of each restart are solved on
the host with numpy's SVD-based lstsq (the Hessenberg matrix is rank
deficient once a column converges inside a cycle).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from palace_torch.ops.partial import Scatter, detect_dof_group, tables_csr

#: Elements of the gathered (rows, k, 2F) block an ELL apply builds at once
#: (bounds its scratch memory at 512 MiB in float64).
_ELL_CHUNK_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# Term-structured systems
# ---------------------------------------------------------------------------


@dataclass
class Term:
    """One constant real matrix X_t with its frequency coefficient c_t(omega).

    `tables` is the element/boundary (gidx, A) list (orientation signs
    folded); `coef` maps omega -> complex scalar; `bcoef` (optional) maps
    omega -> the coefficient used in the smoothing matrix B(omega) when it
    differs from the system coefficient (PCMatShifted)."""

    name: str
    tables: List[Tuple[np.ndarray, np.ndarray]]
    coef: Callable[[float], complex]
    bcoef: Optional[Callable[[float], complex]] = None
    _csr: Optional[sp.csr_matrix] = None

    def smoothing_coef(self, w: float) -> complex:
        return self.coef(w) if self.bcoef is None else self.bcoef(w)

    def csr(self, n: int) -> sp.csr_matrix:
        if self._csr is None:
            self._csr = tables_csr([(g, np.real(A)) for g, A in self.tables],
                                   n)
        return self._csr


def _csr_to_ell(A: sp.spmatrix, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-padded (cols, vals) tables for a gather+contract SpMV."""
    A = A.tocsr()
    A.sum_duplicates()
    n = A.shape[0]
    cnt = np.diff(A.indptr)
    k = max(1, int(cnt.max()) if n else 1)
    cols = np.zeros((n, k), np.int64)
    vals = np.zeros((n, k), np.float64)
    rows = np.repeat(np.arange(n), cnt)
    rowpos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], cnt)
    cols[rows, rowpos] = A.indices
    vals[rows, rowpos] = A.data
    return (torch.as_tensor(cols, device=device),
            torch.as_tensor(vals, device=device))


def _real_view(u: torch.Tensor) -> torch.Tensor:
    """(N, F) complex -> (N, 2F) real view (real, imag interleaved)."""
    return torch.view_as_real(u.contiguous()).reshape(u.shape[0], -1)


def _complex_view(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(x.reshape(x.shape[0], -1, 2))


def _ell_apply(ell, u: torch.Tensor) -> torch.Tensor:
    """(rows, F) <- ELL SpMV, blocked over columns; real tables applied to
    the real view of complex u, in row chunks."""
    cols, vals = ell
    n, k = cols.shape
    ur = _real_view(u)
    out = torch.empty((n, ur.shape[1]), dtype=ur.dtype, device=ur.device)
    step = max(1, _ELL_CHUNK_ELEMS // max(1, k * ur.shape[1]))
    for s in range(0, n, step):
        e = min(n, s + step)
        out[s:e] = torch.einsum("nk,nkf->nf", vals[s:e], ur[cols[s:e]])
    return _complex_view(out)


class ElemTermOperator:
    """Blocked apply y = sum_t coefs[t] * X_t @ u over element (gidx, A)
    tables with one shared sorted-segment-sum scatter (index_add_), at g-dof
    group granularity when the dof numbering is entity-blocked."""

    def __init__(self, terms: List[Term], num_dofs: int,
                 device: torch.device):
        self.num_dofs = num_dofs
        gidx_list, raw = [], []
        for ti, t in enumerate(terms):
            for gidx, A in t.tables:
                gidx_list.append(gidx)
                raw.append((ti, np.asarray(gidx), np.real(A)))
        self.group = g = detect_dof_group(gidx_list, num_dofs)
        grouped = [gidx[:, ::g] // g if g > 1 else gidx
                   for _, gidx, _ in raw]
        self._entries = [
            (ti, torch.as_tensor(gg, dtype=torch.int64, device=device),
             torch.as_tensor(A, dtype=torch.float64, device=device))
            for (ti, _, A), gg in zip(raw, grouped)]
        sc = Scatter.build(grouped, num_dofs // g)
        self._perm = torch.as_tensor(sc.perm, device=device)
        self._seg = torch.as_tensor(sc.seg_ids, device=device)

    def __call__(self, coefs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        F = u.shape[1]
        g = self.group
        ug = _real_view(u).reshape(self.num_dofs // g, g * 2 * F)
        locals_ = []
        for ti, gidxg, A in self._entries:
            E, ndg = gidxg.shape
            ul = ug[gidxg].reshape(E, ndg * g, 2 * F)
            vl = torch.bmm(A, ul)  # (E, nd, 2F) real
            vc = torch.view_as_complex(vl.reshape(E, ndg * g, F, 2))
            vc = vc * coefs[ti][None, None, :]
            locals_.append(torch.view_as_real(vc).reshape(E * ndg, g * 2 * F))
        flat = torch.cat(locals_, dim=0)
        yg = torch.zeros((self.num_dofs // g, g * 2 * F), dtype=flat.dtype,
                         device=flat.device)
        yg.index_add_(0, self._seg, flat[self._perm])
        return _complex_view(yg.reshape(self.num_dofs, 2 * F))


class EllTermOperator:
    """Blocked apply y = sum_t coefs[t] * X_t @ u from per-term ELL tables."""

    def __init__(self, csrs: List[sp.csr_matrix], device: torch.device):
        self._ell = [_csr_to_ell(A, device) for A in csrs]

    def __call__(self, coefs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        y = torch.zeros_like(u)
        for t, ell in enumerate(self._ell):
            y = y + coefs[t][None, :] * _ell_apply(ell, u)
        return y


# ---------------------------------------------------------------------------
# Smoothing
# ---------------------------------------------------------------------------


def _cheb4(applyB, dinv, lmax, r, order):
    """4th-kind Chebyshev smoothing y ~ B^-1 r (Phillips & Fischer 2022;
    reference: palace/linalg/chebyshev.cpp:190-220)."""
    d = (4.0 / (3.0 * lmax))[None, :] * (dinv * r)
    y = d
    rk = r
    for k in range(1, order):
        rk = rk - applyB(d)
        sd = (2.0 * k - 1.0) / (2.0 * k + 3.0)
        sr = (8.0 * k + 4.0) / (2.0 * k + 3.0)
        d = sd * d + sr / lmax[None, :] * (dinv * rk)
        y = y + d
    return y


def mg_orders(p: int, coarsening: str = "Logarithmic", max_levels: int = 100
              ) -> List[int]:
    """Fine-to-coarse order sequence (reference: palace/fem/multigrid.hpp)."""
    orders = [p]
    while orders[-1] > 1 and len(orders) < max_levels:
        if coarsening.lower().startswith("lin"):
            orders.append(orders[-1] - 1)
        else:
            orders.append(max(1, orders[-1] // 2))
    return orders


def _col_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.conj(a) * b, dim=0)


def _safe_div(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """w / h per column where h > 0, else w (h real, (F,))."""
    hs = torch.where(h > 0, h, torch.ones_like(h))
    return torch.where((h > 0)[None, :], w / hs.to(w.dtype)[None, :], w)


# ---------------------------------------------------------------------------
# The blocked device solver
# ---------------------------------------------------------------------------


class BlockedDeviceSolver:
    """FGMRES + p-MG on `device` for term systems A(omega) x = b over a block
    of frequencies.  `layout` is the lattice channel order of a structured
    fine level ("natural" or "class", see `StructuredTermApply`); the
    caller picks it, the result does not depend on it."""

    def __init__(self, space, materials_pec_attrs, terms: List[Term],
                 omegas: Sequence[float], ess_mask: np.ndarray, *,
                 tol: float = 1e-6, max_its: int = 200, restart: int = 30,
                 smooth_order: int = 4, smooth_its: int = 1,
                 use_aux: bool = True, coarsening: str = "Logarithmic",
                 max_levels: int = 100, max_block: int = 8,
                 log: Optional[Callable] = None,
                 device: torch.device = torch.device("cpu"),
                 layout: str = "natural"):
        from palace_torch.fem.h1 import H1Space
        from palace_torch.fem.nd import NDSpace
        from palace_torch.fem.nd_operators import nd_h1_gradient
        from palace_torch.linalg.ndmg import nd_prolongation
        from palace_torch.ops.structured import StructuredTermApply

        self.device = dev = torch.device(device)
        self.tol = tol
        self.max_its = max_its
        self.restart = min(restart, max_its)
        self.max_block = max_block
        self.log = log or (lambda s: None)
        self.terms = terms
        mesh = space.mesh
        n = space.num_dofs
        pec = list(materials_pec_attrs)

        orders = mg_orders(space.order, coarsening, max_levels)
        spaces = [space] + [NDSpace(mesh, q) for q in orders[1:]]

        # Per-level term CSRs (Galerkin-coarsened) and essential masks.
        csrs = [[t.csr(n) for t in terms]]
        ess_masks = [np.asarray(ess_mask)]
        Ps: List[Optional[sp.csr_matrix]] = [None]
        for li in range(1, len(spaces)):
            ess = np.zeros(spaces[li].num_dofs, bool)
            if pec:
                ess[spaces[li].boundary_dofs(pec)] = True
            P = nd_prolongation(spaces[li], spaces[li - 1])
            ff = sp.diags((~ess_masks[li - 1]).astype(float))
            fc = sp.diags((~ess).astype(float))
            P = (ff @ P @ fc).tocsr()
            Ps.append(P)
            ess_masks.append(ess)
            csrs.append([(P.T @ X @ P).tocsr() for X in csrs[li - 1]])

        # Structured fast path: on a uniform PEC box hex mesh the fine level
        # runs in lattice order through the flat-lattice kernel; all
        # fine-level tables are permuted once here and n-ordered vectors
        # convert only at the public solve()/apply_fine() boundary.
        self._fine_perm = None
        self.structured = None
        if len(spaces) > 1:
            try:
                self.structured = StructuredTermApply.build(
                    space, terms, np.asarray(ess_mask), dev, layout=layout)
            except ValueError as e:
                self.log(f"  device ksp: element fine level ({e})")
        if self.structured is not None:
            self._fine_perm = np.asarray(self.structured.perm)
            self.log(f"  device ksp: structured fine level engaged ({layout} "
                     f"layout, {len(self._fine_perm)} lattice dofs)")

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        self._levels = []
        aux_csrs_all = []
        for li, sp_l in enumerate(spaces):
            nl = sp_l.num_dofs
            ess = ess_masks[li]
            if li == 0 and self.structured is not None:
                perm = self._fine_perm
                lvl = {"n": len(perm), "apply": self.structured,
                       "diags": f64(np.stack([X.diagonal()[perm]
                                              for X in csrs[li]])),
                       "free": f64((~ess)[perm])}
            else:
                lvl = {"n": nl,
                       "apply": (ElemTermOperator(terms, nl, dev) if li == 0
                                 else EllTermOperator(csrs[li], dev)),
                       "diags": f64(np.stack([X.diagonal()
                                              for X in csrs[li]])),
                       "free": f64(~ess)}
            if use_aux:
                h1 = H1Space(mesh, sp_l.order)
                G = nd_h1_gradient(sp_l, h1)
                essg = np.zeros(h1.num_dofs, bool)
                if pec:
                    essg[h1.boundary_dofs(pec)] = True
                Gf = (sp.diags((~ess).astype(float)) @ G
                      @ sp.diags((~essg).astype(float))).tocsr()
                aux = [(Gf.T @ X @ Gf).tocsr() for X in csrs[li]]
                aux_csrs_all.append(aux)
                lvl["aux_apply"] = EllTermOperator(aux, dev)
                lvl["aux_diags"] = f64(np.stack([X.diagonal() for X in aux]))
                lvl["aux_free"] = f64(~essg)
                lvl["aux_ess"] = essg
                if li == 0 and self.structured is not None:
                    Gf = Gf[self._fine_perm].tocsr()
                lvl["G"] = _csr_to_ell(Gf, dev)
                lvl["Gt"] = _csr_to_ell(Gf.T.tocsr(), dev)
            else:
                aux_csrs_all.append(None)
            if li > 0:
                P_li = Ps[li]
                if li == 1 and self.structured is not None:
                    P_li = P_li[self._fine_perm].tocsr()
                lvl["P"] = _csr_to_ell(P_li, dev)
                lvl["Pt"] = _csr_to_ell(P_li.T.tocsr(), dev)
            self._levels.append(lvl)

        # Frequency tables: coefficients, lambda_max estimates and the coarse
        # complex factorization per frequency (appendable via add_omega).
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

    @property
    def fine_level(self) -> str:
        """The fine-level operator: "structured" (a hand-written kernel) or
        "element" (`ElemTermOperator`)."""
        return "element" if self.structured is None else "structured"

    def add_omega(self, w: float) -> int:
        """Register a sweep frequency; returns its omega_idx (coefficient and
        lambda_max columns plus the coarse complex LU)."""
        from scipy.sparse.linalg import splu

        csrs = self._setup_csrs
        aux_csrs_all = self._setup_aux_csrs
        ess_masks = self._setup_ess_masks
        T = len(self.terms)
        L = len(self._levels)
        coefs = np.array([t.coef(w) for t in self.terms], complex)
        bcoefs = np.array([t.smoothing_coef(w) for t in self.terms], complex)
        lmax = np.ones(L)
        aux_lmax = np.ones(L)
        for li in range(L):
            B = sum(bcoefs[t] * csrs[li][t] for t in range(T))
            lmax[li] = _lmax_est(B, ess_masks[li])
            if self._use_aux:
                Bg = sum(bcoefs[t] * aux_csrs_all[li][t] for t in range(T))
                aux_lmax[li] = _lmax_est(Bg, self._levels[li]["aux_ess"])
        A = sum(coefs[t] * csrs[-1][t] for t in range(T))
        if L == 1:
            # A one-level hierarchy (Order 1) factors the fine operator
            # itself, whose term CSRs keep their PEC rows and columns:
            # eliminate them as the fine apply does (palace_tpu does not,
            # and its FGMRES stalls there; ROADMAP.md, section 3).
            free = sp.diags((~ess_masks[-1]).astype(float))
            A = free @ A @ free
        A = A + sp.diags(ess_masks[-1].astype(float))
        self._coarse_lus.append(splu(A.tocsc()))
        self._coefs_all = np.concatenate([self._coefs_all, coefs[:, None]], 1)
        self._bcoefs_all = np.concatenate([self._bcoefs_all, bcoefs[:, None]],
                                          1)
        self._lmax_all = np.concatenate([self._lmax_all, lmax[:, None]], 1)
        self._aux_lmax_all = np.concatenate(
            [self._aux_lmax_all, aux_lmax[:, None]], 1)
        self.omegas.append(float(w))
        return len(self.omegas) - 1

    # -- V-cycle -------------------------------------------------------------

    def _coarse_solve(self, r: torch.Tensor) -> torch.Tensor:
        rh = r.cpu().numpy()
        x = np.stack([self._active_lus[f].solve(np.ascontiguousarray(
            rh[:, f])) for f in range(rh.shape[1])], axis=1)
        return torch.as_tensor(x, device=r.device)

    @staticmethod
    def _inv_diag(bcoefs: torch.Tensor, diags: torch.Tensor,
                  free: torch.Tensor) -> torch.Tensor:
        d = diags.T.to(bcoefs.dtype) @ bcoefs  # (n, F)
        safe = torch.where(d.abs() > 0, d, torch.ones_like(d))
        return torch.where(d.abs() > 0, 1.0 / safe,
                           torch.zeros_like(d)) * free[:, None]

    def _smooth(self, li, ctx, r, z, post):
        lvl = self._levels[li]
        coefs, bcoefs = ctx["coefs"], ctx["bcoefs"]
        free = lvl["free"][:, None]
        dinv, dginv = ctx["dinv"][li], ctx["dginv"][li]
        lmax, aux_lmax = ctx["lmax"][li], ctx["aux_lmax"][li]

        def applyA(u):
            return free * lvl["apply"](coefs, free * u)

        def applyB(u):
            return free * lvl["apply"](bcoefs, free * u)

        def primary(z):
            res = r if z is None else r - applyA(z)
            dz = _cheb4(applyB, dinv, lmax, res, self._smooth_order)
            return dz if z is None else z + dz

        def aux(z):
            if "G" not in lvl:
                return z
            auxfree = lvl["aux_free"][:, None]
            res = r - applyA(z)
            rg = auxfree * self._transfer(li, "Gt", res)

            def applyBg(u):
                return auxfree * lvl["aux_apply"](bcoefs, auxfree * u)

            zg = _cheb4(applyBg, dginv, aux_lmax, rg, self._smooth_order)
            return z + free * self._transfer(li, "G", zg)

        for _ in range(self._smooth_its):
            z = aux(primary(z)) if not post else primary(aux(z))
        return z

    def _vcycle(self, li, ctx, r):
        if li == len(self._levels) - 1:
            return self._coarse_solve(r)
        lvl = self._levels[li]
        free = lvl["free"][:, None]
        z = self._smooth(li, ctx, r, None, post=False)
        res = r - free * lvl["apply"](ctx["coefs"], free * z)
        nxt = self._levels[li + 1]
        rc = nxt["free"][:, None] * self._transfer(li + 1, "Pt", res)
        zc = self._vcycle(li + 1, ctx, rc)
        z = z + free * self._transfer(li + 1, "P", zc)
        return self._smooth(li, ctx, r, z, post=True)

    def _transfer(self, li: int, key: str, u: torch.Tensor) -> torch.Tensor:
        """One of level li's fixed maps applied to u: the discrete gradient
        "G" / "Gt" of its auxiliary space, or its prolongation "P" / "Pt"
        from / to level li - 1."""
        return _ell_apply(self._levels[li][key], u)

    def _dots(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Per-column a^H b of two level-0 block vectors."""
        return _col_dots(a, b)

    def _norms(self, a: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.real(self._dots(a, a)))

    def _orthogonalize(self, Vj: torch.Tensor, w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """w with the basis Vj (k, n, F) projected off, and the k projection
        coefficients a column (H[:k, j]; H[i, j] = 0 for i >= k): modified
        Gram-Schmidt."""
        h = torch.zeros((Vj.shape[0], w.shape[1]), dtype=w.dtype,
                        device=w.device)
        for i in range(Vj.shape[0]):
            h[i] = self._dots(Vj[i], w)
            w = w - h[i][None, :] * Vj[i]
        return w, h

    # -- FGMRES ----------------------------------------------------------------

    def _solve_block(self, ctx, b: torch.Tensor):
        """Restarted FGMRES on one (n, F) block; returns (x, iterations,
        relres, done) with per-column convergence freezing."""
        m = self.restart
        n, F = b.shape
        fine = self._levels[0]
        free = fine["free"][:, None]
        pin = 1.0 - free
        coefs = ctx["coefs"]
        n_outer = max(1, -(-self.max_its // m))

        def applyA(u):
            return free * fine["apply"](coefs, free * u) + pin * u

        bnorm = self._norms(b)
        bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
        x = torch.zeros_like(b)
        done = torch.zeros(F, dtype=torch.bool, device=b.device)
        iters = torch.zeros(F, dtype=torch.int64, device=b.device)
        rn = torch.zeros(F, dtype=torch.float64, device=b.device)
        V = torch.empty((m + 1, n, F), dtype=b.dtype, device=b.device)
        Z = torch.empty((m, n, F), dtype=b.dtype, device=b.device)
        k = 0
        while k < n_outer and not bool(done.all()):
            r = b - applyA(x)
            beta = self._norms(r)
            H = torch.zeros((m + 1, m, F), dtype=b.dtype, device=b.device)
            V[0] = _safe_div(r, beta)
            for j in range(m):
                z = self._vcycle(0, ctx, V[j])
                w = applyA(z)
                w, H[:j + 1, j] = self._orthogonalize(V[:j + 1], w)
                hn = self._norms(w)
                H[j + 1, j] = hn.to(b.dtype)
                V[j + 1] = _safe_div(w, hn)
                Z[j] = z
            y = _hessenberg_lstsq(H.cpu().numpy(), beta.cpu().numpy())
            y = torch.as_tensor(y, device=b.device)
            x_new = x.clone()
            for j in range(m):
                x_new += Z[j] * y[j][None, :]
            rn_new = self._norms(b - applyA(x_new))
            conv = rn_new <= self.tol * bnorm
            x = torch.where(done[None, :], x, x_new)
            rn = torch.where(done, rn, rn_new)
            iters = iters + torch.where(done, 0, m)
            done = done | conv
            k += 1
        return x, iters, rn / bnorm, done

    def _context(self, om: np.ndarray) -> Dict:
        """Per-block device data: coefficients, lambda_max, inverse
        diagonals of every level."""
        dev = self.device

        def c(a, dt):
            return torch.as_tensor(a, dtype=dt, device=dev)

        coefs = c(self._coefs_all[:, om], torch.complex128)
        bcoefs = c(self._bcoefs_all[:, om], torch.complex128)
        ctx = {"coefs": coefs, "bcoefs": bcoefs,
               "lmax": c(self._lmax_all[:, om], torch.float64),
               "aux_lmax": c(self._aux_lmax_all[:, om], torch.float64),
               "dinv": [], "dginv": []}
        for lvl in self._levels:
            ctx["dinv"].append(self._inv_diag(bcoefs, lvl["diags"],
                                              lvl["free"]))
            ctx["dginv"].append(self._inv_diag(bcoefs, lvl["aux_diags"],
                                               lvl["aux_free"])
                                if "aux_diags" in lvl else None)
        return ctx

    def apply_fine(self, coef_vec: np.ndarray, X: np.ndarray) -> np.ndarray:
        """y = (sum_t coef_vec[t] X_t) @ X on the fine level, free-restricted."""
        fine = self._levels[0]
        free = fine["free"][:, None]
        X = np.asarray(X, complex)
        c = torch.as_tensor(np.tile(np.asarray(coef_vec, complex)[:, None],
                                    (1, X.shape[1])), device=self.device)
        Xp = X[self._fine_perm] if self._fine_perm is not None else X
        y_l = (free * fine["apply"](c, free * torch.as_tensor(
            Xp, device=self.device))).cpu().numpy()
        if self._fine_perm is None:
            return y_l
        y = np.zeros(X.shape, y_l.dtype)
        y[self._fine_perm] = y_l
        return y

    def solve(self, rhs: np.ndarray, omega_idx: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, Dict]:
        """rhs: (n, F) complex; column f is a right-hand side at
        self.omegas[omega_idx[f]] (default: one column per sweep frequency).
        Returns (X, info) on the host."""
        n, F = rhs.shape
        if self._fine_perm is not None:
            X_l, info = self._solve_lattice(rhs[self._fine_perm], omega_idx)
            X = np.zeros((n, F), X_l.dtype)
            X[self._fine_perm] = X_l
            return X, info
        return self._solve_lattice(rhs, omega_idx)

    def _solve_lattice(self, rhs, omega_idx):
        n, F = rhs.shape
        omega_idx = (np.arange(F) if omega_idx is None
                     else np.asarray(omega_idx, int))
        if len(omega_idx) != F:
            raise ValueError("omega_idx must have one entry per column")
        Fb = self.max_block
        X = np.empty((n, F), np.complex128)
        info = {"iterations": np.zeros(F, int), "relres": np.zeros(F)}
        for start in range(0, F, Fb):
            idx = np.arange(start, min(start + Fb, F))
            # Pad the chunk to the fixed block width (repeat last column) so
            # iteration counts match the reference column for column.
            pad = np.concatenate([idx, np.full(Fb - len(idx), idx[-1])])
            om = omega_idx[pad]
            self._active_lus = [self._coarse_lus[f] for f in om]
            b = torch.as_tensor(np.ascontiguousarray(rhs[:, pad]),
                                dtype=torch.complex128, device=self.device)
            x, iters, relres, done = self._solve_block(self._context(om), b)
            iters = iters.cpu().numpy()
            relres = relres.cpu().numpy()
            done = done.cpu().numpy()
            X[:, idx] = x.cpu().numpy()[:, :len(idx)]
            info["iterations"][idx] = iters[:len(idx)]
            info["relres"][idx] = relres[:len(idx)]
            if not done.all():
                bad = [int(pad[f]) for f in range(Fb) if not done[f]]
                self.log(f"  device ksp WARNING: no convergence at sample(s) "
                         f"{bad} (relres {float(relres.max()):.2e})")
            self.log(f"  device ksp: samples {idx[0] + 1}-{idx[-1] + 1}"
                     f"/{F}: iterations {[int(i) for i in iters[:len(idx)]]}"
                     f", relres max {float(relres.max()):.2e}")
        return X, info


def _hessenberg_lstsq(H: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """Per column f: argmin_y ||beta_f e1 - H[:, :, f] y|| with numpy's
    SVD-based lstsq (minimum-norm for the rank-deficient Hessenberg matrix
    left by a column that converged inside the cycle)."""
    m1, m, F = H.shape
    y = np.zeros((m, F), H.dtype)
    for f in range(F):
        e1 = np.zeros(m1, H.dtype)
        e1[0] = beta[f]
        y[:, f] = np.linalg.lstsq(H[:, :, f], e1, rcond=None)[0]
    return y


def _lmax_est(B: sp.spmatrix, ess: np.ndarray, iters: int = 20) -> float:
    """Power-iteration estimate of |lambda|_max(D^-1 B) for real or complex
    B (reference: palace/linalg/operator.hpp:522)."""
    d = B.diagonal().copy()
    d[d == 0] = 1.0
    dinv = 1.0 / d
    dinv[np.asarray(ess, bool)] = 0.0
    rng = np.random.default_rng(3)
    v = rng.standard_normal(B.shape[0]).astype(B.dtype)
    v[np.asarray(ess, bool)] = 0.0
    lam = 1.0
    for _ in range(iters):
        w = dinv * (B @ v)
        w[np.asarray(ess, bool)] = 0.0
        lam = float(np.linalg.norm(w))
        if lam == 0:
            return 1.0
        v = w / lam
    return 1.1 * lam
