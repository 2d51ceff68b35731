"""p-multigrid + Hiptmair smoothing for H(curl) systems (reference:
palace/linalg/gmg.hpp:31-64, palace/linalg/distrelaxation.hpp:24-30,
palace/linalg/chebyshev.hpp:15-22).

V-cycle over ND spaces of decreasing order p with:
  - 4th-kind Chebyshev-accelerated Jacobi smoothing on the ND space,
  - distributive (Hiptmair) auxiliary-space correction through the discrete
    gradient G: smooth A_G = G^T A G on the scalar H1 space, which targets
    the gradient near-nullspace of the shifted curl-curl operator,
  - sparse-direct coarse solve at p = 1.

Host/scipy implementation (the complex driven system is solved by FGMRES
with this real V-cycle applied to real and imaginary parts, the analog of
the reference's real-PC-for-complex-system MfemWrapperSolver,
palace/linalg/solver.hpp:67-71).

Copied from palace_tpu/linalg/ndmg.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import scipy.sparse as sp

from palace_torch.fem import reference as ref
from palace_torch.fem.nd import NDSpace


def nd_prolongation(coarse: NDSpace, fine: NDSpace) -> sp.csr_matrix:
    """Interpolation ND_pc -> ND_pf on the same mesh (pc < pf).

    Both bases transform covariantly, so the local coefficient matrix from a
    reference-space least squares is geometry independent, exactly like the
    discrete gradient (see fem/nd_operators.py nd_h1_gradient; reference:
    palace/fem/multigrid.hpp:19-75 builds these via MFEM transfer operators).
    """
    mesh = coarse.mesh
    rows, cols, vals = [], [], []
    seen = np.zeros(fine.num_dofs, bool)
    for bi, b in enumerate(mesh.buckets):
        geom = b.geom
        pts, _ = ref.quadrature(geom, 2 * fine.order + 2)
        Vf, _ = fine.basis_tables(geom, pts)  # (nq, ndf, dim)
        Vc, _ = coarse.basis_tables(geom, pts)  # (nq, ndc, dim)
        nq, ndf, dim = Vf.shape
        ndc = Vc.shape[1]
        Fm = Vf.transpose(0, 2, 1).reshape(nq * dim, ndf)
        Cm = Vc.transpose(0, 2, 1).reshape(nq * dim, ndc)
        loc, *_ = np.linalg.lstsq(Fm, Cm, rcond=None)  # (ndf, ndc)
        resid = np.linalg.norm(Fm @ loc - Cm)
        if resid > 1e-8:
            raise RuntimeError(
                f"nd_prolongation: ND_{coarse.order} not in ND_{fine.order} "
                f"span on {geom} (residual {resid:.2e})"
            )
        loc[np.abs(loc) < 1e-12] = 0.0
        fdofs = fine.elem_dofs[bi]
        cdofs = coarse.elem_dofs[bi]
        for n in range(ndf):
            nz = np.nonzero(loc[n])[0]
            if len(nz) == 0:
                continue
            r = fdofs[:, n]
            uniq_r, first = np.unique(r, return_index=True)
            keep = first[~seen[uniq_r]]
            if len(keep) == 0:
                continue
            seen[r[keep]] = True
            for m in nz:
                rows.append(r[keep])
                cols.append(cdofs[keep, m])
                vals.append(np.full(len(keep), loc[n, m]))
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(fine.num_dofs, coarse.num_dofs),
    ).tocsr()


def _cheb4_smoother(A: sp.csr_matrix, ess: np.ndarray, order: int = 4):
    """4th-kind Chebyshev polynomial smoother over diagonal-scaled A
    (reference: palace/linalg/chebyshev.cpp, Phillips & Fischer 2022)."""
    d = A.diagonal().copy()
    d[d == 0] = 1.0
    dinv = 1.0 / d
    dinv[ess] = 0.0

    # Estimate lambda_max(D^-1 A) by power iteration.
    rng = np.random.default_rng(7)
    v = rng.standard_normal(A.shape[0])
    v[ess] = 0.0
    lam = 1.0
    for _ in range(15):
        w = dinv * (A @ v)
        w[ess] = 0.0
        lam = np.linalg.norm(w)
        if lam == 0:
            lam = 1.0
            break
        v = w / lam
    lam_max = 1.1 * lam

    def smooth(r, x=None):
        # 4th-kind Chebyshev iteration on A x = r.
        if x is None:
            x = np.zeros_like(r)
            res = r.copy()
        else:
            res = r - A @ x
            res[ess] = 0.0
        z = np.zeros_like(r)
        for k in range(1, order + 1):
            z = (2 * k - 3) / (2 * k + 1) * z + (8 * k - 4) / (
                (2 * k + 1) * lam_max) * (dinv * res)
            x = x + z
            res = res - A @ z
            res[ess] = 0.0
        return x

    return smooth


@dataclass
class NDMGLevel:
    A: sp.csr_matrix
    ess: np.ndarray  # bool mask
    smooth: Callable
    aux_smooth: Optional[Callable]  # on H1 space
    G: Optional[sp.csr_matrix]  # discrete gradient H1 -> ND
    P: Optional[sp.csr_matrix]  # prolongation from next-coarser level


class NDMultigrid:
    """V-cycle preconditioner; levels[0] is the finest."""

    def __init__(self, levels: List[NDMGLevel], coarse_lu, pre_post: int = 1):
        self.levels = levels
        self.coarse_lu = coarse_lu
        self.pre_post = pre_post

    def _hiptmair(self, lvl: NDMGLevel, r, x):
        x = lvl.smooth(r, x)
        if lvl.G is not None:
            res = r - lvl.A @ x
            res[lvl.ess] = 0.0
            rg = lvl.G.T @ res
            xg = lvl.aux_smooth(rg)
            x = x + lvl.G @ xg
        return x

    def _vcycle(self, li: int, r):
        if li == len(self.levels) - 1:
            return self.coarse_lu(r)
        lvl = self.levels[li]
        x = self._hiptmair(lvl, r, None)
        res = r - lvl.A @ x
        res[lvl.ess] = 0.0
        P = self.levels[li + 1].P  # maps level li+1 (coarser) -> li
        rc = P.T @ res
        xc = self._vcycle(li + 1, rc)
        x = x + P @ xc
        x = self._hiptmair(lvl, r, x)
        return x

    def __call__(self, r):
        if np.iscomplexobj(r):
            return self._vcycle(0, r.real.copy()) + 1j * self._vcycle(
                0, r.imag.copy())
        return self._vcycle(0, r.copy())


def build_nd_multigrid(mesh, orders: List[int], make_matrix, pec_attrs,
                       smooth_order: int = 4) -> NDMultigrid:
    """Construct the hierarchy.

    orders: decreasing list, e.g. [2, 1]; make_matrix(space) -> real CSR of
    the (shifted) preconditioner matrix on that space (without essential BC
    elimination — applied here with DIAG_ONE).
    """
    from scipy.sparse.linalg import splu

    spaces = [NDSpace(mesh, p) for p in orders]
    levels: List[NDMGLevel] = []
    for i, space in enumerate(spaces):
        A = make_matrix(space)
        ess = np.zeros(space.num_dofs, bool)
        if pec_attrs:
            ess[space.boundary_dofs(pec_attrs)] = True
        free = sp.diags((~ess).astype(float))
        A = (free @ A @ free + sp.diags(ess.astype(float))).tocsr()
        levels.append(_make_level(
            space, A, ess, pec_attrs, smooth_order,
            P=nd_prolongation(spaces[i], spaces[i - 1]) if i > 0 else None,
        ))

    lu = splu(levels[-1].A.tocsc())
    coarse = lambda r: lu.solve(r)  # noqa: E731
    return NDMultigrid(levels, coarse)


def _make_level(space: NDSpace, A: sp.csr_matrix, ess: np.ndarray, pec_attrs,
                smooth_order: int, P) -> NDMGLevel:
    """Level with Chebyshev smoother + Hiptmair aux correction A_G = G^T A G."""
    from palace_torch.fem.h1 import H1Space
    from palace_torch.fem.nd_operators import nd_h1_gradient

    h1 = H1Space(space.mesh, space.order)
    G = nd_h1_gradient(space, h1)
    essg = np.zeros(h1.num_dofs, bool)
    if pec_attrs:
        essg[h1.boundary_dofs(pec_attrs)] = True
    AG = (G.T @ A @ G).tocsr()
    freg = sp.diags((~essg).astype(float))
    AG = (freg @ AG @ freg + sp.diags(essg.astype(float))).tocsr()
    return NDMGLevel(
        A=A, ess=ess,
        smooth=_cheb4_smoother(A, ess, smooth_order),
        aux_smooth=_cheb4_smoother(AG, essg, smooth_order),
        G=G, P=P,
    )


class DrivenPreconditioner:
    """Multigrid preconditioner for the complex driven system
    A = K + i omega C - omega^2 M.

    Residual propagation between levels uses the COMPLEX Galerkin matrices
    A_l = P^T A_{l-1} P so the coarsest level solves the true wave problem
    directly (the analog of the reference's ComplexCoarseSolve option,
    palace/utils/configfile.hpp linear solver options); smoothing at fine
    levels applies the SPD-shifted Chebyshev+Hiptmair smoother (built from
    K + omega^2 M, spaceoperator.hpp:49-50) to real and imaginary parts —
    high-frequency error is stiffness dominated, where shifted and true
    operators agree.
    """

    def __init__(self, mesh, orders: List[int], A_complex: sp.csr_matrix,
                 make_shifted, pec_attrs, smooth_order: int = 4):
        from scipy.sparse.linalg import splu

        spaces = [NDSpace(mesh, p) for p in orders]
        self.levels: List[NDMGLevel] = []
        self.Ac: List[sp.csr_matrix] = []
        Ac = A_complex
        for i, space in enumerate(spaces):
            ess = np.zeros(space.num_dofs, bool)
            if pec_attrs:
                ess[space.boundary_dofs(pec_attrs)] = True
            free = sp.diags((~ess).astype(float))
            one = sp.diags(ess.astype(float))
            P = nd_prolongation(spaces[i], spaces[i - 1]) if i > 0 else None
            if i > 0:
                Ac = (P.T @ self.Ac[-1] @ P)
                Ac = (free @ Ac @ free + one).tocsr()
            self.Ac.append(Ac.tocsr())
            As = make_shifted(space)
            As = (free @ As @ free + one).tocsr()
            self.levels.append(_make_level(space, As, ess, pec_attrs,
                                           smooth_order, P))
        self._lu = splu(self.Ac[-1].tocsc())

    def _smooth(self, lvl: NDMGLevel, Ac, r, x):
        """Hiptmair smoothing of complex x against the complex residual."""
        if x is None:
            res = r
            x = np.zeros_like(r)
        else:
            res = r - Ac @ x
            res[lvl.ess] = 0.0
        x = x + lvl.smooth(res.real, None) + 1j * lvl.smooth(res.imag, None)
        res = r - Ac @ x
        res[lvl.ess] = 0.0
        rg = lvl.G.T @ res
        xg = lvl.aux_smooth(rg.real) + 1j * lvl.aux_smooth(rg.imag)
        return x + lvl.G @ xg

    def _vcycle(self, li: int, r):
        if li == len(self.levels) - 1:
            return self._lu.solve(r)
        lvl = self.levels[li]
        Ac = self.Ac[li]
        x = self._smooth(lvl, Ac, r, None)
        res = r - Ac @ x
        res[lvl.ess] = 0.0
        P = self.levels[li + 1].P
        xc = self._vcycle(li + 1, P.T @ res)
        x = x + P @ xc
        return self._smooth(lvl, Ac, r, x)

    def __call__(self, r):
        return self._vcycle(0, r.astype(complex))
