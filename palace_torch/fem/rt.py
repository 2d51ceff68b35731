"""Arbitrary-order Raviart-Thomas H(div) spaces on simplicial meshes.

The counterpart of MFEM's RT_FECollection(k) spaces the reference uses for
flux-recovery error estimation (reference: palace/models/spaceoperator.cpp:44
rt_fecs with order = solver.order - 1, palace/linalg/errorestimator.cpp
FluxProjector/GradFluxErrorEstimator).  RT_k on a simplex is

    RT_k = (P_k)^d  +  x * \tilde{P}_k          (dim tri: (k+1)(k+3),
                                                 dim tet: (k+1)(k+2)(k+4)/2)

built here by inverting the canonical moment functionals numerically.

Conformity without DofTransformations: with ascending-vertex canonical
simplices (mesh.canonicalize_simplices, as for the ND spaces) every shared
facet is parameterized identically by its two neighbors, and the facet
moment functionals

    l_{F,j}(v) = int_F  (v . N_F) q_j(s, t) dS,
    N_F = (x_B - x_A) x (x_C - x_A)  for ascending (A, B, C)

are exactly invariant under the contravariant Piola map v = J v_ref / det J
with SIGNED det J (the identity (Ja) x (Jb) = det(J) J^{-T} (a x b) removes
every orientation/sign table; in 2D, a . R(b) with R = -90-degree rotation
plays the same role).

Copied from palace_tpu/fem/rt.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from palace_torch.fem import dofmap
from palace_torch.fem import reference as ref
from palace_torch.fem.reference import Geom

#: c1-marker distinguishing RT facet-moment keys from H1/ND lattice keys
#: within one space's key table (spaces number dofs independently; the
#: marker only guards against collisions between RT moment indices and
#: anything a future mixed space might merge in).
_RT_MARK = 211


def _mono_exps(dim: int, k: int, homogeneous: bool = False) -> np.ndarray:
    """Exponent multi-indices with |a| <= k (or == k if homogeneous)."""
    out = []
    rng = range(k + 1)
    if dim == 1:
        for a in rng:
            if (a == k) if homogeneous else (a <= k):
                out.append((a,))
    elif dim == 2:
        for a in rng:
            for b in rng:
                if (a + b == k) if homogeneous else (a + b <= k):
                    out.append((a, b))
    else:
        for a in rng:
            for b in rng:
                for c in rng:
                    s = a + b + c
                    if (s == k) if homogeneous else (s <= k):
                        out.append((a, b, c))
    return np.array(out if out else np.zeros((0, dim)), np.int64)


def _eval_mono(exps: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(npts, nexp) monomial values."""
    npts, dim = pts.shape
    out = np.ones((npts, len(exps)))
    for d in range(dim):
        e = exps[:, d]
        out *= pts[:, d][:, None] ** e[None, :]
    return out


@dataclass
class RTBasisSimplex:
    """Reference RT_k basis on the canonical (ascending-vertex) simplex.

    Generating set: (monomial, component) pairs for (P_k)^d plus x * x^b for
    homogeneous |b| = k; `coeff` maps generating functions -> dual basis.
    `facet_counts` is the number of moments per facet; `n_int` interior.
    """

    geom: Geom
    k: int
    exps_pk: np.ndarray  # (nA, dim)
    exps_hom: np.ndarray  # (nB, dim)
    coeff: np.ndarray  # (nfn, ngen) rows are basis functions
    n_facet: int  # moments per facet
    n_int: int

    @property
    def num_dofs(self) -> int:
        return self.coeff.shape[0]

    def eval(self, pts: np.ndarray) -> np.ndarray:
        """(npts, nfn, dim) reference values."""
        pts = np.asarray(pts, float)
        G = _eval_generating(self.geom, self.k, self.exps_pk, self.exps_hom,
                             pts)
        return np.einsum("fg,qgd->qfd", self.coeff, G)

    def eval_div(self, pts: np.ndarray) -> np.ndarray:
        """(npts, nfn) reference divergences (physical via ./detJ)."""
        pts = np.asarray(pts, float)
        D = _eval_generating_div(self.geom, self.k, self.exps_pk,
                                 self.exps_hom, pts)
        return np.einsum("fg,qg->qf", self.coeff, D)


def _eval_generating(geom, k, exps_pk, exps_hom, pts) -> np.ndarray:
    """(npts, ngen, dim) values of the generating set."""
    dim = pts.shape[1]
    nA = len(exps_pk)
    mono = _eval_mono(exps_pk, pts)  # (npts, nA)
    npts = len(pts)
    ngen = dim * nA + len(exps_hom)
    G = np.zeros((npts, ngen, dim))
    for d in range(dim):
        G[:, d * nA:(d + 1) * nA, d] = mono
    if len(exps_hom):
        mh = _eval_mono(exps_hom, pts)  # (npts, nB)
        for d in range(dim):
            G[:, dim * nA:, d] = mh * pts[:, d][:, None]
    return G


def _eval_generating_div(geom, k, exps_pk, exps_hom, pts) -> np.ndarray:
    """(npts, ngen) divergences of the generating set: div(m e_d) = d_d m,
    div(x m_hom) = (dim + |b|) m_hom."""
    dim = pts.shape[1]
    nA = len(exps_pk)
    npts = len(pts)
    ngen = dim * nA + len(exps_hom)
    D = np.zeros((npts, ngen))
    for d in range(dim):
        e = exps_pk.copy()
        coef = e[:, d].astype(float)
        e2 = e.copy()
        e2[:, d] = np.maximum(e2[:, d] - 1, 0)
        D[:, d * nA:(d + 1) * nA] = coef[None, :] * _eval_mono(e2, pts)
    if len(exps_hom):
        deg = exps_hom.sum(axis=1).astype(float)
        D[:, dim * nA:] = (dim + deg)[None, :] * _eval_mono(exps_hom, pts)
    return D


def _facets(geom: Geom):
    if geom is Geom.TET:
        return ref.GEOM_FACES[Geom.TET]
    if geom is Geom.TRI:
        return ref.GEOM_EDGES[Geom.TRI]
    raise NotImplementedError(f"RT space on {geom}")


@functools.lru_cache(maxsize=None)
def rt_basis_simplex(geom: Geom, k: int) -> RTBasisSimplex:
    verts = ref.GEOM_VERTICES[geom][:, : (3 if geom is Geom.TET else 2)]
    dim = verts.shape[1]
    exps_pk = _mono_exps(dim, k)
    exps_hom = _mono_exps(dim, k, homogeneous=True)
    ngen = dim * len(exps_pk) + len(exps_hom)

    facets = _facets(geom)
    fgeom = Geom.TRI if geom is Geom.TET else Geom.LINE
    fq_pts, fq_w = ref.quadrature(fgeom, 2 * k + 2)
    if fgeom is Geom.LINE:
        fq_pts = fq_pts.reshape(-1, 1)
    q_exps = _mono_exps(dim - 1, k)
    n_facet = len(q_exps)

    rows = []
    for fv in facets:
        vA = verts[fv[0]]
        t1 = verts[fv[1]] - vA
        if dim == 3:
            t2 = verts[fv[2]] - vA
            N = np.cross(t1, t2)
            X = vA[None, :] + fq_pts[:, :1] * t1 + fq_pts[:, 1:2] * t2
        else:
            N = np.array([t1[1], -t1[0]])
            X = vA[None, :] + fq_pts[:, :1] * t1
        G = _eval_generating(geom, k, exps_pk, exps_hom, X)
        flux = np.einsum("qgd,d->qg", G, N)  # (nq, ngen)
        qv = _eval_mono(q_exps, fq_pts)  # (nq, nmom)
        rows.append(np.einsum("q,qm,qg->mg", fq_w, qv, flux))
    # Interior moments against (P_{k-1})^d.
    n_int = 0
    if k >= 1:
        iq_pts, iq_w = ref.quadrature(geom, 2 * k + 2)
        i_exps = _mono_exps(dim, k - 1)
        G = _eval_generating(geom, k, exps_pk, exps_hom, iq_pts)
        mv = _eval_mono(i_exps, iq_pts)  # (nq, nim)
        for d in range(dim):
            rows.append(np.einsum("q,qm,qg->mg", iq_w, mv, G[:, :, d]))
        n_int = dim * len(i_exps)
    V = np.concatenate(rows, axis=0)
    assert V.shape == (ngen, ngen), (V.shape, ngen)
    coeff = np.linalg.inv(V).T  # rows = dual basis functions
    cond = np.linalg.cond(V)
    if cond > 1e12:
        raise RuntimeError(f"RT_{k} Vandermonde ill-conditioned ({cond:.1e})")
    return RTBasisSimplex(geom, k, exps_pk, exps_hom, coeff, n_facet, n_int)


class RTSpace:
    """Global conforming RT_k space on a canonicalized simplicial mesh.

    The physical field is v = J v_ref / det(J) (signed Piola); no
    orientation sign tables are needed (module docstring).
    """

    def __init__(self, mesh, k: int):
        self.mesh = mesh
        self.k = k
        self._bases = {}
        all_keys, shapes = [], []
        sign_blocks: List[Optional[np.ndarray]] = []
        geoms = {b.geom for b in mesh.buckets}
        if Geom.PRISM in geoms and len(geoms) > 1:
            # Prism face keys would alias tet tri-face / hex quad-face
            # variants built from different functional bases.
            raise NotImplementedError(
                "RT space on mixed prism + other-geometry meshes")
        for bi, b in enumerate(mesh.buckets):
            if b.geom is Geom.HEX:
                from palace_torch.fem import rt_hex

                keys, signs = rt_hex.hex_rt_keys_signs(
                    k, mesh.topo_ids(b.corners).astype(np.int64), bi)
                E, nd = signs.shape
                all_keys.append(keys.reshape(E * nd, 7))
                shapes.append((E, nd))
                sign_blocks.append(signs)
                continue
            if b.geom is Geom.PRISM:
                from palace_torch.fem import rt_prism

                corners = mesh.topo_ids(b.corners).astype(np.int64)
                keys, signs = rt_prism.prism_rt_keys_signs(k, corners, bi)
                E, nd = signs.shape
                all_keys.append(keys.reshape(E * nd, 7))
                shapes.append((E, nd))
                sign_blocks.append(None)
                continue
            if b.geom not in (Geom.TET, Geom.TRI):
                raise NotImplementedError(f"RT space on {b.geom}")
            basis = rt_basis_simplex(b.geom, k)
            self._bases[b.geom] = basis
            corners = mesh.topo_ids(b.corners).astype(np.int64)
            if not (np.diff(corners, axis=1) > 0).all():
                raise RuntimeError(
                    "RTSpace requires canonicalize_simplices(mesh) first")
            E = b.num_elem
            nd = basis.num_dofs
            keys = np.empty((E, nd, 7), np.int64)
            n = 0
            facets = _facets(b.geom)
            for fv in facets:
                for j in range(basis.n_facet):
                    if b.geom is Geom.TET:
                        ks = dofmap.tri_keys(
                            corners[:, list(fv)],
                            np.zeros((E, 3), np.int64),
                            variant=j, stride=0)
                        ks[:, 6] = j * 1000 + _RT_MARK
                    else:
                        ks = dofmap.edge_keys(
                            corners[:, fv[0]], corners[:, fv[1]],
                            np.zeros(E, np.int64), 1, variant=0)
                        ks[:, 5] = j
                        ks[:, 6] = _RT_MARK
                    keys[:, n] = ks
                    n += 1
            for j in range(basis.n_int):
                keys[:, n] = dofmap.interior_keys(
                    bi, np.arange(E), np.full(E, j))
                n += 1
            assert n == nd
            all_keys.append(keys.reshape(E * nd, 7))
            shapes.append((E, nd))
            sign_blocks.append(None)
        num, ids, uniq = dofmap.number_dofs(np.concatenate(all_keys, axis=0))
        self.num_dofs = num
        self.elem_dofs: List[np.ndarray] = []
        ofs = 0
        for (E, nd) in shapes:
            self.elem_dofs.append(ids[ofs:ofs + E * nd].reshape(E, nd))
            ofs += E * nd
        self.elem_signs = sign_blocks

    @property
    def order(self) -> int:
        return self.k + 1

    def basis_tables(self, geom: Geom, pts: np.ndarray) -> np.ndarray:
        """(nq, nd, dim) reference values (physical via J . / detJ)."""
        if geom is Geom.HEX:
            from palace_torch.fem import rt_hex

            return rt_hex.hex_rt_eval(self.k, np.asarray(pts, float))
        if geom is Geom.PRISM:
            from palace_torch.fem import rt_prism

            return rt_prism.prism_rt_eval(self.k, np.asarray(pts, float))
        return self._bases[geom].eval(np.asarray(pts, float))

    def div_tables(self, geom: Geom, pts: np.ndarray) -> np.ndarray:
        """(nq, nd) reference divergences (physical div = ./detJ under the
        signed Piola map)."""
        if geom is Geom.HEX:
            from palace_torch.fem import rt_hex

            return rt_hex.hex_rt_eval_div(self.k, np.asarray(pts, float))
        if geom is Geom.PRISM:
            from palace_torch.fem import rt_prism

            return rt_prism.prism_rt_eval_div(self.k, np.asarray(pts, float))
        if geom not in self._bases:
            self._bases[geom] = rt_basis_simplex(geom, self.k)
        return self._bases[geom].eval_div(np.asarray(pts, float))
