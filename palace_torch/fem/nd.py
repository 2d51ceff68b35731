"""H(curl)-conforming Nedelec spaces (first kind) on tetrahedra.

The TPU-native replacement for MFEM's ND spaces + DofTransformations
(reference: palace/fem/fespace.hpp:41-62, palace/fem/libceed/restriction.cpp):
after :func:`palace_torch.mesh.mesh.canonicalize_simplices` every tet lists its
vertices in increasing global order, so basis functions built on sorted
barycentric coordinates are automatically conforming across elements — no
orientation signs or dof transformation matrices exist anywhere.

Basis functions are represented symbolically as sums of terms
``coef * lambda^alpha * grad(lambda_g)`` (the Arnold-Falk-Winther geometric
decomposition of the P^-_p Lambda^1 family), which gives exact reference
values and curls at arbitrary points for any order.

Copied from palace_tpu/fem/nd.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from palace_torch.fem import dofmap, reference as ref
from palace_torch.fem.reference import Geom
from palace_torch.mesh.mesh import Mesh

# Reference barycentric gradients for the unit tet (columns are grad lambda_i).
_TET_DLAM = np.array(
    [[-1.0, 1.0, 0.0, 0.0], [-1.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 1.0]]
).T  # (4, 3): row i = grad lambda_i
_TRI_DLAM = np.array([[-1.0, 1.0, 0.0], [-1.0, 0.0, 1.0]]).T  # (3, 2)


def _lam(pts: np.ndarray, nvert: int) -> np.ndarray:
    """Barycentric values (npts, nvert)."""
    return np.concatenate([1.0 - pts.sum(axis=1, keepdims=True), pts], axis=1)


@dataclass
class Term:
    coef: float
    alpha: Tuple[int, ...]  # lambda exponents
    g: int  # gradient index


@dataclass
class NDBasisFn:
    terms: List[Term]
    kind: int  # dofmap.KIND_EDGE / KIND_TRI / KIND_INTERIOR
    verts: Tuple[int, ...]  # entity local vertices (sorted)
    variant: int


def _W(a: int, b: int, nv: int) -> List[Term]:
    """Whitney edge function lambda_a grad lambda_b - lambda_b grad lambda_a."""
    ea = tuple(1 if i == a else 0 for i in range(nv))
    eb = tuple(1 if i == b else 0 for i in range(nv))
    return [Term(1.0, ea, b), Term(-1.0, eb, a)]


def _scale_terms(terms: List[Term], idx: int, nv: int) -> List[Term]:
    """Multiply a term list by lambda_idx."""
    out = []
    for t in terms:
        alpha = list(t.alpha)
        alpha[idx] += 1
        out.append(Term(t.coef, tuple(alpha), t.g))
    return out


def _grad_prod(a: int, b: int, nv: int) -> List[Term]:
    """grad(lambda_a lambda_b) = lambda_a grad lambda_b + lambda_b grad lambda_a."""
    ea = tuple(1 if i == a else 0 for i in range(nv))
    eb = tuple(1 if i == b else 0 for i in range(nv))
    return [Term(1.0, ea, b), Term(1.0, eb, a)]


@functools.lru_cache(maxsize=None)
def _multi_indices(vars_: Tuple[int, ...], total: int, nv: int,
                   min_on: Tuple[int, ...] = ()) -> List[Tuple[int, ...]]:
    """All exponent tuples over `nv` slots supported on vars_ with |alpha| =
    total and alpha >= 1 on each slot in min_on (lexicographic order)."""
    out = []

    def rec(pos, remaining, cur):
        if pos == len(vars_):
            if remaining == 0:
                out.append(tuple(cur))
            return
        v = vars_[pos]
        lo = 1 if v in min_on else 0
        for k in range(lo, remaining + 1):
            nxt = list(cur)
            nxt[v] = k
            rec(pos + 1, remaining - k, nxt)

    rec(0, total, [0] * nv)
    return out


def _mono_terms(alpha: Tuple[int, ...], w_terms: List[Term]) -> List[Term]:
    """lambda^alpha * (Whitney terms)."""
    return [Term(t.coef, tuple(a + b for a, b in zip(alpha, t.alpha)), t.g)
            for t in w_terms]


def nd_basis_tet(p: int) -> Tuple[NDBasisFn, ...]:
    """First-kind Nedelec (P^-_p Lambda^1) basis on the sorted-vertex
    reference tet at arbitrary order, using the Bernstein-Whitney geometric
    decomposition: every function is lambda^alpha W_ab with

      - edge (a,b): supp(alpha) in {a,b}, |alpha| = p-1        (p per edge)
      - face (a,b,c): families W_ab (alpha_c >= 1) and W_ac (alpha_b >= 1),
        supp(alpha) in {a,b,c}, |alpha| = p-1          (p(p-1) per face)
      - interior: families W_01, W_02, W_03 with alpha >= 1 on both
        complementary vertices, |alpha| = p-1       (p(p-1)(p-2)/2 total)

    Tangential-trace locality of each group is guaranteed by the vanishing
    of W_ab's tangential trace on entities not containing edge (a,b)
    (Arnold-Falk-Winther geometric decomposition; Ainsworth-Fu
    Bernstein-Bezier bases for Whitney forms).
    """
    nv = 4
    edges = ref.GEOM_EDGES[Geom.TET]
    faces = ref.GEOM_FACES[Geom.TET]
    fns: List[NDBasisFn] = []
    if p < 1:
        raise ValueError("ND order must be >= 1")
    for (a, b) in edges:
        W = _W(a, b, nv)
        for v, alpha in enumerate(_multi_indices((a, b), p - 1, nv)):
            fns.append(NDBasisFn(_mono_terms(alpha, W), dofmap.KIND_EDGE,
                                 (a, b), v))
    for (a, b, c) in faces:
        v = 0
        for (x, y, third) in ((a, b, c), (a, c, b)):
            W = _W(x, y, nv)
            for alpha in _multi_indices((a, b, c), p - 1, nv,
                                        min_on=(third,)):
                fns.append(NDBasisFn(_mono_terms(alpha, W), dofmap.KIND_TRI,
                                     (a, b, c), v))
                v += 1
    for (x, y) in ((0, 1), (0, 2), (0, 3)):
        comp = tuple(sorted(set(range(4)) - {x, y}))
        W = _W(x, y, nv)
        for alpha in _multi_indices((0, 1, 2, 3), p - 1, nv, min_on=comp):
            fns.append(NDBasisFn(_mono_terms(alpha, W),
                                 dofmap.KIND_INTERIOR, (), 0))
    return tuple(fns)


def nd_num_dofs_tet(p: int) -> int:
    return p * (p + 2) * (p + 3) // 2


def eval_nd_basis(fns: Sequence[NDBasisFn], pts: np.ndarray, nvert: int = 4):
    """(values (npts, nfn, dim), curls (npts, nfn, dim)) on the reference tet."""
    dlam = _TET_DLAM if nvert == 4 else _TRI_DLAM
    lam = _lam(pts, nvert)
    npts = len(pts)
    dim = dlam.shape[1]
    vals = np.zeros((npts, len(fns), dim))
    curls = np.zeros((npts, len(fns), 3 if dim == 3 else 1))
    for j, fn in enumerate(fns):
        for t in fn.terms:
            mono = np.ones(npts)
            for i, a in enumerate(t.alpha):
                if a:
                    mono = mono * lam[:, i] ** a
            vals[:, j] += t.coef * mono[:, None] * dlam[t.g][None, :]
            # curl(mono * dlam_g) = grad(mono) x dlam_g
            gmono = np.zeros((npts, dim))
            for i, a in enumerate(t.alpha):
                if a:
                    m2 = np.ones(npts) * a
                    for i2, a2 in enumerate(t.alpha):
                        aa = a2 - (1 if i2 == i else 0)
                        if aa > 0:
                            m2 = m2 * lam[:, i2] ** aa
                    gmono += m2[:, None] * dlam[i][None, :]
            if dim == 3:
                curls[:, j] += t.coef * np.cross(gmono, dlam[t.g][None, :])
            else:
                curls[:, j, 0] += t.coef * (
                    gmono[:, 0] * dlam[t.g][1] - gmono[:, 1] * dlam[t.g][0]
                )
    return vals, curls


@functools.lru_cache(maxsize=None)
def nd_basis_tri(p: int) -> Tuple[NDBasisFn, ...]:
    """2D first-kind Nedelec basis on the sorted-vertex reference triangle
    at arbitrary order (Bernstein-Whitney, see nd_basis_tet)."""
    nv = 3
    edges = ref.GEOM_EDGES[Geom.TRI]
    fns: List[NDBasisFn] = []
    for (a, b) in edges:
        W = _W(a, b, nv)
        for v, alpha in enumerate(_multi_indices((a, b), p - 1, nv)):
            fns.append(NDBasisFn(_mono_terms(alpha, W), dofmap.KIND_EDGE,
                                 (a, b), v))
    v = 0
    for (x, y, third) in ((0, 1, 2), (0, 2, 1)):
        W = _W(x, y, nv)
        for alpha in _multi_indices((0, 1, 2), p - 1, nv, min_on=(third,)):
            fns.append(NDBasisFn(_mono_terms(alpha, W), dofmap.KIND_TRI,
                                 (0, 1, 2), v))
            v += 1
    return tuple(fns)


class NDSpace:
    """H(curl) space on (sorted-simplex) meshes.  Tets in 3D, tris in 2D."""

    def __init__(self, mesh: Mesh, order: int):
        self.mesh = mesh
        self.order = order
        all_keys = []
        shapes = []
        sign_blocks = []
        self._fns: Dict[Geom, Tuple[NDBasisFn, ...]] = {}
        for bid, b in enumerate(mesh.buckets):
            if b.geom in (Geom.HEX, Geom.QUAD):
                from palace_torch.fem import nd_hex

                fn = (nd_hex.hex_nd_keys_signs if b.geom is Geom.HEX
                      else nd_hex.quad_nd_keys_signs)
                keys, signs = fn(
                    order, mesh.topo_ids(b.corners).astype(np.int64), bid)
                E, nd = signs.shape
                all_keys.append(keys.reshape(E * nd, 7))
                shapes.append((E, nd))
                sign_blocks.append(signs)
                continue
            if b.geom is Geom.PRISM:
                from palace_torch.fem import nd_prism

                geoms = {bb.geom for bb in mesh.buckets}
                if Geom.HEX in geoms:
                    raise NotImplementedError(
                        "mixed prism + hex meshes alias quad-face dof "
                        "variants (fem/nd_prism.py)")
                keys, signs = nd_prism.prism_nd_keys_signs(
                    order, mesh.topo_ids(b.corners).astype(np.int64), bid)
                E, nd = signs.shape
                all_keys.append(keys.reshape(E * nd, 7))
                shapes.append((E, nd))
                sign_blocks.append(signs)
                continue
            if b.geom is Geom.TET:
                fns = nd_basis_tet(order)
            elif b.geom is Geom.TRI:
                fns = nd_basis_tri(order)
            else:
                raise NotImplementedError(
                    f"ND space on {b.geom} requires the tensor-product path "
                    "(prism Nedelec lands with the wedge kernels)"
                )
            self._fns[b.geom] = fns
            corners = mesh.topo_ids(b.corners).astype(np.int64)
            if not (np.diff(corners, axis=1) > 0).all():
                raise RuntimeError(
                    "NDSpace requires canonicalize_simplices(mesh) first"
                )
            E = b.num_elem
            keys = np.empty((E, len(fns), 7), np.int64)
            interior_count = 0
            for n, fn in enumerate(fns):
                if fn.kind == dofmap.KIND_EDGE:
                    a, bb = fn.verts
                    keys[:, n] = dofmap.edge_keys(
                        corners[:, a], corners[:, bb],
                        np.zeros(E, np.int64), 1, variant=fn.variant,
                    )
                elif fn.kind == dofmap.KIND_TRI:
                    vids = corners[:, list(fn.verts)]
                    keys[:, n] = dofmap.tri_keys(
                        vids, np.zeros((E, 3), np.int64), variant=fn.variant
                    )
                else:
                    keys[:, n] = dofmap.interior_keys(
                        bid, np.arange(E), np.full(E, interior_count)
                    )
                    interior_count += 1
            all_keys.append(keys.reshape(E * len(fns), 7))
            shapes.append((E, len(fns)))
            sign_blocks.append(None)
        cat = np.concatenate(all_keys)
        self.num_dofs, ids, self.unique_keys = dofmap.number_dofs(cat)
        self.elem_dofs: List[np.ndarray] = []
        self.elem_signs: List[np.ndarray | None] = sign_blocks
        ofs = 0
        for (E, nd) in shapes:
            self.elem_dofs.append(ids[ofs : ofs + E * nd].reshape(E, nd))
            ofs += E * nd

    def basis_tables(self, geom: Geom, pts: np.ndarray):
        if geom is Geom.HEX:
            from palace_torch.fem import nd_hex

            return nd_hex.hex_nd_eval(self.order, pts)
        if geom is Geom.PRISM:
            from palace_torch.fem import nd_prism

            return nd_prism.prism_nd_eval(self.order, pts)
        if geom is Geom.QUAD:
            from palace_torch.fem import nd_hex

            return nd_hex.quad_nd_eval(self.order, pts)
        fns = self._fns[geom]
        nvert = 4 if geom is Geom.TET else 3
        return eval_nd_basis(fns, pts, nvert)

    def boundary_dofs(self, attrs: Sequence[int]) -> np.ndarray:
        """Dofs with nonzero tangential trace on the given boundary attrs
        (edge and face dofs of those facets) — the PEC essential set."""
        attrs = set(int(a) for a in attrs)
        p = self.order
        found = []
        for b in self.mesh.bdr_buckets:
            if b.geom not in (Geom.TRI, Geom.LINE, Geom.QUAD):
                continue
            sel = np.isin(b.attr, list(attrs))
            if not sel.any():
                continue
            corners = self.mesh.topo_ids(b.corners[sel]).astype(np.int64)
            E = corners.shape[0]
            keys = []
            if b.geom is Geom.QUAD:
                # Hex-face trace: p dofs per edge + 2 p (p-1) face dofs.
                for (a, bb) in ((0, 1), (1, 2), (2, 3), (0, 3)):
                    ga, gb = corners[:, a], corners[:, bb]
                    for v in range(p):
                        keys.append(dofmap.edge_keys(
                            np.minimum(ga, gb), np.maximum(ga, gb),
                            np.zeros(E, np.int64), 1, variant=v))
                for v in range(2 * p * (p - 1)):
                    k = np.full((E, 7), -1, np.int64)
                    k[:, 0] = dofmap.KIND_QUAD
                    k[:, 1:5] = np.sort(corners[:, :4], axis=1)
                    k[:, 5] = v
                    k[:, 6] = 101
                    keys.append(k)
                kcat = np.concatenate(keys)
                ids = dofmap.lookup_keys(self.unique_keys, kcat)
                found.append(ids[ids >= 0])
                continue
            if b.geom is Geom.LINE:
                # 2D mesh: the facet is a single edge with p dofs.
                for v in range(p):
                    keys.append(dofmap.edge_keys(
                        np.minimum(corners[:, 0], corners[:, 1]),
                        np.maximum(corners[:, 0], corners[:, 1]),
                        np.zeros(E, np.int64), 1, variant=v))
            else:
                for (a, bb) in ref.GEOM_EDGES[Geom.TRI]:
                    for v in range(p):
                        keys.append(dofmap.edge_keys(
                            corners[:, a], corners[:, bb],
                            np.zeros(E, np.int64), 1, variant=v))
                if p >= 2:
                    for v in range(p * (p - 1)):
                        keys.append(dofmap.tri_keys(
                            corners, np.zeros((E, 3), np.int64), variant=v))
            k = np.concatenate(keys)
            ids = dofmap.lookup_keys(self.unique_keys, k)
            found.append(ids[ids >= 0])
        if not found:
            return np.zeros(0, np.int32)
        return np.unique(np.concatenate(found)).astype(np.int32)
