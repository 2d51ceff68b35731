"""Reference elements: geometries, quadrature, and nodal bases.

The TPU-native operator core is quadrature-point based (like the reference
solver's libCEED partial assembly, reference: palace/fem/libceed/basis.cpp,
palace/fem/qfunctions/): everything reduces to dense basis tables evaluated
at quadrature points on a small set of reference geometries, applied to all
elements of a bucket as one batched contraction.

Conventions:
- Reference coordinates live in [0,1]: unit simplices (tri/tet), the unit
  square/cube (quad/hex), and the unit prism (tri x [0,1]).
- Nodal bases are built generically by inverting a monomial Vandermonde
  matrix on the element's polynomial space, which supports arbitrary node
  layouts (Gmsh high-order geometry nodes, FEM lattice nodes) uniformly.

Copied from palace_tpu/fem/reference.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import enum
import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
from scipy.special import roots_jacobi, roots_legendre


class Geom(enum.Enum):
    POINT = "point"
    LINE = "line"
    TRI = "tri"
    QUAD = "quad"
    TET = "tet"
    HEX = "hex"
    PRISM = "prism"


GEOM_DIM = {
    Geom.POINT: 0,
    Geom.LINE: 1,
    Geom.TRI: 2,
    Geom.QUAD: 2,
    Geom.TET: 3,
    Geom.HEX: 3,
    Geom.PRISM: 3,
}

# Reference vertices (local vertex ordering matches Gmsh corner ordering).
GEOM_VERTICES = {
    Geom.LINE: np.array([[0.0], [1.0]]),
    Geom.TRI: np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    Geom.QUAD: np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
    Geom.TET: np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    ),
    Geom.HEX: np.array(
        [
            [0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [1.0, 1.0, 1.0], [0.0, 1.0, 1.0],
        ]
    ),
    Geom.PRISM: np.array(
        [
            [0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0],
        ]
    ),
}

# Canonical entity lists (local vertex tuples) used for FEM dof matching.
GEOM_EDGES = {
    Geom.LINE: [],
    Geom.TRI: [(0, 1), (0, 2), (1, 2)],
    Geom.QUAD: [(0, 1), (1, 2), (2, 3), (0, 3)],
    Geom.TET: [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
    Geom.HEX: [
        (0, 1), (1, 2), (2, 3), (0, 3),
        (4, 5), (5, 6), (6, 7), (4, 7),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ],
    Geom.PRISM: [
        (0, 1), (0, 2), (1, 2),
        (3, 4), (3, 5), (4, 5),
        (0, 3), (1, 4), (2, 5),
    ],
}

GEOM_FACES = {
    Geom.TET: [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)],
    Geom.HEX: [
        (0, 1, 2, 3), (4, 5, 6, 7),
        (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (0, 3, 7, 4),
    ],
    Geom.PRISM: [
        (0, 1, 2), (3, 4, 5),
        (0, 1, 4, 3), (1, 2, 5, 4), (0, 2, 5, 3),
    ],
    Geom.TRI: [],
    Geom.QUAD: [],
    Geom.LINE: [],
}


# ---------------------------------------------------------------------------
# Polynomial spaces (monomial exponent sets)


@functools.lru_cache(maxsize=None)
def monomials(geom: Geom, p: int) -> np.ndarray:
    """Exponent multi-indices spanning the geometry's order-p space."""
    if geom is Geom.LINE:
        return np.array([[a] for a in range(p + 1)], np.int32)
    if geom is Geom.TRI:
        return np.array(
            [[a, b] for a in range(p + 1) for b in range(p + 1 - a)], np.int32
        )
    if geom is Geom.QUAD:
        return np.array(
            [[a, b] for a in range(p + 1) for b in range(p + 1)], np.int32
        )
    if geom is Geom.TET:
        return np.array(
            [
                [a, b, c]
                for a in range(p + 1)
                for b in range(p + 1 - a)
                for c in range(p + 1 - a - b)
            ],
            np.int32,
        )
    if geom is Geom.HEX:
        return np.array(
            [
                [a, b, c]
                for a in range(p + 1)
                for b in range(p + 1)
                for c in range(p + 1)
            ],
            np.int32,
        )
    if geom is Geom.PRISM:
        return np.array(
            [
                [a, b, c]
                for a in range(p + 1)
                for b in range(p + 1 - a)
                for c in range(p + 1)
            ],
            np.int32,
        )
    raise ValueError(geom)


def eval_monomials(exps: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """V[i, j] = prod_d pts[i, d] ** exps[j, d]."""
    # (npts, 1, dim) ** (1, nmono, dim) -> product over dim
    return np.prod(pts[:, None, :] ** exps[None, :, :], axis=-1)


def eval_monomial_grads(exps: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """G[i, j, d] = d/dx_d of monomial j at point i."""
    npts, dim = pts.shape
    nm = exps.shape[0]
    G = np.empty((npts, nm, dim))
    for d in range(dim):
        e = exps.copy()
        coef = e[:, d].astype(float)
        e[:, d] = np.maximum(e[:, d] - 1, 0)
        G[:, :, d] = coef[None, :] * np.prod(
            pts[:, None, :] ** e[None, :, :], axis=-1
        )
    return G


# ---------------------------------------------------------------------------
# Nodal (Lagrange) bases via Vandermonde inversion


@dataclass
class NodalBasis:
    """Interpolatory basis on arbitrary nodes of an order-p space."""

    geom: Geom
    order: int
    nodes: np.ndarray  # (ndof, dim)
    coeff: np.ndarray  # (nmono, ndof): basis_j = sum_m coeff[m, j] * mono_m

    def eval(self, pts: np.ndarray) -> np.ndarray:
        """(npts, ndof) basis values."""
        return eval_monomials(monomials(self.geom, self.order), pts) @ self.coeff

    def eval_grad(self, pts: np.ndarray) -> np.ndarray:
        """(npts, ndof, dim) basis gradients."""
        G = eval_monomial_grads(monomials(self.geom, self.order), pts)
        return np.einsum("pmd,mn->pnd", G, self.coeff)


def nodal_basis(geom: Geom, order: int, nodes: np.ndarray) -> NodalBasis:
    exps = monomials(geom, order)
    if len(nodes) != len(exps):
        raise ValueError(
            f"{geom} order {order}: {len(nodes)} nodes != {len(exps)} monomials"
        )
    V = eval_monomials(exps, nodes)
    coeff = np.linalg.inv(V)
    return NodalBasis(geom, order, np.asarray(nodes, float), coeff)


# ---------------------------------------------------------------------------
# Lattice nodes (equispaced) for arbitrary-order Lagrange spaces


@functools.lru_cache(maxsize=None)
def lattice(geom: Geom, p: int) -> np.ndarray:
    """Equispaced order-p lattice nodes, one per basis function.

    The enumeration order matches :func:`lattice_multi_index`.
    """
    mi = lattice_multi_index(geom, p)
    return mi.astype(float) / max(p, 1)


@functools.lru_cache(maxsize=None)
def gauss_lobatto_1d(p: int) -> np.ndarray:
    """Closed Gauss-Lobatto points on [0, 1], p + 1 of them (the MFEM
    BasisType::GaussLobatto 1D point set)."""
    if p <= 1:
        return np.linspace(0.0, 1.0, max(p, 1) + 1)
    from scipy.special import roots_jacobi

    xi, _ = roots_jacobi(p - 1, 1.0, 1.0)
    return np.concatenate([[0.0], 0.5 * (xi + 1.0), [1.0]])


@functools.lru_cache(maxsize=None)
def fem_nodes(geom: Geom, p: int) -> np.ndarray:
    """Nodal placement of the order-p H1 Lagrange dofs: closed Gauss-Lobatto,
    matching MFEM's default H1_FECollection basis (reference FE node
    construction: mfem H1_TriangleElement/H1_TetrahedronElement place node
    (i, j, k) at cp[i]/w with w = sum of the barycentric cp's; tensor
    elements use the 1D product).  The PLACEMENT changes the discrete
    Dirichlet trace wherever boundary data is discontinuous (e.g. the
    terminal/ground junction of cavity2d electrostatic), so matching it is
    required for regression parity — the spanned space is unchanged.

    Enumeration order matches :func:`lattice_multi_index`.
    """
    mi = lattice_multi_index(geom, p)
    if p == 0:
        return lattice(geom, p)
    cp = gauss_lobatto_1d(p)
    if geom in (Geom.LINE, Geom.QUAD, Geom.HEX):
        return cp[mi]
    if geom in (Geom.TRI, Geom.TET):
        rem = p - mi.sum(axis=1)
        w = cp[mi].sum(axis=1) + cp[rem]
        return cp[mi] / w[:, None]
    return lattice(geom, p)


@functools.lru_cache(maxsize=None)
def lattice_multi_index(geom: Geom, p: int) -> np.ndarray:
    """Integer lattice multi-indices (ndof, dim) with entries in [0, p]."""
    if geom is Geom.LINE:
        out = [[i] for i in range(p + 1)]
    elif geom is Geom.TRI:
        out = [[i, j] for i in range(p + 1) for j in range(p + 1 - i)]
    elif geom is Geom.QUAD:
        out = [[i, j] for i in range(p + 1) for j in range(p + 1)]
    elif geom is Geom.TET:
        out = [
            [i, j, k]
            for i in range(p + 1)
            for j in range(p + 1 - i)
            for k in range(p + 1 - i - j)
        ]
    elif geom is Geom.HEX:
        out = [
            [i, j, k]
            for i in range(p + 1)
            for j in range(p + 1)
            for k in range(p + 1)
        ]
    elif geom is Geom.PRISM:
        out = [
            [i, j, k]
            for i in range(p + 1)
            for j in range(p + 1 - i)
            for k in range(p + 1)
        ]
    else:
        raise ValueError(geom)
    return np.array(out, np.int32)


# ---------------------------------------------------------------------------
# Quadrature


@functools.lru_cache(maxsize=None)
def quadrature(geom: Geom, order: int) -> Tuple[np.ndarray, np.ndarray]:
    """Quadrature rule exact for polynomials of the given total order.

    Tensor Gauss-Legendre on tensor-product geometries; collapsed
    Gauss-Jacobi (Duffy) on simplices, which is exact at any order.
    Returns (points (nq, dim), weights (nq,)); weights sum to the
    reference measure (1/2 tri, 1/6 tet, 1 quad/hex/line, 1/2 prism).
    """
    n = order // 2 + 1

    def gl01(nn):
        x, w = roots_legendre(nn)
        return (x + 1.0) / 2.0, w / 2.0

    def gj01(nn, alpha):
        # integral over [0,1] of (1-x)^alpha f(x)
        x, w = roots_jacobi(nn, alpha, 0.0)
        return (x + 1.0) / 2.0, w / 2.0 ** (alpha + 1)

    if geom is Geom.LINE:
        x, w = gl01(n)
        return x[:, None].copy(), w.copy()

    if geom is Geom.QUAD:
        x, w = gl01(n)
        X, Y = np.meshgrid(x, x, indexing="ij")
        W = np.outer(w, w)
        return np.stack([X.ravel(), Y.ravel()], -1), W.ravel()

    if geom is Geom.HEX:
        x, w = gl01(n)
        X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
        W = np.einsum("i,j,k->ijk", w, w, w)
        return np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1), W.ravel()

    if geom is Geom.TRI:
        # x = u (1 - y), y = v; Jacobian (1 - v) absorbed in GJ(1, 0).
        u, wu = gl01(n)
        v, wv = gj01(n, 1.0)
        U, V = np.meshgrid(u, v, indexing="ij")
        X = U * (1.0 - V)
        W = np.outer(wu, wv)
        return np.stack([X.ravel(), V.ravel()], -1), W.ravel()

    if geom is Geom.TET:
        # x = u (1 - v)(1 - w) rescaled collapse; Jacobian (1-b)(1-c)^2.
        a, wa = gl01(n)
        b, wb = gj01(n, 1.0)
        c, wc = gj01(n, 2.0)
        A, B, C = np.meshgrid(a, b, c, indexing="ij")
        X = A * (1.0 - B) * (1.0 - C)
        Y = B * (1.0 - C)
        Z = C
        W = np.einsum("i,j,k->ijk", wa, wb, wc)
        return np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1), W.ravel()

    if geom is Geom.PRISM:
        pt, wt = quadrature(Geom.TRI, order)
        z, wz = gl01(n)
        npt, nz = len(wt), len(wz)
        pts = np.concatenate(
            [
                np.repeat(pt, nz, axis=0),
                np.tile(z, npt)[:, None],
            ],
            axis=1,
        )
        W = np.repeat(wt, nz) * np.tile(wz, npt)
        return pts, W

    raise ValueError(geom)


# ---------------------------------------------------------------------------
# Gmsh geometry node layouts (reference coordinates per element type)

# Gmsh local orderings (MSH 2.2):
_GMSH_TET_EDGES = [(0, 1), (1, 2), (2, 0), (3, 0), (3, 2), (3, 1)]
_GMSH_TET_FACES = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
_GMSH_HEX_EDGES = [
    (0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (2, 3),
    (2, 6), (3, 7), (4, 5), (4, 7), (5, 6), (6, 7),
]
_GMSH_HEX_FACES = [
    (0, 3, 2, 1), (0, 1, 5, 4), (0, 4, 7, 3),
    (1, 2, 6, 5), (2, 3, 7, 6), (4, 5, 6, 7),
]
_GMSH_PRISM_EDGES = [
    (0, 1), (0, 2), (0, 3), (1, 2), (1, 4), (2, 5), (3, 4), (3, 5), (4, 5),
]
_GMSH_PRISM_QUAD_FACES = [(0, 1, 4, 3), (0, 3, 5, 2), (1, 2, 5, 4)]
_GMSH_QUAD_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0)]
_GMSH_TRI_EDGES = [(0, 1), (1, 2), (2, 0)]


def _mean(verts, idxs):
    return np.mean([verts[i] for i in idxs], axis=0)


def _edge_pts(verts, edges, per_edge):
    out = []
    for (a, b) in edges:
        for k in range(1, per_edge + 1):
            t = k / (per_edge + 1)
            out.append(verts[a] * (1 - t) + verts[b] * t)
    return out


@functools.lru_cache(maxsize=None)
def gmsh_node_coords(etype: int) -> Tuple[Geom, int, np.ndarray]:
    """(geometry, geometric order, reference coordinates of gmsh nodes)."""
    if etype in (1, 8, 26):  # line / line3 / line4
        v = GEOM_VERTICES[Geom.LINE]
        order = {1: 1, 8: 2, 26: 3}[etype]
        pts = [v[0], v[1]] + _edge_pts(v, [(0, 1)], order - 1)
        return Geom.LINE, order, np.array(pts)

    if etype in (2, 9, 21):  # tri3 / tri6 / tri10
        v = GEOM_VERTICES[Geom.TRI]
        order = {2: 1, 9: 2, 21: 3}[etype]
        pts = list(v) + _edge_pts(v, _GMSH_TRI_EDGES, order - 1)
        if etype == 21:
            pts.append(_mean(v, (0, 1, 2)))
        return Geom.TRI, order, np.array(pts)

    if etype in (3, 10):  # quad4 / quad9
        v = GEOM_VERTICES[Geom.QUAD]
        order = {3: 1, 10: 2}[etype]
        pts = list(v) + _edge_pts(v, _GMSH_QUAD_EDGES, order - 1)
        if etype == 10:
            pts.append(_mean(v, (0, 1, 2, 3)))
        return Geom.QUAD, order, np.array(pts)

    if etype in (4, 11, 29):  # tet4 / tet10 / tet20
        v = GEOM_VERTICES[Geom.TET]
        order = {4: 1, 11: 2, 29: 3}[etype]
        pts = list(v) + _edge_pts(v, _GMSH_TET_EDGES, order - 1)
        if etype == 29:
            pts += [_mean(v, f) for f in _GMSH_TET_FACES]
        return Geom.TET, order, np.array(pts)

    if etype in (5, 12):  # hex8 / hex27
        v = GEOM_VERTICES[Geom.HEX]
        order = {5: 1, 12: 2}[etype]
        pts = list(v) + _edge_pts(v, _GMSH_HEX_EDGES, order - 1)
        if etype == 12:
            pts += [_mean(v, f) for f in _GMSH_HEX_FACES]
            pts.append(_mean(v, tuple(range(8))))
        return Geom.HEX, order, np.array(pts)

    if etype in (6, 13):  # prism6 / prism18
        v = GEOM_VERTICES[Geom.PRISM]
        order = {6: 1, 13: 2}[etype]
        pts = list(v) + _edge_pts(v, _GMSH_PRISM_EDGES, order - 1)
        if etype == 13:
            pts += [_mean(v, f) for f in _GMSH_PRISM_QUAD_FACES]
        return Geom.PRISM, order, np.array(pts)

    if etype == 15:  # point
        return Geom.POINT, 0, np.zeros((1, 0))

    raise ValueError(f"unsupported gmsh element type {etype}")


@functools.lru_cache(maxsize=None)
def gmsh_geometry_basis(etype: int) -> NodalBasis:
    geom, order, nodes = gmsh_node_coords(etype)
    return nodal_basis(geom, order, nodes)
