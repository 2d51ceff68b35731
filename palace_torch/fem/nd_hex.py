"""H(curl) Nedelec basis on hexahedra (Q^-_p family) with global-orientation
conformity via per-(element, dof) signs and canonical entity keys.

The tensor-product basis is built from two 1D ladders on [0, 1]:
  - q: nodal Lagrange of degree p at p+1 equispaced points (value profile),
  - l: nodal Lagrange of degree p-1 at the p midpoints (i+1/2)/p
       (tangential profile).
Both node sets are reversal symmetric, so x -> 1-x maps basis functions to
pure index reversals (l_a -> l_{p-1-a}, q_b -> q_{p-b}); orientation
handling therefore reduces to index permutations plus tangential sign
flips — the diagonal subset of MFEM's DofTransformations, which is all
hexahedra need (reference: palace/fem/fespace.hpp:41-62; non-diagonal
transformations only arise for triangular faces).

Dof family d in {x, y, z}: phi = l_i(x_d) prod_{e != d} q_(j_e)(x_e) e_d.
Classification: both cross indices at endpoints -> edge dof; one -> face
dof; none -> interior.

Copied from palace_tpu/fem/nd_hex.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from palace_torch.fem import dofmap
from palace_torch.fem.reference import GEOM_VERTICES, Geom

HEX_VERTS = GEOM_VERTICES[Geom.HEX]  # (8, 3) in gmsh order


def _lagrange_coeffs(nodes: np.ndarray) -> np.ndarray:
    """Coefficient matrix C with basis_i(x) = sum_k C[k, i] x^k."""
    n = len(nodes)
    V = np.vander(nodes, n, increasing=True)  # V[i, k] = x_i^k
    return np.linalg.inv(V)


class Ladder1D:
    def __init__(self, nodes: np.ndarray):
        self.n = len(nodes)
        self.C = _lagrange_coeffs(np.asarray(nodes, float))

    def eval(self, x: np.ndarray) -> np.ndarray:
        V = np.vander(np.asarray(x, float), self.n, increasing=True)
        return V @ self.C  # (npts, n)

    def deriv(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, float)
        n = self.n
        D = np.zeros((len(x), n))
        for k in range(1, n):
            D += k * x[:, None] ** (k - 1) * self.C[k][None, :]
        return D


@functools.lru_cache(maxsize=None)
def _ladders(p: int) -> Tuple[Ladder1D, Ladder1D]:
    q = Ladder1D(np.linspace(0.0, 1.0, p + 1))
    l = Ladder1D((np.arange(p) + 0.5) / p)
    return q, l


@functools.lru_cache(maxsize=None)
def hex_nd_dofs(p: int) -> List[Tuple[int, int, int, int]]:
    """Local dof list [(d, i, j, k)]: d = direction family, i in [0,p-1]
    along d (l ladder), (j, k) in [0,p]^2 over the other two axes in
    increasing axis order (q ladder)."""
    out = []
    for d in range(3):
        for i in range(p):
            for j in range(p + 1):
                for k in range(p + 1):
                    out.append((d, i, j, k))
    return out


def hex_nd_eval(p: int, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(values (nq, nd, 3), curls (nq, nd, 3)) on the reference hex."""
    q, l = _ladders(p)
    pts = np.asarray(pts, float)
    nq = len(pts)
    Q = [q.eval(pts[:, a]) for a in range(3)]
    dQ = [q.deriv(pts[:, a]) for a in range(3)]
    Lv = [l.eval(pts[:, a]) for a in range(3)]
    dL = [l.deriv(pts[:, a]) for a in range(3)]
    dofs = hex_nd_dofs(p)
    nd = len(dofs)
    V = np.zeros((nq, nd, 3))
    C = np.zeros((nq, nd, 3))
    for n, (d, i, j, k) in enumerate(dofs):
        o = [a for a in range(3) if a != d]  # the two cross axes
        f = Lv[d][:, i] * Q[o[0]][:, j] * Q[o[1]][:, k]
        V[:, n, d] = f
        # curl(f e_d) = grad f x e_d
        gf = np.zeros((nq, 3))
        gf[:, d] = dL[d][:, i] * Q[o[0]][:, j] * Q[o[1]][:, k]
        gf[:, o[0]] = Lv[d][:, i] * dQ[o[0]][:, j] * Q[o[1]][:, k]
        gf[:, o[1]] = Lv[d][:, i] * Q[o[0]][:, j] * dQ[o[1]][:, k]
        ed = np.zeros(3)
        ed[d] = 1.0
        C[:, n] = np.cross(gf, ed[None, :])
    return V, C


# -- entity tables on the reference hex --------------------------------------

def _vert_at(coords) -> int:
    """Local vertex index at integer reference coords (0/1, 0/1, 0/1)."""
    for vi, v in enumerate(HEX_VERTS):
        if np.allclose(v, coords):
            return vi
    raise ValueError(coords)


@functools.lru_cache(maxsize=None)
def hex_nd_entities(p: int):
    """Per local dof: ('edge', (va, vb)) / ('face', face_axis, side, fam_axis,
    a, b) / ('interior', counter); plus face corner tables.

    For a face with constant axis `fa` at side s (0/1), the face plane is
    spanned by axes (u_ax, v_ax) = the two other axes in increasing order.
    Face corners in cyclic order (0,0), (1,0), (1,1), (0,1) of (u_ax, v_ax).
    """
    dofs = hex_nd_dofs(p)
    ents = []
    interior_count = 0
    for (d, i, j, k) in dofs:
        o = [a for a in range(3) if a != d]
        ends = []
        for (ax, idx) in ((o[0], j), (o[1], k)):
            if idx == 0:
                ends.append((ax, 0))
            elif idx == p:
                ends.append((ax, 1))
        if len(ends) == 2:
            # Edge along axis d from x_d=0 to x_d=1.
            c0 = np.zeros(3)
            c1 = np.zeros(3)
            c0[o[0]] = c1[o[0]] = ends[0][1]
            c0[o[1]] = c1[o[1]] = ends[1][1]
            c1[d] = 1.0
            ents.append(("edge", _vert_at(tuple(c0)), _vert_at(tuple(c1)), i))
        elif len(ends) == 1:
            fa, side = ends[0]
            uv = [a for a in range(3) if a != fa]
            # The dof direction d is one of the in-plane axes.
            fam = 0 if d == uv[0] else 1
            # In-plane profile indices: along d the l-index i; across, the
            # q index of the remaining in-plane axis.
            cross_ax = uv[1 - fam]
            cross_idx = {o[0]: j, o[1]: k}[cross_ax]
            ents.append(("face", fa, side, fam, i, cross_idx))
        else:
            ents.append(("interior", interior_count))
            interior_count += 1
    # Face corner local-vertex tables.
    face_corners = {}
    for fa in range(3):
        for side in (0, 1):
            uv = [a for a in range(3) if a != fa]
            corners = []
            for (us, vs) in ((0, 0), (1, 0), (1, 1), (0, 1)):
                c = np.zeros(3)
                c[fa] = side
                c[uv[0]] = us
                c[uv[1]] = vs
                corners.append(_vert_at(tuple(c)))
            face_corners[(fa, side)] = corners
    return ents, face_corners


def hex_nd_keys_signs(p: int, corners: np.ndarray, bucket_id: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Global keys (E, nd, 7) and signs (E, nd) for a hex bucket.

    corners: (E, 8) global vertex ids in gmsh order.
    """
    ents, face_corners = hex_nd_entities(p)
    E = corners.shape[0]
    nd = len(ents)
    keys = np.empty((E, nd, 7), np.int64)
    signs = np.ones((E, nd))
    g = corners.astype(np.int64)
    interior_seen = 0
    for n, ent in enumerate(ents):
        if ent[0] == "edge":
            _, va, vb, i = ent
            ga, gb = g[:, va], g[:, vb]
            flip = ga > gb
            var = np.where(flip, p - 1 - i, i)
            keys[:, n] = dofmap.edge_keys(
                np.minimum(ga, gb), np.maximum(ga, gb),
                np.zeros(E, np.int64), 1, variant=var)
            signs[:, n] = np.where(flip, -1.0, 1.0)
        elif ent[0] == "face":
            _, fa, side, fam, a, b = ent
            cl = face_corners[(fa, side)]
            gids = g[:, cl]  # (E, 4) cyclic order
            var, sgn = _face_variant(p, gids, fam, a, b)
            k = np.full((E, 7), -1, np.int64)
            k[:, 0] = dofmap.KIND_QUAD
            k[:, 1:5] = np.sort(gids, axis=1)
            k[:, 5] = var
            k[:, 6] = 101  # marker: ND quad-face dofs (vs H1 lattice keys)
            keys[:, n] = k
            signs[:, n] = sgn
        else:
            keys[:, n] = dofmap.interior_keys(
                bucket_id, np.arange(E), np.full(E, ent[1]))
    return keys, signs


@functools.lru_cache(maxsize=None)
def _orient_maps():
    """For each quad orientation code o = r*2 + (not fwd): the 2x2 signed
    permutation R and offsets c with (s, t) = R @ (u, v) + c on the unit
    square ((s,t) local face coords, (u,v) canonical coords)."""
    L = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    out = {}
    for r in range(4):
        for fwd in (True, False):
            o = r * 2 + (0 if fwd else 1)
            origin = L[r]
            nxt = L[(r + 1) % 4] - origin
            prv = L[(r + 3) % 4] - origin
            du, dv = (nxt, prv) if fwd else (prv, nxt)
            R = np.stack([du, dv], axis=1)  # columns: d(s,t)/du, d(s,t)/dv
            out[o] = (R, origin)
    return out


def _face_variant(p: int, gids: np.ndarray, fam: int, a: int, b: int):
    """Canonical variant id + sign for a local face dof.

    Local dof: vector along in-plane axis `fam` (0 = u_ax/s, 1 = v_ax/t),
    profile l_a along that axis, q_b across.  gids (E, 4): cyclic corners.
    """
    E = len(gids)
    r = np.argmin(gids, axis=1)
    nxt = gids[np.arange(E), (r + 1) % 4]
    prv = gids[np.arange(E), (r + 3) % 4]
    fwd = nxt < prv
    o = r * 2 + (~fwd).astype(np.int64)
    maps = _orient_maps()
    var = np.empty(E, np.int64)
    sgn = np.empty(E)
    npf = p * (p - 1)  # dofs per family per face
    for oc in range(8):
        sel = o == oc
        if not sel.any():
            continue
        R, _ = maps[oc]
        # Row `fam` of R gives the local coord (s or t) in terms of (u, v).
        row = R[fam]
        other = R[1 - fam]
        if row[0] != 0:
            # Local axis maps to canonical u: family u (0).
            cfam = 0
            alpha = a if row[0] > 0 else p - 1 - a
            beta = b if other[1] > 0 else p - b
            s = row[0]
        else:
            cfam = 1
            alpha = a if row[1] > 0 else p - 1 - a
            beta = b if other[0] > 0 else p - b
            s = row[1]
        var[sel] = cfam * npf + alpha * (p - 1) + (beta - 1)
        sgn[sel] = s
    return var, sgn


# -- 2D quadrilateral Nedelec (Q^-_p on quads) --------------------------------

QUAD_VERTS = GEOM_VERTICES[Geom.QUAD]  # (4, 2) in gmsh cyclic order


@functools.lru_cache(maxsize=None)
def quad_nd_dofs(p: int) -> List[Tuple[int, int, int]]:
    """Local dof list [(d, i, j)]: d = direction family, i in [0,p-1] along
    d (l ladder), j in [0,p] across (q ladder)."""
    return [(d, i, j)
            for d in range(2) for i in range(p) for j in range(p + 1)]


def quad_nd_eval(p: int, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(values (nq, nd, 2), scalar curls (nq, nd, 1)) on the reference quad
    (curl v = d_x v_y - d_y v_x)."""
    q, l = _ladders(p)
    pts = np.asarray(pts, float)
    nq = len(pts)
    Q = [q.eval(pts[:, a]) for a in range(2)]
    dQ = [q.deriv(pts[:, a]) for a in range(2)]
    Lv = [l.eval(pts[:, a]) for a in range(2)]
    dL = [l.deriv(pts[:, a]) for a in range(2)]
    dofs = quad_nd_dofs(p)
    nd = len(dofs)
    V = np.zeros((nq, nd, 2))
    C = np.zeros((nq, nd, 1))
    for n, (d, i, j) in enumerate(dofs):
        o = 1 - d
        V[:, n, d] = Lv[d][:, i] * Q[o][:, j]
        # curl(f e_x) = -d_y f ; curl(f e_y) = +d_x f
        df_cross = Lv[d][:, i] * dQ[o][:, j]
        C[:, n, 0] = df_cross if d == 1 else -df_cross
    return V, C


def _quad_vert_at(coords) -> int:
    for vi, v in enumerate(QUAD_VERTS):
        if np.allclose(v, coords):
            return vi
    raise ValueError(coords)


@functools.lru_cache(maxsize=None)
def quad_nd_entities(p: int):
    """Per local dof: ('edge', va, vb, i) or ('interior', counter)."""
    ents = []
    interior_count = 0
    for (d, i, j) in quad_nd_dofs(p):
        o = 1 - d
        if j in (0, p):
            side = 0 if j == 0 else 1
            c0 = np.zeros(2)
            c1 = np.zeros(2)
            c0[o] = c1[o] = side
            c1[d] = 1.0
            ents.append(("edge", _quad_vert_at(tuple(c0)),
                         _quad_vert_at(tuple(c1)), i))
        else:
            ents.append(("interior", interior_count))
            interior_count += 1
    return ents


def quad_nd_keys_signs(p: int, corners: np.ndarray, bucket_id: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Global keys (E, nd, 7) and signs (E, nd) for a 2D quad bucket
    (corners (E, 4) global vertex ids in gmsh cyclic order).  Edge flips
    reduce to index reversal + tangential sign, as for hexahedra."""
    ents = quad_nd_entities(p)
    E = corners.shape[0]
    nd = len(ents)
    keys = np.empty((E, nd, 7), np.int64)
    signs = np.ones((E, nd))
    g = corners.astype(np.int64)
    for n, ent in enumerate(ents):
        if ent[0] == "edge":
            _, va, vb, i = ent
            ga, gb = g[:, va], g[:, vb]
            flip = ga > gb
            var = np.where(flip, p - 1 - i, i)
            keys[:, n] = dofmap.edge_keys(
                np.minimum(ga, gb), np.maximum(ga, gb),
                np.zeros(E, np.int64), 1, variant=var)
            signs[:, n] = np.where(flip, -1.0, 1.0)
        else:
            keys[:, n] = dofmap.interior_keys(
                bucket_id, np.arange(E), np.full(E, ent[1]))
    return keys, signs
