"""Tensor-product Raviart-Thomas RT_k spaces on hexahedra (and quads).

The hex analog of fem/rt.py for flux-recovery error estimation on hex
meshes (reference: MFEM RT_FECollection on Geometry::CUBE used by
palace/linalg/errorestimator.cpp on hex meshes).  Nodal construction:

    f_{d,i,j,l} = n_i(x_d) m_j(x_u) m_l(x_v) e_d,   (u, v) cross axes,

n = closed degree-(k+1) 1D Lagrange (k+2 equispaced nodes incl. the
endpoints), m = open degree-k Lagrange at (j+1/2)/(k+1).  Normal traces on
faces are nodal at the symmetric open lattice, so face dofs transform
under the 8 quad-face orientations by a pure permutation with a det(R)
sign (the face handedness vs its sorted-corner canonical frame) — the
same variant machinery as the hex ND space (fem/nd_hex.py), no
DofTransformations.  Physical map: signed Piola v = J v_ref / det J.

Copied from palace_tpu/fem/rt_hex.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from palace_torch.fem import dofmap
from palace_torch.fem.nd_hex import Ladder1D, _orient_maps, _vert_at

_RT_MARK = 211  # same marker family as fem/rt.py


@functools.lru_cache(maxsize=None)
def _rt_ladders(k: int) -> Tuple[Ladder1D, Ladder1D]:
    n = Ladder1D(np.linspace(0.0, 1.0, k + 2))
    m = Ladder1D((np.arange(k + 1) + 0.5) / (k + 1))
    return n, m


@functools.lru_cache(maxsize=None)
def hex_rt_dofs(k: int) -> List[Tuple[int, int, int, int]]:
    """Local dof list [(d, i, j, l)]: normal family d, i in [0, k+1] along
    d (closed), (j, l) in [0, k]^2 over the cross axes ascending."""
    out = []
    for d in range(3):
        for i in range(k + 2):
            for j in range(k + 1):
                for l in range(k + 1):
                    out.append((d, i, j, l))
    return out


def hex_rt_eval(k: int, pts: np.ndarray) -> np.ndarray:
    """(nq, nd, 3) reference values on the unit cube."""
    n1, m1 = _rt_ladders(k)
    pts = np.asarray(pts, float)
    nq = len(pts)
    N = [n1.eval(pts[:, a]) for a in range(3)]
    M = [m1.eval(pts[:, a]) for a in range(3)]
    dofs = hex_rt_dofs(k)
    V = np.zeros((nq, len(dofs), 3))
    for t, (d, i, j, l) in enumerate(dofs):
        o = [a for a in range(3) if a != d]
        V[:, t, d] = N[d][:, i] * M[o[0]][:, j] * M[o[1]][:, l]
    return V


def hex_rt_eval_div(k: int, pts: np.ndarray) -> np.ndarray:
    """(nq, nd) reference divergences: div(n_i(x_d) m_j m_l e_d)
    = n'_i(x_d) m_j m_l."""
    n1, m1 = _rt_ladders(k)
    pts = np.asarray(pts, float)
    nq = len(pts)
    dN = [n1.deriv(pts[:, a]) for a in range(3)]
    M = [m1.eval(pts[:, a]) for a in range(3)]
    dofs = hex_rt_dofs(k)
    D = np.zeros((nq, len(dofs)))
    for t, (d, i, j, l) in enumerate(dofs):
        o = [a for a in range(3) if a != d]
        D[:, t] = dN[d][:, i] * M[o[0]][:, j] * M[o[1]][:, l]
    return D


@functools.lru_cache(maxsize=None)
def _hex_face_corners():
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
    return face_corners


def _rt_face_variant(k: int, gids: np.ndarray, j: int, l: int):
    """Canonical variant id + sign for a face-normal dof at open-lattice
    position (j, l) of the local (s, t) face frame; gids (E, 4) cyclic."""
    E = len(gids)
    r = np.argmin(gids, axis=1)
    nxt = gids[np.arange(E), (r + 1) % 4]
    prv = gids[np.arange(E), (r + 3) % 4]
    fwd = nxt < prv
    o = r * 2 + (~fwd).astype(np.int64)
    maps = _orient_maps()
    var = np.empty(E, np.int64)
    sgn = np.empty(E)
    st = (np.array([j + 0.5, l + 0.5])) / (k + 1)
    for oc in range(8):
        sel = o == oc
        if not sel.any():
            continue
        R, c = maps[oc]
        uv = R.T @ (st - c)  # inverse of (s,t) = R uv + c (R orthogonal)
        ju = int(np.floor(uv[0] * (k + 1)))
        jl = int(np.floor(uv[1] * (k + 1)))
        var[sel] = ju * (k + 1) + jl
        sgn[sel] = np.linalg.det(R)
    return var, sgn


def hex_rt_keys_signs(k: int, corners: np.ndarray, bucket_id: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Global keys (E, nd, 7) and signs (E, nd) for a hex bucket."""
    g = corners.astype(np.int64)
    E = g.shape[0]
    dofs = hex_rt_dofs(k)
    nd = len(dofs)
    keys = np.empty((E, nd, 7), np.int64)
    signs = np.ones((E, nd))
    fc = _hex_face_corners()
    interior_seen = 0
    for n, (d, i, j, l) in enumerate(dofs):
        if i in (0, k + 1):
            side = 0 if i == 0 else 1
            cl = fc[(d, side)]
            gids = g[:, cl]
            var, sgn = _rt_face_variant(k, gids, j, l)
            # Face-loop handedness: the corner loop runs counterclockwise
            # in the ascending (u, v) cross-axes frame, whose right-hand
            # normal is e_u x e_v = -e_1 for d == 1 (u, v) = (0, 2) but
            # +e_d for d in (0, 2).  The global dof sign is the basis'
            # +e_d flux against the canonical-loop normal det(R) eps e_d;
            # without eps, O-grid meshes that glue an x-face to a y-face
            # lose H(div) conformity (box meshes pair equal axes and never
            # see it).
            if d == 1:
                sgn = -sgn
            kk = np.full((E, 7), -1, np.int64)
            kk[:, 0] = dofmap.KIND_QUAD
            kk[:, 1:5] = np.sort(gids, axis=1)
            kk[:, 5] = var
            kk[:, 6] = _RT_MARK
            keys[:, n] = kk
            signs[:, n] = sgn
        else:
            keys[:, n] = dofmap.interior_keys(
                bucket_id, np.arange(E), np.full(E, interior_seen))
            interior_seen += 1
    return keys, signs
