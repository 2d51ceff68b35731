"""First-kind Nedelec H(curl) elements on (triangular) prisms / wedges.

Tensor construction (the standard de Rham-compatible wedge space,
reference FE collection: palace/fem/libceed/ceed.cpp:119-144 ND wedge):

  - in-plane family:  (u_m(x, y), 0) q_j(z),  u_m the 2D canonical-triangle
    Nedelec basis (fem/nd.py nd_basis_tri, Bernstein-Whitney), q_j the
    closed order-p nodal ladder on [0, 1];
  - vertical family:  (0, 0, psi_m(x, y) l_i(z)),  psi_m the order-p H1
    triangle basis on Gauss-Lobatto nodes, l_i the p-point interior ladder
    (fem/nd_hex.py ladders).

Conformity WITHOUT DofTransformations: elements are *in-plane
canonicalized* (mesh/mesh.py canonicalize_prisms permutes each wedge's
triangle columns so bottom vertex ids ascend, verifying the induced top
order also ascends — true for extruded/layered meshes), so tri-face and
horizontal-edge dofs live on ascending-vertex triangles exactly like the
tet path and need no sign tables; vertical edges keep a +-1 flip sign and
ladder reversal (like hex edges, fem/nd_hex.py); quad-face dof variants
are consistent because both neighbors order the shared columns by the same
global ids.  Mixed prism+hex meshes would alias quad-face variants and are
rejected in fem/nd.py.

Copied from palace_tpu/fem/nd_prism.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from palace_torch.fem import dofmap
from palace_torch.fem import reference as ref
from palace_torch.fem.nd import eval_nd_basis, nd_basis_tri
from palace_torch.fem.nd_hex import _ladders
from palace_torch.fem.reference import Geom


@functools.lru_cache(maxsize=None)
def _tri_h1_basis(p: int):
    return ref.nodal_basis(Geom.TRI, p, ref.fem_nodes(Geom.TRI, p))


@functools.lru_cache(maxsize=None)
def _tri_h1_node_class(p: int):
    """Classify the H1 triangle nodes: ('vertex', v) / ('edge', (a, b), w)
    with w in 1..p-1 measured from a / ('interior', c)."""
    mi = ref.lattice_multi_index(Geom.TRI, p)  # (n, 2) lattice (i, j)
    out = []
    interior = 0
    for (i, j) in ((int(a), int(b)) for a, b in mi):
        w0 = p - i - j
        if (i, j) == (0, 0):
            out.append(("vertex", 0, 0))
        elif (i, j) == (p, 0):
            out.append(("vertex", 1, 0))
        elif (i, j) == (0, p):
            out.append(("vertex", 2, 0))
        elif j == 0:
            out.append(("edge", (0, 1), i))
        elif i == 0:
            out.append(("edge", (0, 2), j))
        elif w0 == 0:
            out.append(("edge", (1, 2), j))
        else:
            out.append(("interior", interior, 0))
            interior += 1
    return tuple(out)


@functools.lru_cache(maxsize=None)
def prism_nd_layout(p: int):
    """Structural list of local dofs: ('ip', tri_fn_index, j_level) and
    ('v', h1_node_index, i_ladder)."""
    fns = nd_basis_tri(p)
    out = []
    for m in range(len(fns)):
        for j in range(p + 1):
            out.append(("ip", m, j))
    nh1 = (p + 1) * (p + 2) // 2
    for m in range(nh1):
        for i in range(p):
            out.append(("v", m, i))
    return tuple(out)


def prism_nd_num_dofs(p: int) -> int:
    return p * (p + 2) * (p + 1) + (p + 1) * (p + 2) // 2 * p


def prism_nd_eval(p: int, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(values (nq, nd, 3), curls (nq, nd, 3)) on the reference wedge
    (canonical ascending in-plane triangle x [0, 1])."""
    pts = np.asarray(pts, float)
    nq = len(pts)
    xy, z = pts[:, :2], pts[:, 2]
    fns = nd_basis_tri(p)
    Vt, Ct = eval_nd_basis(fns, xy, 3)  # (nq, nt, 2), (nq, nt, 1)
    h1 = _tri_h1_basis(p)
    P = h1.eval(xy)  # (nq, nh1)
    G = h1.eval_grad(xy)  # (nq, nh1, 2)
    q, l = _ladders(p)
    Q, dQ = q.eval(z), q.deriv(z)
    L, dL = l.eval(z), l.deriv(z)

    layout = prism_nd_layout(p)
    nd = len(layout)
    V = np.zeros((nq, nd, 3))
    C = np.zeros((nq, nd, 3))
    for n, (fam, m, j) in enumerate(layout):
        if fam == "ip":
            # (u q, 0): curl = (-u_y q', u_x q', curl2d(u) q)
            V[:, n, 0] = Vt[:, m, 0] * Q[:, j]
            V[:, n, 1] = Vt[:, m, 1] * Q[:, j]
            C[:, n, 0] = -Vt[:, m, 1] * dQ[:, j]
            C[:, n, 1] = Vt[:, m, 0] * dQ[:, j]
            C[:, n, 2] = Ct[:, m, 0] * Q[:, j]
        else:
            # (0, 0, psi l): curl = (psi_y l, -psi_x l, 0)
            V[:, n, 2] = P[:, m] * L[:, j]
            C[:, n, 0] = G[:, m, 1] * L[:, j]
            C[:, n, 1] = -G[:, m, 0] * L[:, j]
    return V, C


def prism_nd_keys_signs(p: int, corners: np.ndarray, bucket_id: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Global keys (E*nd, 7) and signs (E, nd) for an in-plane-canonicalized
    prism bucket; corners (E, 6) = [b0 b1 b2 t0 t1 t2] with b ascending."""
    g = corners.astype(np.int64)
    E = g.shape[0]
    layout = prism_nd_layout(p)
    nd = len(layout)
    fns = nd_basis_tri(p)
    ncls = _tri_h1_node_class(p)
    keys = np.empty((E, nd, 7), np.int64)
    signs = np.ones((E, nd))
    interior_seen = 0
    zeros = np.zeros(E, np.int64)
    n_ip_edge = p  # tri-ND edge variants per edge
    for n, (fam, m, j) in enumerate(layout):
        if fam == "ip":
            fn = fns[m]
            if j in (0, p):
                layer = 0 if j == 0 else 3
                if fn.kind == dofmap.KIND_EDGE:
                    a, b = fn.verts
                    keys[:, n] = dofmap.edge_keys(
                        g[:, layer + a], g[:, layer + b], zeros, 1,
                        variant=fn.variant)
                else:  # tri-face interior
                    keys[:, n] = dofmap.tri_keys(
                        g[:, layer:layer + 3], np.zeros((E, 3), np.int64),
                        variant=fn.variant)
            else:
                if fn.kind == dofmap.KIND_EDGE:
                    a, b = fn.verts
                    quad = np.stack([g[:, a], g[:, b], g[:, 3 + b],
                                     g[:, 3 + a]], axis=1)
                    k = np.full((E, 7), -1, np.int64)
                    k[:, 0] = dofmap.KIND_QUAD
                    k[:, 1:5] = np.sort(quad, axis=1)
                    k[:, 5] = fn.variant * (p - 1) + (j - 1)
                    k[:, 6] = 101  # shared marker with hex quad faces
                    keys[:, n] = k
                else:
                    keys[:, n] = dofmap.interior_keys(
                        bucket_id, np.arange(E), np.full(E, interior_seen))
                    interior_seen += 1
        else:
            kind, ent, w = ncls[m]
            if kind == "vertex":
                ga, gb = g[:, ent], g[:, 3 + ent]
                flip = ga > gb
                var = np.where(flip, p - 1 - j, j)
                keys[:, n] = dofmap.edge_keys(
                    np.minimum(ga, gb), np.maximum(ga, gb), zeros, 1,
                    variant=var)
                signs[:, n] = np.where(flip, -1.0, 1.0)
            elif kind == "edge":
                a, b = ent
                quad = np.stack([g[:, a], g[:, b], g[:, 3 + b],
                                 g[:, 3 + a]], axis=1)
                k = np.full((E, 7), -1, np.int64)
                k[:, 0] = dofmap.KIND_QUAD
                k[:, 1:5] = np.sort(quad, axis=1)
                k[:, 5] = (p * (p - 1)  # after the in-plane block
                           + (w - 1) * p + j)
                k[:, 6] = 101
                keys[:, n] = k
            else:
                keys[:, n] = dofmap.interior_keys(
                    bucket_id, np.arange(E), np.full(E, interior_seen))
                interior_seen += 1
    return keys, signs
