"""Plain NumPy/SciPy H(curl) discretization on hex meshes: the benchmark's
reference for the operators, loads and energies of a driven solve.

The discrete space is the one whose coefficient vectors the program under
test returns, so its dof layout is fixed here once, frozen:

- the reference-element basis (Q^-_p Nedelec): family d in {x, y, z},
  phi = l_i(x_d) q_j(x_a) q_k(x_b) e_d with (a, b) the other two axes in
  increasing order, l the Lagrange basis of degree p - 1 at the midpoints
  (i + 1/2) / p and q the Lagrange basis of degree p at p + 1 equispaced
  points on [0, 1]; local dofs in (d, i, j, k) order;
- the global numbering: each dof gets a key from the global vertex ids of
  the entity it lies on (edge, quad face, interior) and its canonically
  oriented index there, and dofs are numbered in the sorted order of the
  unique keys; the orientation sign flips the tangential direction where
  an edge or face runs against its canonical orientation.

Everything else (quadrature, geometry, coefficients, assembly, the point
load, the energies) is worked out here from the mesh and the configuration
alone.  The module imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import scipy.sparse as sp

#: Gmsh hex vertex coordinates on the reference cube [0, 1]^3.
HEX_VERTS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)

_EDGE, _QUAD, _INTERIOR = 1, 3, 4


def _lagrange(nodes):
    """Coefficients C with basis_i(x) = sum_k C[k, i] x^k."""
    return np.linalg.inv(np.vander(np.asarray(nodes, float), len(nodes),
                                   increasing=True))


def _poly(C, x):
    return np.vander(np.asarray(x, float), C.shape[0], increasing=True) @ C


def _dpoly(C, x):
    x = np.asarray(x, float)
    D = np.zeros((len(x), C.shape[1]))
    for k in range(1, C.shape[0]):
        D += k * x[:, None] ** (k - 1) * C[k][None, :]
    return D


@lru_cache(maxsize=None)
def local_dofs(p: int):
    return [(d, i, j, k) for d in range(3) for i in range(p)
            for j in range(p + 1) for k in range(p + 1)]


def basis(p: int, pts: np.ndarray):
    """(values (nq, nd, 3), curls (nq, nd, 3)) at reference points."""
    Cq = _lagrange(np.linspace(0.0, 1.0, p + 1))
    Cl = _lagrange((np.arange(p) + 0.5) / p)
    pts = np.asarray(pts, float)
    Q = [_poly(Cq, pts[:, a]) for a in range(3)]
    dQ = [_dpoly(Cq, pts[:, a]) for a in range(3)]
    L = [_poly(Cl, pts[:, a]) for a in range(3)]
    dL = [_dpoly(Cl, pts[:, a]) for a in range(3)]
    dofs = local_dofs(p)
    V = np.zeros((len(pts), len(dofs), 3))
    Cu = np.zeros_like(V)
    for n, (d, i, j, k) in enumerate(dofs):
        a, b = [e for e in range(3) if e != d]
        V[:, n, d] = L[d][:, i] * Q[a][:, j] * Q[b][:, k]
        g = np.zeros((len(pts), 3))
        g[:, d] = dL[d][:, i] * Q[a][:, j] * Q[b][:, k]
        g[:, a] = L[d][:, i] * dQ[a][:, j] * Q[b][:, k]
        g[:, b] = L[d][:, i] * Q[a][:, j] * dQ[b][:, k]
        e = np.zeros(3)
        e[d] = 1.0
        Cu[:, n] = np.cross(g, e[None, :])  # curl(f e_d) = grad f x e_d
    return V, Cu


def _vertex(c) -> int:
    return int(np.flatnonzero(np.all(HEX_VERTS == np.asarray(c), 1))[0])


@lru_cache(maxsize=None)
def _entities(p: int):
    """Per local dof: ("edge", va, vb, i), ("face", corners (4,), fam, a,
    b) or ("interior", counter)."""
    out, interior = [], 0
    for (d, i, j, k) in local_dofs(p):
        a, b = [e for e in range(3) if e != d]
        ends = [(ax, idx // p) for ax, idx in ((a, j), (b, k))
                if idx in (0, p)]
        if len(ends) == 2:
            c0 = np.zeros(3)
            for ax, s in ends:
                c0[ax] = s
            c1 = c0.copy()
            c1[d] = 1.0
            out.append(("edge", _vertex(c0), _vertex(c1), i))
        elif len(ends) == 1:
            fa, side = ends[0]
            u, v = [e for e in range(3) if e != fa]
            corners = []
            for cu, cv in ((0, 0), (1, 0), (1, 1), (0, 1)):
                c = np.zeros(3)
                c[fa], c[u], c[v] = side, cu, cv
                corners.append(_vertex(c))
            fam = 0 if d == u else 1
            cross = {a: j, b: k}[v if fam == 0 else u]
            out.append(("face", tuple(corners), fam, i, cross))
        else:
            out.append(("interior", interior))
            interior += 1
    return out


def _face_variant(p, gids, fam, a, b):
    """Canonical index and sign of a face dof (along in-plane axis `fam`,
    profile a along it, b across) for faces with cyclic corner ids gids:
    canonical axes run from the smallest corner towards the smaller of its
    two neighbours (u) and the other neighbour (v)."""
    E = len(gids)
    r = np.argmin(gids, axis=1)
    nxt = gids[np.arange(E), (r + 1) % 4]
    prv = gids[np.arange(E), (r + 3) % 4]
    fwd = nxt < prv
    sq = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    var = np.empty(E, np.int64)
    sgn = np.empty(E)
    for rr in range(4):
        for f in (True, False):
            sel = (r == rr) & (fwd == f)
            if not sel.any():
                continue
            to_next = sq[(rr + 1) % 4] - sq[rr]
            to_prev = sq[(rr + 3) % 4] - sq[rr]
            du, dv = (to_next, to_prev) if f else (to_prev, to_next)
            R = np.stack([du, dv], axis=1)
            row, other = R[fam], R[1 - fam]
            if row[0] != 0:
                cfam, s = 0, row[0]
                alpha = a if row[0] > 0 else p - 1 - a
                beta = b if other[1] > 0 else p - b
            else:
                cfam, s = 1, row[1]
                alpha = a if row[1] > 0 else p - 1 - a
                beta = b if other[0] > 0 else p - b
            var[sel] = cfam * p * (p - 1) + alpha * (p - 1) + (beta - 1)
            sgn[sel] = s
    return var, sgn


@dataclass
class HexND:
    """Order-p Nedelec space on a hex mesh: elem_dofs (E, nd), signs
    (E, nd), num_dofs, and the sorted unique dof keys."""

    p: int
    nodes: np.ndarray
    hexes: np.ndarray
    elem_dofs: np.ndarray
    signs: np.ndarray
    keys: np.ndarray
    num_dofs: int

    @staticmethod
    def build(nodes, hexes, p: int) -> "HexND":
        g = np.asarray(hexes, np.int64)
        E = len(g)
        ents = _entities(p)
        keys = np.full((E, len(ents), 7), -1, np.int64)
        signs = np.ones((E, len(ents)))
        for n, ent in enumerate(ents):
            if ent[0] == "edge":
                _, va, vb, i = ent
                ga, gb = g[:, va], g[:, vb]
                flip = ga > gb
                keys[:, n, 0] = _EDGE
                keys[:, n, 1] = np.minimum(ga, gb)
                keys[:, n, 2] = np.maximum(ga, gb)
                keys[:, n, 5] = 0
                keys[:, n, 6] = np.where(flip, p - 1 - i, i)
                signs[:, n] = np.where(flip, -1.0, 1.0)
            elif ent[0] == "face":
                _, corners, fam, a, b = ent
                gids = g[:, list(corners)]
                var, sgn = _face_variant(p, gids, fam, a, b)
                keys[:, n, 0] = _QUAD
                keys[:, n, 1:5] = np.sort(gids, axis=1)
                keys[:, n, 5] = var
                keys[:, n, 6] = 101
                signs[:, n] = sgn
            else:
                keys[:, n, 0] = _INTERIOR
                keys[:, n, 1] = 0
                keys[:, n, 2] = np.arange(E)
                keys[:, n, 5] = ent[1]
        uniq, inv = np.unique(keys.reshape(-1, 7), axis=0,
                              return_inverse=True)
        return HexND(p, np.asarray(nodes, float), g,
                     inv.reshape(E, len(ents)).astype(np.int64), signs,
                     uniq, len(uniq))

    def boundary_dofs(self, quads: np.ndarray) -> np.ndarray:
        """Dofs with a tangential trace on the given boundary quads: the
        edge dofs of their edges and their face dofs."""
        q = np.asarray(quads, np.int64)
        p = self.p
        want = []
        for a, b in ((0, 1), (1, 2), (2, 3), (3, 0)):
            for v in range(p):
                k = np.full((len(q), 7), -1, np.int64)
                k[:, 0] = _EDGE
                k[:, 1] = np.minimum(q[:, a], q[:, b])
                k[:, 2] = np.maximum(q[:, a], q[:, b])
                k[:, 5] = 0
                k[:, 6] = v
                want.append(k)
        for v in range(2 * p * (p - 1)):
            k = np.full((len(q), 7), -1, np.int64)
            k[:, 0] = _QUAD
            k[:, 1:5] = np.sort(q, axis=1)
            k[:, 5] = v
            k[:, 6] = 101
            want.append(k)
        want = np.unique(np.concatenate(want), axis=0)
        # Rows of the sorted unique key table that appear in `want`.
        allk = np.concatenate([self.keys, want])
        _, inv, cnt = np.unique(allk, axis=0, return_inverse=True,
                                return_counts=True)
        return np.flatnonzero(cnt[inv[:self.num_dofs]] > 1)


def _trilinear(X: np.ndarray, pts: np.ndarray):
    """Jacobians (E, nq, 3, 3) of the trilinear maps with vertex
    coordinates X (E, 8, 3) at reference points (nq, 3)."""
    s = HEX_VERTS
    dN = np.empty((len(pts), 8, 3))
    for v in range(8):
        f = [np.where(s[v, a] > 0, pts[:, a], 1.0 - pts[:, a])
             for a in range(3)]
        df = [np.where(s[v, a] > 0, 1.0, -1.0) for a in range(3)]
        dN[:, v, 0] = df[0] * f[1] * f[2]
        dN[:, v, 1] = f[0] * df[1] * f[2]
        dN[:, v, 2] = f[0] * f[1] * df[2]
    return np.einsum("evi,qvj->eqij", X, dN)  # J[i, j] = dx_i / dxi_j


def gauss_hex(n: int):
    x, w = np.polynomial.legendre.leggauss(n)
    x, w = 0.5 * (x + 1.0), 0.5 * w
    P = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    W = np.einsum("i,j,k->ijk", w, w, w).ravel()
    return P, W


def element_matrices(space: HexND, dtype=np.float64):
    """(curl-curl, mass) element matrices (E, nd, nd) with unit
    coefficients and the orientation signs folded in, by Gauss quadrature
    with p + 1 points per axis (exact on affine hexes)."""
    p = space.p
    P, W = gauss_hex(p + 1)
    V, Cu = basis(p, P)
    J = _trilinear(space.nodes[space.hexes], P)
    det = np.linalg.det(J)
    Jit = np.linalg.inv(J).transpose(0, 1, 3, 2)  # J^-T
    Vp = np.einsum("eqij,qnj->eqni", Jit, V)  # covariant values
    Cp = np.einsum("eqij,qnj->eqni", J, Cu) / det[:, :, None, None]
    rw = np.sqrt(W[None, :] * np.abs(det))[:, :, None, None]
    E, nq, nd, _ = Vp.shape

    def gram(T):  # sum_q w_q T_q,n . T_q,m as one batched product
        A = (rw * T).transpose(0, 2, 1, 3).reshape(E, nd, nq * 3)
        return A @ A.transpose(0, 2, 1)

    Ke, Me = gram(Cp), gram(Vp)
    s = space.signs
    ss = s[:, :, None] * s[:, None, :]
    return (Ke * ss).astype(dtype), (Me * ss).astype(dtype)


def assemble(space: HexND, Ae: np.ndarray) -> sp.csr_matrix:
    E, nd, _ = Ae.shape
    gd = space.elem_dofs
    rows = np.broadcast_to(gd[:, :, None], (E, nd, nd)).ravel()
    cols = np.broadcast_to(gd[:, None, :], (E, nd, nd)).ravel()
    A = sp.coo_matrix((Ae.ravel(), (rows, cols)),
                      shape=(space.num_dofs, space.num_dofs)).tocsr()
    A.sum_duplicates()
    return A


def point_load(space: HexND, x0: np.ndarray, direction: np.ndarray,
               scale: float) -> np.ndarray:
    """b_n = scale (d . phi_n(x0)), the element containing x0 located by
    Newton's method on each candidate's trilinear map."""
    x0 = np.asarray(x0, float)
    X = space.nodes[space.hexes]
    lo, hi = X.min(axis=1), X.max(axis=1)
    cand = np.flatnonzero(np.all((x0 >= lo - 1e-12) & (x0 <= hi + 1e-12), 1))
    for e in cand:
        xi = np.full(3, 0.5)
        for _ in range(20):
            Jq = _trilinear(X[e:e + 1], xi[None])[0, 0]
            f = np.array([((1 - xi[0]) if s[0] == 0 else xi[0])
                          * ((1 - xi[1]) if s[1] == 0 else xi[1])
                          * ((1 - xi[2]) if s[2] == 0 else xi[2])
                          for s in HEX_VERTS]) @ X[e] - x0
            xi = xi - np.linalg.solve(Jq, f)
        if np.all(xi >= -1e-10) and np.all(xi <= 1 + 1e-10):
            break
    else:
        raise ValueError(f"point {x0} lies in no element")
    Jq = _trilinear(X[e:e + 1], xi[None])[0, 0]
    V, _ = basis(space.p, xi[None])
    vphys = V[0] @ np.linalg.inv(Jq)  # rows: J^-T phi_n
    d = np.asarray(direction, float)
    b = np.zeros(space.num_dofs)
    np.add.at(b, space.elem_dofs[e],
              scale * (vphys @ (d / np.linalg.norm(d))) * space.signs[e])
    return b


@dataclass
class FaceTrace:
    """A boundary surface's quadrature: per face the adjacent element's
    dofs (F, nd), tangential basis values (F, nq, nd, 3) with the signs
    folded in, normal curls (F, nq, nd), weights w |dA| (F, nq) and
    points (F, nq, 3)."""

    dofs: np.ndarray
    Vt: np.ndarray
    Cn: np.ndarray
    w: np.ndarray
    x: np.ndarray

    def mass(self, n: int) -> sp.csr_matrix:
        """(u_t, v_t) over the surface."""
        A = np.einsum("fq,fqns,fqms->fnm", self.w, self.Vt, self.Vt,
                      optimize=True)
        return _assemble_faces(self.dofs, A, n)

    def curl(self, n: int) -> sp.csr_matrix:
        """(n . curl u, n . curl v) over the surface."""
        A = np.einsum("fq,fqn,fqm->fnm", self.w, self.Cn, self.Cn,
                      optimize=True)
        return _assemble_faces(self.dofs, A, n)

    def field(self, x: np.ndarray) -> np.ndarray:
        """Tangential values (F, nq, 3) of the coefficient vector x."""
        return np.einsum("fqns,fn->fqs", self.Vt, np.asarray(x)[self.dofs])


def _assemble_faces(dofs, A, n):
    F, nd, _ = A.shape
    rows = np.broadcast_to(dofs[:, :, None], A.shape).ravel()
    cols = np.broadcast_to(dofs[:, None, :], A.shape).ravel()
    return sp.coo_matrix((A.ravel(), (rows, cols)), shape=(n, n)).tocsr()


def face_trace(space: HexND, quads: np.ndarray) -> FaceTrace:
    """The trace of the space on boundary quads (node ids, any order of
    corners): each quad is matched to the hex face with the same nodes and
    integrated by a (p + 1)^2 Gauss rule on the reference face."""
    local = {}
    for a in range(3):
        for s in (0.0, 1.0):
            local[(a, s)] = np.flatnonzero(HEX_VERTS[:, a] == s)
    owner = {}
    for e, h in enumerate(space.hexes):
        for (a, s), lv in local.items():
            owner[tuple(sorted(h[lv].tolist()))] = (e, a, s)
    x1, w1 = np.polynomial.legendre.leggauss(space.p + 1)
    x1, w1 = 0.5 * (x1 + 1.0), 0.5 * w1
    U, Vg = np.meshgrid(x1, x1, indexing="ij")
    W2 = np.outer(w1, w1).ravel()
    F = len(quads)
    nq, nd = len(W2), space.elem_dofs.shape[1]
    out = FaceTrace(np.zeros((F, nd), np.int64), np.zeros((F, nq, nd, 3)),
                    np.zeros((F, nq, nd)), np.zeros((F, nq)),
                    np.zeros((F, nq, 3)))
    for f, q in enumerate(np.asarray(quads)):
        e, a, s = owner[tuple(sorted(int(v) for v in q))]
        u, v = [b for b in range(3) if b != a]
        pts = np.zeros((nq, 3))
        pts[:, a], pts[:, u], pts[:, v] = s, U.ravel(), Vg.ravel()
        X = space.nodes[space.hexes[e]]
        J = _trilinear(X[None], pts)[0]  # (nq, 3, 3)
        V, Cu = basis(space.p, pts)
        sg = space.signs[e]
        vphys = np.einsum("qji,qnj->qni", np.linalg.inv(J), V) * sg[None, :, None]
        cphys = np.einsum("qij,qnj->qni", J, Cu) \
            / np.linalg.det(J)[:, None, None] * sg[None, :, None]
        nrm = np.cross(J[:, :, u], J[:, :, v])
        dA = np.linalg.norm(nrm, axis=1)
        nrm = nrm / dA[:, None]
        out.Vt[f] = vphys - np.einsum("qs,qn->qns", nrm,
                                      np.einsum("qns,qs->qn", vphys, nrm))
        out.Cn[f] = np.einsum("qns,qs->qn", cphys, nrm)
        out.w[f] = W2 * dA
        out.x[f] = _map(X, pts)
        out.dofs[f] = space.elem_dofs[e]
    return out


def _map(X: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Trilinear map of reference points (nq, 3) into the hex X (8, 3)."""
    N = np.ones((len(pts), 8))
    for vtx in range(8):
        for a in range(3):
            N[:, vtx] *= np.where(HEX_VERTS[vtx, a] > 0, pts[:, a],
                                  1.0 - pts[:, a])
    return N @ X
