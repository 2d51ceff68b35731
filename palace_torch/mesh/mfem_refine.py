"""MFEM-parity conforming tet bisection around crack seam edges.

The reference decouples interior BC sheets by vertex duplication
(mesh/crack.py) and, where an edge interior to the crack connects two seam
vertices, locally refines the mesh first: it marks every tet/boundary-tri
with a refinement edge chosen by a HACKED edge-length table (seam edges
keep their true squared lengths, all other edges are set to 0.01x the
global minimum so the "longest edge" marking lands on seam edges; ties
broken by global edge index) and then runs MFEM's conforming marked-edge
bisection with closure.  Reference: geodata.cpp:2905-3010
(EdgeRefinementMesh + GeneralRefinement(Refinement::X)), the patched
MarkEdge semantics in extern/patch/mfem/patch_par_tet_mesh_fix_dev.diff,
and MFEM's Mesh::LocalRefinement / Mesh::Bisection /
Tetrahedron::MarkEdge bisection scheme (Arnold-Mukherjee-Pouly marked
bisection).

Matching the reference's refined mesh exactly is what makes the
committed regression CSVs (probe values, 2D-mode kn, indicators on the
cpw family) reproducible: any other local refinement solves a different
discretization whose pointwise outputs differ at the percent level.

Semantics replicated:
  - edge ids: first-encounter order scanning elements in order, each
    tet's edges in MFEM local order (0,1),(1,2),(2,0),(0,3),(1,3),(2,3)
    (DSTable push order in GetVertexToVertexTable);
  - MarkEdge: longest edge by squared length with rtol 1e-6 and
    edge-id tie-break (patched Compare); vertex reorder puts the edge in
    slots (0,1) in table order and the remaining vertices in increasing
    local order in slots (2,3); then per-face marked edges
    ind0 in {2,3,5} over face (0,2,3) and ind1 in {1,4,5} over face
    (1,2,3), type = PU;
  - Bisection: midpoint of edge (0,1); child0 = cyclic rotation of
    (v0,v2,v3) placing the face-(0,2,3) marked edge first, + midpoint;
    child1 = cyclic rotation of (v1,v2,v3) placing the face-(1,2,3)
    marked edge first, + midpoint; child redges default (2,1) with the
    TYPE_PF exception; type cycles PU -> PF -> A -> PU;
  - closure: bisect any element with a midpoint on any edge, through its
    own refinement edge, until none; then bisect boundary triangles
    (children (v2,v0,m) and (v1,v2,m)) the same way.

Copied from palace_tpu/mesh/mfem_refine.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from palace_torch.fem import reference as ref
from palace_torch.mesh.mesh import ElemBucket, Mesh

TET_EDGES = ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3))
TRI_EDGES = ((0, 1), (1, 2), (2, 0))
TYPE_PU, TYPE_PF, TYPE_A = 0, 1, 2
_RTOL = 1.0e-6

# MarkEdge vertex reorders: edge j -> slots (0,1) in table order, the two
# remaining vertices in increasing local order in slots (2,3).
_TET_MARK_PERM = {
    0: (0, 1, 2, 3),
    1: (1, 2, 0, 3),
    2: (2, 0, 1, 3),
    3: (0, 3, 1, 2),
    4: (1, 3, 0, 2),
    5: (2, 3, 0, 1),
}
_TRI_MARK_PERM = {0: (0, 1, 2), 1: (1, 2, 0), 2: (2, 0, 1)}

# Bisection child0 orders (rotation of (v0, v2, v3) by face-1 marked edge
# code in {2: (2,0), 3: (0,3), 5: (2,3)}), child1 (rotation of
# (v1, v2, v3) by face-2 code in {1: (1,2), 4: (1,3), 5: (2,3)}).
_CHILD0 = {2: (0, 2, 3), 3: (3, 0, 2), 5: (2, 3, 0)}
_CHILD1 = {1: (1, 2, 3), 4: (3, 1, 2), 5: (2, 3, 1)}


def _ek(a: int, b: int) -> Tuple[int, int]:
    return (a, b) if a < b else (b, a)


def _edge_ids(tets: List[List[int]]) -> Dict[Tuple[int, int], int]:
    ids: Dict[Tuple[int, int], int] = {}
    for conn in tets:
        for (a, b) in TET_EDGES:
            k = _ek(conn[a], conn[b])
            if k not in ids:
                ids[k] = len(ids)
    return ids


def _pick_longest(edges, L, ids):
    """Sequential Compare from the patched MarkEdge: strict rtol-greater,
    or near-equal with larger global edge id."""
    k0 = edges[0]
    Lb, ib, j = L[k0], ids[k0], 0
    for t in range(1, len(edges)):
        k = edges[t]
        l, i2 = L[k], ids[k]
        if l > Lb * (1.0 + _RTOL) or (l > Lb * (1.0 - _RTOL) and i2 > ib):
            Lb, ib, j = l, i2, t
    return j


def _mark_tet(conn, L, ids):
    """Returns (reordered conn, (red0, red1), TYPE_PU)."""
    edges = [_ek(conn[a], conn[b]) for (a, b) in TET_EDGES]
    j = _pick_longest(edges, L, ids)
    c = [conn[p] for p in _TET_MARK_PERM[j]]
    # Face (0,2,3): candidate edges coded 2=(2,0), 3=(0,3), 5=(2,3).
    f0 = [_ek(c[2], c[0]), _ek(c[0], c[3]), _ek(c[2], c[3])]
    red0 = (2, 3, 5)[_pick_longest(f0, L, ids)]
    # Face (1,2,3): candidate edges coded 1=(1,2), 4=(1,3), 5=(2,3).
    f1 = [_ek(c[1], c[2]), _ek(c[1], c[3]), _ek(c[2], c[3])]
    red1 = (1, 4, 5)[_pick_longest(f1, L, ids)]
    return c, (red0, red1), TYPE_PU


def _mark_tri(conn, L, ids):
    edges = [_ek(conn[a], conn[b]) for (a, b) in TRI_EDGES]
    j = _pick_longest(edges, L, ids)
    return [conn[p] for p in _TRI_MARK_PERM[j]]


def _true_lengths2(X, ids) -> Dict[Tuple[int, int], float]:
    keys = list(ids.keys())
    a = np.fromiter((k[0] for k in keys), np.int64)
    b = np.fromiter((k[1] for k in keys), np.int64)
    l2 = ((X[a] - X[b]) ** 2).sum(axis=1)
    return dict(zip(keys, l2.tolist()))


class _TetMesh:
    """Mutable refinement state (single tet bucket + tri boundary)."""

    def __init__(self, mesh: Mesh):
        assert len(mesh.buckets) == 1 and mesh.buckets[0].geom == ref.Geom.TET
        b = mesh.buckets[0]
        assert b.geo_order == 1
        self.base = mesh.nodes
        self.extra: List[np.ndarray] = []
        self.n_nodes = mesh.nodes.shape[0]
        self.tets: List[List[int]] = [list(map(int, r)) for r in b.conn]
        self.tattr: List[int] = [int(a) for a in b.attr]
        self.redges: List[Tuple[int, int]] = [(2, 1)] * len(self.tets)
        self.ttype: List[int] = [TYPE_PU] * len(self.tets)
        self.bdr: List[Tuple[List[int], int, int]] = []  # conn, attr, bucket
        self.bdr_buckets_meta = []
        for bi, bb in enumerate(mesh.bdr_buckets):
            assert bb.geom == ref.Geom.TRI and bb.geo_order == 1
            self.bdr_buckets_meta.append((bb.etype, bb.geom, bb.geo_order))
            for r, a in zip(bb.conn, bb.attr):
                self.bdr.append((list(map(int, r)), int(a), bi))
        self.mesh = mesh

    def nodes(self) -> np.ndarray:
        if not self.extra:
            return self.base
        return np.concatenate([self.base, np.asarray(self.extra)])

    def mark(self, seam_edges=None):
        """MarkTetMeshForRefinement (+ boundary tris).  seam_edges=None
        uses true squared lengths (the initial Finalize marking); a set of
        vertex pairs applies the reference's hacked lengths."""
        ids = _edge_ids(self.tets)
        L = _true_lengths2(self.nodes(), ids)
        if seam_edges is not None:
            lmin = 0.01 * min(L.values())
            seam = {(min(a, b), max(a, b)) for (a, b) in seam_edges}
            for k in L:
                if k not in seam:
                    L[k] = lmin
        for i in range(len(self.tets)):
            self.tets[i], self.redges[i], self.ttype[i] = _mark_tet(
                self.tets[i], L, ids)
        for i in range(len(self.bdr)):
            conn, a, bi = self.bdr[i]
            self.bdr[i] = (_mark_tri(conn, L, ids), a, bi)

    # -- bisection ----------------------------------------------------------

    def _coord(self, v: int) -> np.ndarray:
        n0 = self.base.shape[0]
        return self.base[v] if v < n0 else self.extra[v - n0]

    def _midpoint(self, v0: int, v1: int, table: Dict) -> int:
        k = _ek(v0, v1)
        m = table.get(k)
        if m is None:
            m = self.n_nodes
            self.n_nodes += 1
            self.extra.append(0.5 * (self._coord(v0) + self._coord(v1)))
            table[k] = m
        return m

    def bisect_tet(self, i: int, table: Dict):
        vert = self.tets[i]
        red0, red1 = self.redges[i]
        typ = self.ttype[i]
        m = self._midpoint(vert[0], vert[1], table)

        c0 = [vert[p] for p in _CHILD0[red0]] + [m]
        c1 = [vert[p] for p in _CHILD1[red1]] + [m]
        nr0, nr1 = [2, 1], [2, 1]
        if red0 == 2 and typ == TYPE_PF:
            nr0[1] = 4
        if red1 == 1 and typ == TYPE_PF:
            nr1[1] = 4
        new_type = (TYPE_PF if typ == TYPE_PU
                    else (TYPE_A if typ == TYPE_PF else TYPE_PU))
        self.tets[i] = c0
        self.redges[i] = tuple(nr0)
        self.ttype[i] = new_type
        self.tets.append(c1)
        self.tattr.append(self.tattr[i])
        self.redges.append(tuple(nr1))
        self.ttype.append(new_type)

    def needs(self, conn, table, edges) -> bool:
        for (a, b) in edges:
            if _ek(conn[a], conn[b]) in table:
                return True
        return False

    def refine(self, marked: Sequence[int]):
        table: Dict[Tuple[int, int], int] = {}
        for i in marked:
            self.bisect_tet(i, table)
        changed = True
        while changed:
            changed = False
            i = 0
            while i < len(self.tets):
                if self.needs(self.tets[i], table, TET_EDGES):
                    self.bisect_tet(i, table)
                    changed = True
                i += 1
        # Boundary triangles: bisect through the marked edge while any edge
        # has a midpoint.  Conformity guarantees the marked edge itself has
        # one (the tet face is always cut through its marked edge first).
        changed = True
        while changed:
            changed = False
            i = 0
            while i < len(self.bdr):
                conn, a, bi = self.bdr[i]
                if self.needs(conn, table, TRI_EDGES):
                    k = _ek(conn[0], conn[1])
                    assert k in table, (
                        "boundary triangle requires a new midpoint on its "
                        "marked edge: marking inconsistency")
                    m = table[k]
                    self.bdr[i] = ([conn[2], conn[0], m], a, bi)
                    self.bdr.append(([conn[1], conn[2], m], a, bi))
                    changed = True
                i += 1

    def to_mesh(self) -> Mesh:
        b = self.mesh.buckets[0]
        bucket = ElemBucket(b.etype, b.geom, 1,
                            np.asarray(self.tets, np.int32),
                            np.asarray(self.tattr, np.int32))
        new_bdr = []
        for bi, (etype, geom, go) in enumerate(self.bdr_buckets_meta):
            conns = [c for (c, a, j) in self.bdr if j == bi]
            attrs = [a for (c, a, j) in self.bdr if j == bi]
            new_bdr.append(ElemBucket(etype, geom, go,
                                      np.asarray(conns, np.int32),
                                      np.asarray(attrs, np.int32)))
        return Mesh(self.nodes(), [bucket], new_bdr,
                    self.mesh.physical_names)


def is_pure_tet(mesh: Mesh) -> bool:
    return (len(mesh.buckets) == 1 and mesh.buckets[0].geom == ref.Geom.TET
            and mesh.buckets[0].geo_order == 1
            and all(b.geom == ref.Geom.TRI and b.geo_order == 1
                    for b in mesh.bdr_buckets))


def seam_bisection_refine(mesh: Mesh, seam_edges, refine_elems,
                          first_pass: bool) -> Mesh:
    """One round of the reference's non-periodic seam refinement: (re)mark
    with hacked lengths, bisect the owner elements of seam-adjacent crack
    facets once each, close, and return the refined mesh.  `first_pass`
    additionally applies the initial true-length marking beforehand (the
    reference's Finalize(refine=true) at geodata.cpp:233), whose vertex
    reordering feeds the hacked marking's edge-id tie-breaks."""
    tm = _TetMesh(mesh)
    if first_pass:
        tm.mark(seam_edges=None)
    tm.mark(seam_edges=seam_edges)
    tm.refine(sorted(set(int(e) for e in refine_elems)))
    return tm.to_mesh()
