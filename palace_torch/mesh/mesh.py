"""Unstructured mesh as struct-of-arrays, bucketed by element geometry.

Replaces the reference solver's pointer-rich mfem::ParMesh (reference:
palace/fem/mesh.hpp:20-44, palace/utils/geodata.cpp) with flat numpy
arrays suitable for XLA: per-geometry element buckets with fixed-width
connectivity, plus global edge/face entity tables for conforming dof
numbering.

Element "attributes" follow the Gmsh physical-group convention: domain
elements carry a domain attribute; boundary (dim-1) elements carry a
boundary attribute.  All coordinates are stored in nondimensionalized
units once `scale_coordinates` has been applied.

Copied from palace_tpu/mesh/mesh.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from palace_torch.fem import reference as ref
from palace_torch.fem.reference import Geom
from palace_torch.mesh import gmsh as gmshio


@dataclass
class ElemBucket:
    """All elements sharing one gmsh element type."""

    etype: int  # gmsh element type id
    geom: Geom
    geo_order: int
    conn: np.ndarray  # (E, num_nodes) int32 node ids
    attr: np.ndarray  # (E,) int32 attribute (physical tag)

    @property
    def num_elem(self) -> int:
        return self.conn.shape[0]

    @property
    def num_corners(self) -> int:
        return len(ref.GEOM_VERTICES[self.geom])

    @property
    def corners(self) -> np.ndarray:
        """(E, num_corners) corner-vertex node ids."""
        return self.conn[:, : self.num_corners]


class Mesh:
    """Unstructured (possibly curved, mixed-element) conforming mesh."""

    def __init__(
        self,
        nodes: np.ndarray,
        buckets: List[ElemBucket],
        bdr_buckets: List[ElemBucket],
        physical_names: Optional[Dict[tuple, str]] = None,
    ):
        self.nodes = np.asarray(nodes, np.float64)
        self.buckets = buckets
        self.bdr_buckets = bdr_buckets
        self.physical_names = physical_names or {}
        self.dim = max(ref.GEOM_DIM[b.geom] for b in buckets)
        self._edge_table = None
        self._face_table = None
        # Periodic identification: node id -> topological id (donor node).
        # None = identity.  Geometry always uses the raw node ids; finite
        # element spaces key their dof entities through topo_ids so paired
        # boundary dofs coincide (reference: mfem periodic meshes /
        # palace/utils/geodata.cpp MakePeriodic).
        self.node_ident: Optional[np.ndarray] = None

        # Used vertices: corner nodes of domain elements.
        corner_ids = np.concatenate([b.corners.ravel() for b in buckets])
        self.vertex_ids = np.unique(corner_ids)  # node ids that are vertices

    def topo_ids(self, ids: np.ndarray) -> np.ndarray:
        """Map node ids to topological (periodic-identified) ids."""
        if self.node_ident is None:
            return ids
        return self.node_ident[np.asarray(ids)]

    # -- basic queries ------------------------------------------------------

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_vertices(self) -> int:
        return len(self.vertex_ids)

    @property
    def num_elements(self) -> int:
        return sum(b.num_elem for b in self.buckets)

    def bounding_box(self) -> Tuple[np.ndarray, np.ndarray]:
        used = np.unique(np.concatenate([b.conn.ravel() for b in self.buckets]))
        pts = self.nodes[used]
        return pts.min(axis=0), pts.max(axis=0)

    def attributes(self) -> np.ndarray:
        return np.unique(np.concatenate([b.attr for b in self.buckets]))

    def bdr_attributes(self) -> np.ndarray:
        if not self.bdr_buckets:
            return np.zeros(0, np.int32)
        return np.unique(np.concatenate([b.attr for b in self.bdr_buckets]))

    def scale_coordinates(self, factor: float):
        """Divide coordinates by `factor` (mesh units L0 -> nondimensional)."""
        self.nodes = self.nodes / factor

    # -- entities -----------------------------------------------------------

    def edge_table(self):
        """Unique mesh edges over domain elements.

        Returns (edge_verts (ne, 2) sorted vertex node-id pairs,
                 per-bucket edge index arrays [(E, n_edges_of_geom)]).
        """
        if self._edge_table is None:
            all_pairs = []
            for b in self.buckets:
                edges = np.array(ref.GEOM_EDGES[b.geom], np.int64)  # (ng, 2)
                pairs = b.corners[:, edges]  # (E, ng, 2)
                pairs = np.sort(pairs.astype(np.int64), axis=-1)
                all_pairs.append(pairs.reshape(-1, 2))
            cat = np.concatenate(all_pairs)
            uniq, inv = np.unique(cat, axis=0, return_inverse=True)
            out = []
            ofs = 0
            for b, pairs in zip(self.buckets, all_pairs):
                ng = len(ref.GEOM_EDGES[b.geom])
                out.append(inv[ofs : ofs + b.num_elem * ng].reshape(b.num_elem, ng))
                ofs += b.num_elem * ng
            self._edge_table = (uniq, out)
        return self._edge_table

    def face_table(self):
        """Unique mesh faces (3D meshes): tris and quads.

        Returns (face_verts (nf, 4) sorted vertex ids, -1-padded for tris,
                 per-bucket face index arrays [(E, n_faces_of_geom)],
                 face_counts (nf,) number of adjacent domain elements).
        """
        if self._face_table is None:
            all_keys = []
            for b in self.buckets:
                faces = ref.GEOM_FACES[b.geom]
                keys = np.full((b.num_elem, len(faces), 4), -1, np.int64)
                for i, f in enumerate(faces):
                    fv = np.sort(b.corners[:, list(f)].astype(np.int64), axis=-1)
                    keys[:, i, 4 - len(f) :] = fv
                all_keys.append(keys.reshape(-1, 4))
            cat = np.concatenate(all_keys)
            uniq, inv, counts = np.unique(
                cat, axis=0, return_inverse=True, return_counts=True
            )
            out = []
            ofs = 0
            for b, keys in zip(self.buckets, all_keys):
                ng = len(ref.GEOM_FACES[b.geom])
                out.append(inv[ofs : ofs + b.num_elem * ng].reshape(b.num_elem, ng))
                ofs += b.num_elem * ng
            self._face_table = (uniq, out, counts)
        return self._face_table

    def bdr_face_attr(self) -> Dict[int, int]:
        """Map from global face id -> boundary attribute (3D meshes)."""
        uniq, _, _ = self.face_table()
        out = {}
        for b in self.bdr_buckets:
            if ref.GEOM_DIM[b.geom] != self.dim - 1:
                continue
            nv = b.num_corners
            keys = np.full((b.num_elem, 4), -1, np.int64)
            keys[:, 4 - nv :] = np.sort(b.corners.astype(np.int64), axis=-1)
            idx = _lookup_rows(uniq, keys)
            for fid, a in zip(idx, b.attr):
                if fid >= 0:
                    out[int(fid)] = int(a)
        return out


def _lookup_rows(table: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Find row indices of `queries` in lexicographically-unique `table`.

    Returns -1 for rows not present.
    """
    if len(table) == 0:
        return np.full(len(queries), -1, np.int64)
    # Lexicographic order over columns (last column most significant for
    # np.lexsort, so pass reversed).
    order = np.lexsort(table.T[::-1])
    tbl = table[order]
    # Binary search using void view trick.
    t = np.ascontiguousarray(tbl).view([("", tbl.dtype)] * tbl.shape[1]).ravel()
    q = np.ascontiguousarray(queries.astype(tbl.dtype)).view(
        [("", tbl.dtype)] * queries.shape[1]
    ).ravel()
    pos = np.searchsorted(t, q)
    pos = np.clip(pos, 0, len(t) - 1)
    found = t[pos] == q
    out = np.where(found, order[pos], -1)
    return out


import functools


@functools.lru_cache(maxsize=None)
def _simplex_node_perm(etype: int, perm: tuple) -> np.ndarray:
    """Node re-indexing under a simplex vertex permutation.

    For new-frame gmsh node k, returns the old-frame node index m such that
    reordering conn[:, m] yields the same physical element with vertices
    listed in the permuted order: R_old[m] = phi_perm(R_new[k]) where
    phi maps new reference vertex i to old reference vertex perm[i].
    """
    geom, order, R = ref.gmsh_node_coords(etype)
    V = ref.GEOM_VERTICES[geom]
    dim = R.shape[1]
    # Barycentric coordinates of each reference node.
    lam = np.concatenate([1.0 - R.sum(axis=1, keepdims=True), R], axis=1)
    # phi(R[k]) = sum_i lam_i(R[k]) * V[perm[i]]
    Vp = V[list(perm)]
    phi = lam @ Vp
    m = np.empty(len(R), np.int64)
    for k in range(len(R)):
        d = np.linalg.norm(R - phi[k], axis=1)
        j = int(np.argmin(d))
        assert d[j] < 1e-9, "node permutation match failed"
        m[k] = j
    return m


def _prism_node_perm(etype: int, perm3: tuple) -> np.ndarray:
    """Node re-indexing of a wedge under an in-plane vertex permutation
    (applied to both triangle layers; z untouched)."""
    geom, order, R = ref.gmsh_node_coords(etype)
    V2 = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    lam = np.stack([1.0 - R[:, 0] - R[:, 1], R[:, 0], R[:, 1]], axis=1)
    phi = np.concatenate([lam @ V2[list(perm3)], R[:, 2:3]], axis=1)
    m = np.empty(len(R), np.int64)
    for k in range(len(R)):
        d = np.linalg.norm(R - phi[k], axis=1)
        j = int(np.argmin(d))
        assert d[j] < 1e-9, "prism node permutation match failed"
        m[k] = j
    return m


def _canonicalize_prism_bucket(mesh: Mesh, b):
    """In-plane canonicalization of a wedge bucket: permute the triangle
    columns into ascending COLUMN RANK, where columns are the connected
    chains of vertical (intra-prism) edges.  All prisms stacked on or
    beside each other order any shared face's vertices identically (the
    rank depends only on the column, not the layer), which is the
    conformity precondition of fem/nd_prism.py — works for extruded meshes
    regardless of the global node numbering."""
    corners = mesh.topo_ids(b.conn[:, :6])
    nv = int(mesh.topo_ids(np.arange(mesh.num_nodes)).max()) + 1 \
        if mesh.num_nodes else 0
    parent = np.arange(nv, dtype=np.int64)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(3):
        for a, c in zip(corners[:, i], corners[:, 3 + i]):
            ra, rc = find(int(a)), find(int(c))
            if ra != rc:
                parent[max(ra, rc)] = min(ra, rc)
    col = np.fromiter((find(int(v)) for v in range(nv)), np.int64, nv)
    rank_of = {c: r for r, c in enumerate(np.unique(col))}
    rank = np.fromiter((rank_of[c] for c in col), np.int64, nv)

    bot_rank = rank[corners[:, :3]]
    if (np.sort(bot_rank, axis=1)[:, :-1]
            == np.sort(bot_rank, axis=1)[:, 1:]).any():
        raise NotImplementedError(
            "prism mesh has merged vertical columns (two corners of one "
            "wedge share a column); general prism orientations need "
            "DofTransformations")
    order = np.argsort(bot_rank, axis=1)
    code = order[:, 0] * 9 + order[:, 1] * 3 + order[:, 2]
    for c in np.unique(code):
        rows = np.where(code == c)[0]
        perm3 = tuple(int(x) for x in order[rows[0]])
        if perm3 == (0, 1, 2):
            continue
        m = _prism_node_perm(b.etype, perm3)
        b.conn[rows] = b.conn[rows][:, m]


def canonicalize_simplices(mesh: Mesh):
    """Reorder every tet/tri element's nodes so corner vertices appear in
    increasing global index.

    After this transformation all shared entities (edges, faces) have
    identical intrinsic orientation in every adjacent element, so
    H(curl)/H(div) bases built on sorted barycentrics are conforming with no
    sign or DofTransformation machinery (the TPU-native replacement for
    reference: palace/fem/libceed/restriction.cpp DofTransformations).
    Jacobians of re-ordered elements may have negative determinant;
    quadrature weights use |detJ|.
    """
    for b in mesh.buckets + mesh.bdr_buckets:
        if b.geom is ref.Geom.PRISM:
            _canonicalize_prism_bucket(mesh, b)
            continue
        if b.geom not in (ref.Geom.TET, ref.Geom.TRI):
            continue
        nv = b.num_corners
        corners = mesh.topo_ids(b.conn[:, :nv])
        order = np.argsort(corners, axis=1)  # per-element permutation
        # encode class
        code = np.zeros(b.num_elem, np.int64)
        for i in range(nv):
            code = code * nv + order[:, i]
        for c in np.unique(code):
            rows = np.where(code == c)[0]
            perm = tuple(int(x) for x in order[rows[0]])
            if perm == tuple(range(nv)):
                continue
            m = _simplex_node_perm(b.etype, perm)
            b.conn[rows] = b.conn[rows][:, m]
    # Invalidate cached entity tables.
    mesh._edge_table = None
    mesh._face_table = None


def load_mesh(path: str) -> Mesh:
    """Load a mesh file: Gmsh MSH 2.2, COMSOL .mphtxt/.mphbin, Nastran
    .nas/.bdf, MFEM-native .mesh, or VTK legacy .vtk (reference:
    palace/utils/geodata.cpp:2048-2066 converts COMSOL/Nastran through an
    in-memory Gmsh file; MFEM/VTK are read by mfem::Mesh itself)."""
    low = path.lower()
    if low.endswith((".mphtxt", ".mphbin")):
        from palace_torch.mesh.convert import read_comsol

        raw = read_comsol(path)
    elif low.endswith((".nas", ".bdf")):
        from palace_torch.mesh.convert import read_nastran

        raw = read_nastran(path)
    elif low.endswith(".mesh"):
        from palace_torch.mesh.convert import read_mfem

        raw = read_mfem(path)
    elif low.endswith(".vtk"):
        from palace_torch.mesh.convert import read_vtk

        raw = read_vtk(path)
    else:
        raw = gmshio.read(path)
    max_dim = max(
        gmshio.GMSH_DIM[et]
        for et in raw.elements
        if gmshio.GMSH_DIM[et] > 0
    )
    buckets, bdr = [], []
    for et, (conn, phys, _) in sorted(raw.elements.items()):
        d = gmshio.GMSH_DIM[et]
        geom, order, _ = ref.gmsh_node_coords(et)
        b = ElemBucket(et, geom, order, conn, phys.astype(np.int32))
        if d == max_dim:
            buckets.append(b)
        elif d == max_dim - 1:
            bdr.append(b)
    nodes = raw.nodes
    if max_dim == 2 and np.ptp(nodes[:, 2]) < 1e-12 * max(np.ptp(nodes[:, 0]),
                                                          np.ptp(nodes[:, 1])):
        # Planar 2D mesh: drop the constant z coordinate (the reference
        # stores true 2D meshes with SpaceDimension 2, geodata.cpp mesh load).
        nodes = np.ascontiguousarray(nodes[:, :2])
    return Mesh(nodes, buckets, bdr, raw.physical_names)
