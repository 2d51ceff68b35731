"""Uniform mesh refinement (reference: palace/utils/geodata.cpp RefineMesh,
mfem GeneralRefinement uniform path).

Each element splits red-uniformly (tri 1:4, tet 1:8 with Bey's octahedron
split, hex 1:8); child nodes are generated by evaluating the PARENT
isoparametric map at child reference coordinates, so curved (higher-order)
geometry is preserved exactly.  Boundary facets refine consistently and node
identity across elements is restored by coordinate-keyed deduplication.

Copied from palace_tpu/mesh/refine.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from palace_torch.fem import reference as ref
from palace_torch.fem.reference import Geom
from palace_torch.mesh.mesh import ElemBucket, Mesh


def _child_corner_sets(geom: Geom) -> List[np.ndarray]:
    """Child elements as (n_child, n_corner, rdim) reference coordinates."""
    if geom is Geom.LINE:
        return [np.array([[0.0], [0.5]]), np.array([[0.5], [1.0]])]
    if geom is Geom.TRI:
        v = ref.GEOM_VERTICES[Geom.TRI]
        m = {(a, b): 0.5 * (v[a] + v[b]) for a in range(3) for b in range(3)}
        return [
            np.array([v[0], m[(0, 1)], m[(0, 2)]]),
            np.array([v[1], m[(0, 1)], m[(1, 2)]]),
            np.array([v[2], m[(0, 2)], m[(1, 2)]]),
            np.array([m[(0, 1)], m[(1, 2)], m[(0, 2)]]),
        ]
    if geom is Geom.TET:
        v = ref.GEOM_VERTICES[Geom.TET]
        m = {}
        for a in range(4):
            for b in range(a + 1, 4):
                m[(a, b)] = 0.5 * (v[a] + v[b])
        c = [
            np.array([v[0], m[(0, 1)], m[(0, 2)], m[(0, 3)]]),
            np.array([v[1], m[(0, 1)], m[(1, 2)], m[(1, 3)]]),
            np.array([v[2], m[(0, 2)], m[(1, 2)], m[(2, 3)]]),
            np.array([v[3], m[(0, 3)], m[(1, 3)], m[(2, 3)]]),
        ]
        # Octahedron (m01, m02, m03, m12, m13, m23) split along the
        # (m01, m23) diagonal (Bey red refinement).
        d0, d1 = m[(0, 1)], m[(2, 3)]
        for (a, b) in (((0, 2), (0, 3)), ((0, 3), (1, 3)),
                       ((1, 3), (1, 2)), ((1, 2), (0, 2))):
            c.append(np.array([d0, d1, m[a], m[b]]))
        return c
    if geom is Geom.HEX:
        out = []
        for i in range(2):
            for j in range(2):
                for k in range(2):
                    base = np.array([i, j, k]) * 0.5
                    corners = []
                    # gmsh hex corner order
                    for (a, b, cc) in ((0, 0, 0), (1, 0, 0), (1, 1, 0),
                                       (0, 1, 0), (0, 0, 1), (1, 0, 1),
                                       (1, 1, 1), (0, 1, 1)):
                        corners.append(base + 0.5 * np.array([a, b, cc]))
                    out.append(np.array(corners))
        return out
    if geom is Geom.QUAD:
        out = []
        for i in range(2):
            for j in range(2):
                base = np.array([i, j]) * 0.5
                corners = [base + 0.5 * np.array(d)
                           for d in ((0, 0), (1, 0), (1, 1), (0, 1))]
                out.append(np.array(corners))
        return out
    raise NotImplementedError(f"uniform refinement for {geom}")


def _child_node_refcoords(geom: Geom, etype: int, child_corners: np.ndarray
                          ) -> np.ndarray:
    """Reference coords (in the PARENT) of the child's geometry nodes:
    the child's affine/multilinear corner map applied to the reference
    node lattice of the element type."""
    _, _, ref_nodes = ref.gmsh_node_coords(etype)
    if geom in (Geom.TRI, Geom.TET, Geom.LINE):
        # Barycentric interpolation of the child corners.
        lam = np.concatenate(
            [1.0 - ref_nodes.sum(axis=1, keepdims=True), ref_nodes], axis=1)
        return lam @ child_corners
    # Tensor elements: multilinear map of corners.
    gb = ref.gmsh_geometry_basis({Geom.HEX: 5, Geom.QUAD: 3}[geom])
    B = gb.eval(ref_nodes)  # (nn, ncorner)
    return B @ child_corners


def refine_uniform(mesh: Mesh, levels: int = 1) -> Mesh:
    out = mesh
    for _ in range(levels):
        out = _refine_once(out)
    return out


def _refine_once(mesh: Mesh) -> Mesh:
    new_nodes: List[np.ndarray] = []
    key_to_id: Dict[Tuple, int] = {}

    def node_ids(coords: np.ndarray) -> np.ndarray:
        ids = np.empty(len(coords), np.int32)
        for k, p in enumerate(coords):
            key = tuple(np.round(p, 9))
            i = key_to_id.get(key)
            if i is None:
                i = len(new_nodes)
                new_nodes.append(p)
                key_to_id[key] = i
            ids[k] = i
        return ids

    def refine_bucket(b: ElemBucket) -> ElemBucket:
        gb = ref.gmsh_geometry_basis(b.etype)
        children = _child_corner_sets(b.geom)
        conns = []
        attrs = []
        for child in children:
            child_ref = _child_node_refcoords(b.geom, b.etype, child)
            B = gb.eval(child_ref)  # (nn_child, nn_parent)
            X = mesh.nodes[b.conn]  # (E, nn_parent, sdim)
            pts = np.einsum("cn,ens->ecs", B, X)  # (E, nn_child, sdim)
            E, nn, sdim = pts.shape
            ids = node_ids(pts.reshape(-1, sdim)).reshape(E, nn)
            conns.append(ids)
            attrs.append(b.attr)
        conn = np.concatenate(conns)
        attr = np.concatenate(attrs)
        return ElemBucket(b.etype, b.geom, b.geo_order, conn.astype(np.int32),
                          attr.astype(np.int32))

    buckets = [refine_bucket(b) for b in mesh.buckets]
    bdr = [refine_bucket(b) for b in mesh.bdr_buckets]
    return Mesh(np.array(new_nodes), buckets, bdr, mesh.physical_names)
