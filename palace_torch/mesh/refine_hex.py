"""Nonconforming isotropic 1->8 hex refinement with 2:1 balance.

The reference refines NC meshes via mfem::ParMesh::GeneralRefinement from
the AMR loop (reference: palace/drivers/basesolver.cpp:247,
palace/utils/geodata.cpp:237) and lets MFEM's conforming prolongation hide
the hanging-node constraints.  Here refinement produces an explicit mesh
(children appended, parents removed) plus stateless *NC quad records* —
master face corner/mid/center node ids — that fem/hanging.py turns into
hanging-dof interpolation constraints.

Curved (geo_order 2, hex27) parents refine through their isoparametric
map: every child node's reference position is evaluated through the parent
geometry, so curved boundaries stay curved.

Node identity across elements and across AMR iterations uses a persistent
registry keyed by the trilinear corner-weight signature of the node's
reference position within its parent: two parents sharing a face produce
identical keys for shared nodes (weights supported on the shared corners),
so children glue conformingly and a later refinement of the coarse side
reuses the fine side's nodes.  The registry lives on the mesh object
(`mesh._refine_registry`) and is carried through refinement.

Copied from palace_tpu/mesh/refine_hex.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from palace_torch.fem import reference as ref
from palace_torch.fem.reference import Geom
from palace_torch.mesh.mesh import ElemBucket, Mesh

#: children of the unit cube: offsets of the 8 subcubes.
_CHILD_OFFSETS = [(i, j, k) for k in (0, 1) for j in (0, 1) for i in (0, 1)]

#: face frame: GEOM_FACES ordering (corner0 -> corner1 = u, corner0 ->
#: corner3 = v).
HEX_FACES = ref.GEOM_FACES[Geom.HEX]
QUAD_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0)]


def _weight_key(corners: np.ndarray, xi: np.ndarray) -> tuple:
    """Trilinear corner-weight signature of reference point xi in a hex
    with the given global corner ids (weights quantized to 1/64)."""
    V = ref.GEOM_VERTICES[Geom.HEX]
    out = []
    for c, v in zip(corners, V):
        w = ((1.0 - xi[0]) if v[0] == 0.0 else xi[0]) \
            * ((1.0 - xi[1]) if v[1] == 0.0 else xi[1]) \
            * ((1.0 - xi[2]) if v[2] == 0.0 else xi[2])
        w64 = int(round(w * 64.0))
        if w64 > 0:
            out.append((int(c), w64))
    return tuple(sorted(out))


def _quad_weight_key(corners, uv) -> tuple:
    """Bilinear signature on a quad face — identical to the trilinear hex
    signature of the same physical point (weights supported on the face)."""
    u, v = float(uv[0]), float(uv[1])
    ws = [(1 - u) * (1 - v), u * (1 - v), u * v, (1 - u) * v]
    out = [(int(c), int(round(w * 64.0))) for c, w in zip(corners, ws)
           if int(round(w * 64.0)) > 0]
    return tuple(sorted(out))


def _registry(mesh: Mesh) -> Dict[tuple, int]:
    reg = getattr(mesh, "_refine_registry", None)
    if reg is None:
        reg = {}
        mesh._refine_registry = reg
    return reg


def _levels(mesh: Mesh) -> List[np.ndarray]:
    lv = getattr(mesh, "_amr_level", None)
    if lv is None or len(lv) != len(mesh.buckets) or any(
            len(a) != b.num_elem for a, b in zip(lv, mesh.buckets)):
        lv = [np.zeros(b.num_elem, np.int32) for b in mesh.buckets]
        mesh._amr_level = lv
    return lv


def nc_quad_records(mesh: Mesh) -> List[dict]:
    """Stateless NC interface detection: master quad faces whose four child
    faces exist on the refined side.  Record: master (bucket, elem, face),
    corner ids (cyclic, face frame), edge-mid ids (aligned with QUAD_EDGES),
    center id, and the child (bucket, elem, face) owners."""
    reg = getattr(mesh, "_refine_registry", None)
    if not reg:
        return []
    faces: Dict[tuple, List[Tuple[int, int, int]]] = {}
    for bi, b in enumerate(mesh.buckets):
        if b.geom is not Geom.HEX:
            continue
        C = b.corners
        for fi, fverts in enumerate(HEX_FACES):
            keys = np.sort(C[:, list(fverts)], axis=1)
            for ei in range(b.num_elem):
                faces.setdefault(tuple(int(x) for x in keys[ei]),
                                 []).append((bi, ei, fi))
    records = []
    for bi, b in enumerate(mesh.buckets):
        if b.geom is not Geom.HEX:
            continue
        C = b.corners
        for fi, fverts in enumerate(HEX_FACES):
            for ei in range(b.num_elem):
                corners = [int(C[ei, v]) for v in fverts]
                fkey = tuple(sorted(corners))
                if len(faces.get(fkey, ())) != 1:
                    continue  # conforming interior face
                mids = []
                for (a, c) in QUAD_EDGES:
                    mk = _quad_weight_key(
                        corners, {(0, 1): (0.5, 0.0), (1, 2): (1.0, 0.5),
                                  (2, 3): (0.5, 1.0),
                                  (3, 0): (0.0, 0.5)}[(a, c)])
                    mids.append(reg.get(mk))
                ck = _quad_weight_key(corners, (0.5, 0.5))
                center = reg.get(ck)
                if center is None or any(m is None for m in mids):
                    continue  # true boundary or unrefined interface
                # Child faces in the 4 quadrants (cyclic orientation kept).
                cs, ms, ce = corners, mids, center
                child_faces = [
                    (cs[0], ms[0], ce, ms[3]), (ms[0], cs[1], ms[1], ce),
                    (ce, ms[1], cs[2], ms[2]), (ms[3], ce, ms[2], cs[3])]
                owners = []
                ok = True
                for cf in child_faces:
                    o = faces.get(tuple(sorted(cf)))
                    if not o or len(o) != 1:
                        ok = False
                        break
                    owners.append(o[0])
                if not ok:
                    continue
                records.append(dict(
                    master=(bi, ei, fi), corners=corners, mids=mids,
                    center=center, child_faces=child_faces, owners=owners))
    return records


def _balance_marked(mesh: Mesh, marked: set) -> set:
    """2:1 closure: refining the slave side of an NC interface requires the
    master refined too (level difference stays <= 1)."""
    records = nc_quad_records(mesh)
    offsets = np.cumsum([0] + [b.num_elem for b in mesh.buckets])
    changed = True
    while changed:
        changed = False
        for r in records:
            mbi, mei, _ = r["master"]
            mg = int(offsets[mbi]) + mei
            if mg in marked:
                continue
            for (bi, ei, _) in r["owners"]:
                if int(offsets[bi]) + ei in marked:
                    marked.add(mg)
                    changed = True
                    break
    return marked


def refine_hexes(mesh: Mesh, marked_global: np.ndarray) -> Mesh:
    """1->8 refine the marked hex elements (global element ids in bucket
    concatenation order); returns a new Mesh carrying the updated node
    registry, per-element AMR levels, and refined boundary facets."""
    offsets = np.cumsum([0] + [b.num_elem for b in mesh.buckets])
    marked = _balance_marked(mesh, set(int(g) for g in marked_global))
    reg = dict(_registry(mesh))
    levels = _levels(mesh)

    nodes = [mesh.nodes]
    nxt = [mesh.num_nodes]

    def get_node(key, pos):
        nid = reg.get(key)
        if nid is None:
            nid = nxt[0]
            nxt[0] += 1
            reg[key] = nid
            nodes.append(np.asarray(pos, float)[None, :])
        return nid

    new_buckets: List[ElemBucket] = []
    new_levels: List[np.ndarray] = []
    refined_parent_faces: Dict[tuple, int] = {}  # sorted corners -> 1

    for bi, b in enumerate(mesh.buckets):
        sel = np.array([int(offsets[bi]) + e in marked
                        for e in range(b.num_elem)], bool)
        if b.geom is not Geom.HEX or not sel.any():
            new_buckets.append(b)
            new_levels.append(levels[bi])
            continue
        geom_b = ref.gmsh_geometry_basis(b.etype)
        _, gorder, child_ref = ref.gmsh_node_coords(b.etype)
        keep_conn = b.conn[~sel]
        keep_attr = b.attr[~sel]
        keep_lv = levels[bi][~sel]
        kid_conn, kid_attr, kid_lv = [], [], []
        for ei in np.where(sel)[0]:
            conn_e = b.conn[ei]
            corners_e = b.corners[ei]
            Xe = mesh.nodes[conn_e]
            # Seed the registry with the parent's own nodes so children
            # reuse them (corners + hex27 mids at half positions).
            pref = ref.gmsh_node_coords(b.etype)[2]
            for ln, xi in enumerate(pref):
                reg.setdefault(_weight_key(corners_e, xi), int(conn_e[ln]))
            for fverts in HEX_FACES:
                refined_parent_faces[tuple(sorted(
                    int(corners_e[v]) for v in fverts))] = 1
            for (oi, oj, ok) in _CHILD_OFFSETS:
                off = np.array([oi, oj, ok], float) * 0.5
                xi_child = off[None, :] + 0.5 * child_ref  # (nn, 3)
                B = geom_b.eval(xi_child)  # (nn, ngeo)
                pos = B @ Xe
                cids = [get_node(_weight_key(corners_e, xi), p)
                        for xi, p in zip(xi_child, pos)]
                kid_conn.append(cids)
                kid_attr.append(b.attr[ei])
                kid_lv.append(levels[bi][ei] + 1)
        allnodes = np.concatenate(nodes, axis=0)
        nodes = [allnodes]
        conn2 = np.concatenate(
            [keep_conn, np.asarray(kid_conn, b.conn.dtype)], axis=0)
        attr2 = np.concatenate([keep_attr,
                                np.asarray(kid_attr, b.attr.dtype)])
        new_buckets.append(ElemBucket(b.etype, b.geom, b.geo_order,
                                      conn2, attr2))
        new_levels.append(np.concatenate(
            [keep_lv, np.asarray(kid_lv, np.int32)]))

    allnodes = np.concatenate(nodes, axis=0)

    # Refine boundary facets lying on refined parent faces.
    new_bdr: List[ElemBucket] = []
    for bb in mesh.bdr_buckets:
        if bb.geom is not Geom.QUAD:
            new_bdr.append(bb)
            continue
        C = bb.corners
        split = np.array([tuple(sorted(int(x) for x in C[e]))
                          in refined_parent_faces
                          for e in range(bb.num_elem)], bool)
        if not split.any():
            new_bdr.append(bb)
            continue
        _, gorder, qref = ref.gmsh_node_coords(bb.etype)
        gb = ref.gmsh_geometry_basis(bb.etype)
        keep_conn = bb.conn[~split]
        keep_attr = bb.attr[~split]
        kid_conn, kid_attr = [], []
        for ei in np.where(split)[0]:
            conn_e = bb.conn[ei]
            corners_e = [int(x) for x in C[ei]]
            Xe = allnodes[conn_e]
            for (oi, oj) in ((0, 0), (1, 0), (1, 1), (0, 1)):
                off = np.array([oi, oj], float) * 0.5
                uv_child = off[None, :] + 0.5 * qref
                B = gb.eval(uv_child)
                pos = B @ Xe
                cids = []
                for uv, p in zip(uv_child, pos):
                    key = _quad_weight_key(corners_e, uv)
                    nid = reg.get(key)
                    if nid is None:
                        # Node was not created by the volume refinement
                        # (possible only for facet-interior geometry nodes
                        # of hex27-less meshes) — create it.
                        nid = len(allnodes)
                        allnodes = np.concatenate(
                            [allnodes, np.asarray(p, float)[None, :]])
                        reg[key] = nid
                    cids.append(nid)
                kid_conn.append(cids)
                kid_attr.append(bb.attr[ei])
        conn2 = np.concatenate(
            [keep_conn, np.asarray(kid_conn, bb.conn.dtype)], axis=0)
        attr2 = np.concatenate([keep_attr,
                                np.asarray(kid_attr, bb.attr.dtype)])
        new_bdr.append(ElemBucket(bb.etype, bb.geom, bb.geo_order,
                                  conn2, attr2))

    out = Mesh(allnodes, new_buckets, new_bdr, mesh.physical_names)
    out._refine_registry = reg
    out._amr_level = new_levels
    return out
