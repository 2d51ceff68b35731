"""Hanging-node constraints for H1 spaces on nonconforming (hex-AMR)
meshes.

The reference hides hanging dofs behind MFEM's conforming prolongation
(P in A_true = P^T A P, reference: palace/linalg/rap.hpp:18-39 with the
NC ParMesh of basesolver.cpp:247).  Here the same P is built explicitly
from the NC quad/edge records of mesh/refine_hex.py: every slave dof
(a fine-side dof on a coarser neighbor's face or edge) is the
interpolation of the master's trace polynomial at the slave's reference
position — exact rational bookkeeping, no geometric tolerance games.

`h1_hanging_matrix(space, mesh)` returns (P, true_idx) with P of shape
(n_dofs, n_true), or (None, None) on conforming meshes.

Copied from palace_tpu/fem/hanging.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from palace_torch.fem import reference as ref
from palace_torch.fem.reference import Geom

_TOL = 1e-10


def _hex_face_dofs(p: int, fi: int) -> Tuple[np.ndarray, np.ndarray]:
    """(local dof ids, (u, v) face-frame ref coords) of the hex H1 dofs on
    face fi; u along corner0->corner1, v along corner0->corner3 of
    GEOM_FACES[HEX][fi]."""
    X = ref.fem_nodes(Geom.HEX, p)  # (nd, 3)
    fverts = ref.GEOM_FACES[Geom.HEX][fi]
    V = ref.GEOM_VERTICES[Geom.HEX][list(fverts)]
    o = V[0]
    eu = V[1] - V[0]
    ev = V[3] - V[0]
    nrm = np.cross(eu, ev)
    on = np.abs((X - o) @ nrm) < _TOL
    ids = np.where(on)[0]
    uv = np.stack([(X[ids] - o) @ eu / (eu @ eu),
                   (X[ids] - o) @ ev / (ev @ ev)], axis=1)
    return ids, uv


def _hex_edge_dofs(p: int, a: int, b: int) -> Tuple[np.ndarray, np.ndarray]:
    """(local dof ids, t in [0,1]) of the hex H1 dofs on the edge from
    local vertex a to local vertex b."""
    X = ref.fem_nodes(Geom.HEX, p)
    V = ref.GEOM_VERTICES[Geom.HEX]
    o, e = V[a], V[b] - V[a]
    t = (X - o) @ e / (e @ e)
    d2 = np.sum((X - (o + np.clip(t, 0, 1)[:, None] * e)) ** 2, axis=1)
    on = (d2 < _TOL) & (t > -_TOL) & (t < 1 + _TOL)
    ids = np.where(on)[0]
    return ids, t[ids]


def _quad_basis(p: int):
    return ref.nodal_basis(Geom.QUAD, p, ref.fem_nodes(Geom.QUAD, p))


def _line_basis(p: int):
    return ref.nodal_basis(Geom.LINE, p, ref.fem_nodes(Geom.LINE, p))


def nc_edge_records(mesh) -> List[dict]:
    """Hanging EDGES not covered by a face record: a coarse element edge
    (a, b) whose registry midpoint m exists and whose half edges (a, m),
    (m, b) are element edges of refined neighbors (e.g. diagonal-only
    adjacency).  Record the coarse owner for trace interpolation."""
    from palace_torch.mesh.refine_hex import _quad_weight_key  # 1D degenerates

    reg = getattr(mesh, "_refine_registry", None)
    if not reg:
        return []
    edges: Dict[tuple, List[Tuple[int, int, int]]] = {}
    for bi, b in enumerate(mesh.buckets):
        if b.geom is not Geom.HEX:
            continue
        C = b.corners
        for li, (va, vb) in enumerate(ref.GEOM_EDGES[Geom.HEX]):
            pair = np.sort(C[:, [va, vb]], axis=1)
            for ei in range(b.num_elem):
                edges.setdefault((int(pair[ei, 0]), int(pair[ei, 1])),
                                 []).append((bi, ei, li))
    out = []
    for (a, b), owners in edges.items():
        mk = tuple(sorted(((a, 32), (b, 32))))
        m = reg.get(mk)
        if m is None:
            continue
        ka = (min(a, m), max(a, m))
        kb = (min(m, b), max(m, b))
        if ka in edges or kb in edges:
            out.append(dict(edge=(a, b), mid=m, owner=owners[0]))
    return out


def h1_hanging_matrix(space, mesh
                      ) -> Tuple[Optional[sp.csr_matrix],
                                 Optional[np.ndarray]]:
    """Conforming prolongation P (n x n_true) for an H1 space on an NC hex
    mesh; (None, None) when the mesh is conforming."""
    from palace_torch.mesh.refine_hex import nc_quad_records

    records = nc_quad_records(mesh)
    e_records = nc_edge_records(mesh)
    if not records and not e_records:
        return None, None
    p = space.order
    n = space.num_dofs
    Bq = _quad_basis(p)
    Bl = _line_basis(p)
    Xq = ref.fem_nodes(Geom.QUAD, p)
    Xl = ref.fem_nodes(Geom.LINE, p)

    # slave global dof -> {master global dof: weight}
    constraints: Dict[int, Dict[int, float]] = {}

    uv_of_node: Dict[int, tuple] = {}

    for r in records:
        mbi, mei, mfi = r["master"]
        mids_loc, muv = _hex_face_dofs(p, mfi)
        mg = space.elem_dofs[mbi][mei][mids_loc]
        # map master face dofs onto the QUAD reference lattice ordering
        quad_master = np.full(len(Xq), -1, np.int64)
        for qi, xq in enumerate(Xq):
            hit = np.where(np.all(np.abs(muv - xq) < _TOL, axis=1))[0]
            quad_master[qi] = mg[hit[0]]
        master_set = set(int(g) for g in mg)

        # known master-face (u, v) of the record's nine nodes
        cuv = {r["corners"][0]: (0.0, 0.0), r["corners"][1]: (1.0, 0.0),
               r["corners"][2]: (1.0, 1.0), r["corners"][3]: (0.0, 1.0),
               r["mids"][0]: (0.5, 0.0), r["mids"][1]: (1.0, 0.5),
               r["mids"][2]: (0.5, 1.0), r["mids"][3]: (0.0, 0.5),
               r["center"]: (0.5, 0.5)}

        for cf, (sbi, sei, sfi) in zip(r["child_faces"], r["owners"]):
            sids_loc, suv = _hex_face_dofs(p, sfi)
            sg = space.elem_dofs[sbi][sei][sids_loc]
            # child-face corner ids in ITS face frame order
            sb = mesh.buckets[sbi]
            sfverts = ref.GEOM_FACES[Geom.HEX][sfi]
            c_ids = [int(sb.corners[sei, v]) for v in sfverts]
            UV = np.array([cuv[c] for c in c_ids])  # (4, 2)
            # bilinear map child (s, t) -> master (u, v)
            s, t = suv[:, 0], suv[:, 1]
            mu = ((1 - s) * (1 - t))[:, None] * UV[0] \
                + (s * (1 - t))[:, None] * UV[1] \
                + (s * t)[:, None] * UV[2] \
                + ((1 - s) * t)[:, None] * UV[3]
            W = Bq.eval(mu)  # (m, ndq)
            for k, g in enumerate(sg):
                g = int(g)
                if g in master_set or g in constraints:
                    continue
                row = {}
                for qi, w in enumerate(W[k]):
                    if abs(w) > 1e-13:
                        row[int(quad_master[qi])] = float(w)
                constraints[g] = row

    for r in e_records:
        (a, b), m = r["edge"], r["mid"]
        obi, oei, oli = r["owner"]
        va, vb = ref.GEOM_EDGES[Geom.HEX][oli]
        ob = mesh.buckets[obi]
        # orient: owner's local edge endpoints vs (a, b)
        if int(ob.corners[oei, va]) == a:
            pass
        else:
            va, vb = vb, va
        eids_loc, tref = _hex_edge_dofs(p, va, vb)
        eg = space.elem_dofs[obi][oei][eids_loc]
        line_master = np.full(len(Xl), -1, np.int64)
        for qi, xl in enumerate(Xl):
            hit = np.where(np.abs(tref - xl[0]) < _TOL)[0]
            line_master[qi] = eg[hit[0]]
        master_set = set(int(g) for g in eg)
        # fine-side dofs on the two half edges: find elements owning the
        # half edges and take their edge dofs, mapped t -> global param.
        halfs = [((a, m), lambda t: 0.5 * t), ((m, b), lambda t: 0.5 + 0.5 * t)]
        for (ha, hb), tmap in halfs:
            for sbi, sb in enumerate(mesh.buckets):
                if sb.geom is not Geom.HEX:
                    continue
                C = sb.corners
                for li, (wa, wb) in enumerate(ref.GEOM_EDGES[Geom.HEX]):
                    match = np.where(
                        ((C[:, wa] == ha) & (C[:, wb] == hb))
                        | ((C[:, wa] == hb) & (C[:, wb] == ha)))[0]
                    for sei in match:
                        fw = int(C[sei, wa]) == ha
                        pa, pb = (wa, wb) if fw else (wb, wa)
                        sids_loc, st = _hex_edge_dofs(p, pa, pb)
                        sg = space.elem_dofs[sbi][sei][sids_loc]
                        tg = tmap(st)
                        W = Bl.eval(tg[:, None])  # (m, p+1)
                        for k, g in enumerate(sg):
                            g = int(g)
                            if g in master_set or g in constraints:
                                continue
                            row = {}
                            for qi, w in enumerate(W[k]):
                                if abs(w) > 1e-13:
                                    row[int(line_master[qi])] = float(w)
                            constraints[g] = row

    if not constraints:
        return None, None

    # Transitive closure: a master referenced by a slave row may itself be
    # a slave (bounded level chains); substitute until fixed point.
    for _ in range(64):
        changed = False
        for g, row in list(constraints.items()):
            if not any(mgl in constraints for mgl in row):
                continue
            new: Dict[int, float] = {}
            for mgl, w in row.items():
                if mgl in constraints:
                    for g2, w2 in constraints[mgl].items():
                        new[g2] = new.get(g2, 0.0) + w * w2
                else:
                    new[mgl] = new.get(mgl, 0.0) + w
            constraints[g] = new
            changed = True
        if not changed:
            break
    else:
        raise RuntimeError("hanging-constraint closure did not terminate")

    slaves = np.array(sorted(constraints), np.int64)
    is_slave = np.zeros(n, bool)
    is_slave[slaves] = True
    true_idx = np.where(~is_slave)[0]
    col_of = np.full(n, -1, np.int64)
    col_of[true_idx] = np.arange(len(true_idx))
    rows, cols, vals = [], [], []
    rows.extend(true_idx)
    cols.extend(col_of[true_idx])
    vals.extend(np.ones(len(true_idx)))
    for g, row in constraints.items():
        for mgl, w in row.items():
            assert col_of[mgl] >= 0, "slave master must be a true dof"
            rows.append(g)
            cols.append(col_of[mgl])
            vals.append(w)
    P = sp.coo_matrix((vals, (rows, cols)),
                      shape=(n, len(true_idx))).tocsr()
    return P, true_idx
