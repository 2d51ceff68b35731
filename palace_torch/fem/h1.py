"""Arbitrary-order H1 (Lagrange) finite element space on mixed meshes.

Equivalent of the reference solver's H1 FiniteElementSpace (reference:
palace/fem/fespace.hpp:21-135) built on the canonical-key dof numbering of
:mod:`palace_torch.fem.dofmap`: nodal bases on equispaced lattices, so shared
entity dofs coincide geometrically across tets, hexes, and prisms, and the
global numbering follows from key identity alone.

Copied from palace_tpu/fem/h1.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from palace_torch.fem import dofmap, reference as ref
from palace_torch.fem.reference import Geom
from palace_torch.mesh.mesh import Mesh

# Hex corner index from (x, y, z) in {0, 1}^3 (gmsh corner ordering).
_HEX_CORNER = {
    (0, 0, 0): 0, (1, 0, 0): 1, (1, 1, 0): 2, (0, 1, 0): 3,
    (0, 0, 1): 4, (1, 0, 1): 5, (1, 1, 1): 6, (0, 1, 1): 7,
}


@dataclass
class LatticeDof:
    """Classification of one reference lattice node."""

    kind: int
    verts: Tuple[int, ...]  # local vertex indices of the entity
    coords: Tuple[int, ...]  # lattice coords within the entity


def classify_lattice(geom: Geom, p: int) -> List[LatticeDof]:
    """Classify each order-p lattice node by its mesh entity."""
    mi = ref.lattice_multi_index(geom, p)
    out: List[LatticeDof] = []

    if geom is Geom.LINE:
        for (i,) in mi:
            if i == 0:
                out.append(LatticeDof(dofmap.KIND_VERTEX, (0,), ()))
            elif i == p:
                out.append(LatticeDof(dofmap.KIND_VERTEX, (1,), ()))
            else:
                out.append(LatticeDof(dofmap.KIND_EDGE, (0, 1), (i,)))
        return out

    if geom is Geom.TRI:
        for (i, j) in mi:
            b = (p - i - j, i, j)
            nz = [v for v in range(3) if b[v] > 0]
            if len(nz) == 1:
                out.append(LatticeDof(dofmap.KIND_VERTEX, (nz[0],), ()))
            elif len(nz) == 2:
                va, vb = nz
                out.append(LatticeDof(dofmap.KIND_EDGE, (va, vb), (b[vb],)))
            else:
                out.append(LatticeDof(dofmap.KIND_TRI, (0, 1, 2), (b[0], b[1], b[2])))
        return out

    if geom is Geom.QUAD:
        for (i, j) in mi:
            xe = 0 if i == 0 else (1 if i == p else -1)
            ye = 0 if j == 0 else (1 if j == p else -1)
            cidx = {(0, 0): 0, (1, 0): 1, (1, 1): 2, (0, 1): 3}
            if xe >= 0 and ye >= 0:
                out.append(LatticeDof(dofmap.KIND_VERTEX, (cidx[(xe, ye)],), ()))
            elif xe >= 0:  # vertical edge x = const
                v0, v1 = cidx[(xe, 0)], cidx[(xe, 1)]
                out.append(LatticeDof(dofmap.KIND_EDGE, (v0, v1), (j,)))
            elif ye >= 0:
                v0, v1 = cidx[(0, ye)], cidx[(1, ye)]
                out.append(LatticeDof(dofmap.KIND_EDGE, (v0, v1), (i,)))
            else:
                out.append(LatticeDof(dofmap.KIND_QUAD, (0, 1, 2, 3), (i, j)))
        return out

    if geom is Geom.TET:
        for (i, j, k) in mi:
            b = (p - i - j - k, i, j, k)
            nz = [v for v in range(4) if b[v] > 0]
            if len(nz) == 1:
                out.append(LatticeDof(dofmap.KIND_VERTEX, (nz[0],), ()))
            elif len(nz) == 2:
                va, vb = nz
                out.append(LatticeDof(dofmap.KIND_EDGE, (va, vb), (b[vb],)))
            elif len(nz) == 3:
                va, vb, vc = nz
                out.append(
                    LatticeDof(dofmap.KIND_TRI, (va, vb, vc), (b[va], b[vb], b[vc]))
                )
            else:
                out.append(LatticeDof(dofmap.KIND_INTERIOR, (), ()))
        return out

    if geom is Geom.HEX:
        for (i, j, k) in mi:
            es = []
            for c in (i, j, k):
                es.append(0 if c == 0 else (1 if c == p else -1))
            free = [d for d in range(3) if es[d] < 0]
            if not free:
                out.append(
                    LatticeDof(dofmap.KIND_VERTEX, (_HEX_CORNER[tuple(es)],), ())
                )
            elif len(free) == 1:
                d = free[0]
                lo, hi = list(es), list(es)
                lo[d], hi[d] = 0, 1
                v0, v1 = _HEX_CORNER[tuple(lo)], _HEX_CORNER[tuple(hi)]
                out.append(LatticeDof(dofmap.KIND_EDGE, (v0, v1), ((i, j, k)[d],)))
            elif len(free) == 2:
                a, b = free
                base = list(es)
                corners = []
                for (sa, sb) in [(0, 0), (1, 0), (1, 1), (0, 1)]:
                    cc = list(base)
                    cc[a], cc[b] = sa, sb
                    corners.append(_HEX_CORNER[tuple(cc)])
                out.append(
                    LatticeDof(
                        dofmap.KIND_QUAD, tuple(corners), ((i, j, k)[a], (i, j, k)[b])
                    )
                )
            else:
                out.append(LatticeDof(dofmap.KIND_INTERIOR, (), ()))
        return out

    if geom is Geom.PRISM:
        for (i, j, k) in mi:
            b = (p - i - j, i, j)
            nz = [v for v in range(3) if b[v] > 0]
            ke = 0 if k == 0 else (1 if k == p else -1)
            if len(nz) == 1:
                v = nz[0]
                if ke >= 0:
                    out.append(LatticeDof(dofmap.KIND_VERTEX, (v + 3 * ke,), ()))
                else:
                    out.append(LatticeDof(dofmap.KIND_EDGE, (v, v + 3), (k,)))
            elif len(nz) == 2:
                va, vb = nz
                if ke >= 0:
                    out.append(
                        LatticeDof(
                            dofmap.KIND_EDGE, (va + 3 * ke, vb + 3 * ke), (b[vb],)
                        )
                    )
                else:
                    # quad face: cyclic (va_bot, vb_bot, vb_top, va_top);
                    # s along tri edge from va, t vertical.
                    out.append(
                        LatticeDof(
                            dofmap.KIND_QUAD, (va, vb, vb + 3, va + 3), (b[vb], k)
                        )
                    )
            else:
                if ke >= 0:
                    vs = (3 * ke, 1 + 3 * ke, 2 + 3 * ke)
                    out.append(LatticeDof(dofmap.KIND_TRI, vs, (b[0], b[1], b[2])))
                else:
                    out.append(LatticeDof(dofmap.KIND_INTERIOR, (), ()))
        return out

    raise ValueError(geom)


def _bucket_keys(corners: np.ndarray, dofs: List[LatticeDof], p: int,
                 bucket_id: int) -> np.ndarray:
    """Keys for all (element, local dof) pairs of one bucket: (E * nd, 7),
    ordered dof-major within element (reshapeable to (E, nd, 7))."""
    E = corners.shape[0]
    keys = np.empty((E, len(dofs), 7), np.int64)
    interior_counter = 0
    eids = np.arange(E)
    for n, d in enumerate(dofs):
        if d.kind == dofmap.KIND_VERTEX:
            keys[:, n] = dofmap.vertex_keys(corners[:, d.verts[0]])
        elif d.kind == dofmap.KIND_EDGE:
            keys[:, n] = dofmap.edge_keys(
                corners[:, d.verts[0]], corners[:, d.verts[1]],
                np.full(E, d.coords[0]), p,
            )
        elif d.kind == dofmap.KIND_TRI:
            vids = corners[:, list(d.verts)]
            bary = np.tile(np.array(d.coords, np.int64), (E, 1))
            keys[:, n] = dofmap.tri_keys(vids, bary)
        elif d.kind == dofmap.KIND_QUAD:
            vids = corners[:, list(d.verts)]
            s = np.full(E, d.coords[0])
            t = np.full(E, d.coords[1])
            keys[:, n] = dofmap.quad_keys(vids, s, t, p)
        else:
            keys[:, n] = dofmap.interior_keys(
                bucket_id, eids, np.full(E, interior_counter)
            )
            interior_counter += 1
    return keys.reshape(E * len(dofs), 7)


class H1Space:
    """Scalar continuous Lagrange space of order p on a (mixed) mesh."""

    def __init__(self, mesh: Mesh, order: int):
        self.mesh = mesh
        self.order = order
        self.classified = {
            b.geom: classify_lattice(b.geom, order) for b in mesh.buckets
        }
        all_keys = []
        shapes = []
        for bid, b in enumerate(mesh.buckets):
            dofs = self.classified[b.geom]
            k = _bucket_keys(mesh.topo_ids(b.corners).astype(np.int64),
                             dofs, order, bid)
            all_keys.append(k)
            shapes.append((b.num_elem, len(dofs)))
        cat = np.concatenate(all_keys)
        self.num_dofs, ids, self.unique_keys = dofmap.number_dofs(cat)
        self.elem_dofs: List[np.ndarray] = []
        ofs = 0
        for (E, nd) in shapes:
            self.elem_dofs.append(ids[ofs : ofs + E * nd].reshape(E, nd))
            ofs += E * nd

    # -- basis tables --------------------------------------------------------

    def basis(self, geom: Geom) -> ref.NodalBasis:
        return ref.nodal_basis(geom, self.order,
                               ref.fem_nodes(geom, self.order))

    # -- boundary dofs --------------------------------------------------------

    def boundary_dofs(self, attrs: Sequence[int]) -> np.ndarray:
        """Global dofs on boundary elements with the given attributes
        (the closure: vertex, edge, and face dofs of those facets)."""
        attrs = set(int(a) for a in attrs)
        found = []
        p = self.order
        for b in self.mesh.bdr_buckets:
            sel = np.isin(b.attr, list(attrs))
            if not sel.any():
                continue
            corners = self.mesh.topo_ids(b.corners[sel]).astype(np.int64)
            dofs = classify_lattice(b.geom, p)
            keys = _bucket_keys(corners, dofs, p, -1)
            # Facet-interior dofs are the volume face dofs: KIND_TRI/KIND_QUAD
            # keys match those generated by volume elements directly; vertex
            # and edge keys match trivially. (Facets have no KIND_INTERIOR.)
            ids = dofmap.lookup_keys(self.unique_keys, keys)
            if (ids < 0).any():
                raise RuntimeError(
                    "boundary facet dof not found in volume space "
                    "(non-conforming mesh or attribute mismatch?)"
                )
            found.append(ids)
        if not found:
            return np.zeros(0, np.int32)
        return np.unique(np.concatenate(found)).astype(np.int32)

    def dof_coordinates(self) -> np.ndarray:
        """(ndof, sdim) physical coordinates of each (nodal) dof."""
        sdim = self.mesh.nodes.shape[1]
        out = np.zeros((self.num_dofs, sdim))
        for b, ed in zip(self.mesh.buckets, self.elem_dofs):
            gb = ref.gmsh_geometry_basis(b.etype)
            lat = ref.fem_nodes(b.geom, self.order)
            B = gb.eval(lat)  # (nd, ngeo)
            X = self.mesh.nodes[b.conn]  # (E, ngeo, sdim)
            xd = np.einsum("nk,eks->ens", B, X)
            out[ed.reshape(-1)] = xd.reshape(-1, sdim)
        return out
