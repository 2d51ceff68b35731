"""Internal-boundary cracking: decouple the two sides of interior BC sheets.

The reference duplicates mesh vertices across internal boundary elements
carrying boundary conditions (PEC sheets, impedance films, ...) so that the
finite element spaces on either side are fully decoupled — tangential fields
may jump across the sheet, and boundary integrals (impedance, postprocessing)
see each side's own one-sided trace (reference:
palace/utils/geodata.cpp:2814-3190, CrackInternalBoundaryElements inside
AddInterfaceBdrElements).  Lumped-port attributes are excluded (the port
voltage/current definitions require a single-valued field across the sheet,
reference: geodata.cpp:2814-2833).

Algorithm (same topology rules as the reference, re-done on the
struct-of-arrays mesh):

1. Crack facets = interior (two-owner) boundary facets whose attribute is in
   the crack list.  Exterior facets with those attributes are left alone.
2. For every geometry node appearing on a crack facet, partition the elements
   containing it into connected components, where element adjacency is
   through shared interior facets EXCLUDING crack facets.  Component 0 keeps
   the original node id; each further component gets a duplicated node
   (correctly handles junctions of >2 domains and crack seams, where the rim
   node has a single component and is not duplicated).  Running over ALL
   geometry nodes (not just corner vertices) preserves curved geometry.
3. Boundary facet connectivities are rebuilt from their owner elements after
   renumbering; cracked facets are emitted twice, once per side, keeping the
   original node order (and thus the original normal convention) so each copy
   integrates its own side's trace.

The reference additionally bisects elements around "interior seam edges"
(an edge of the crack surface interior whose endpoints are both seam
vertices; reference: geodata.cpp:2905-3010 refine_crack_elements) because
such an edge cannot be decoupled by vertex duplication alone.  We detect and
report those via `CrackInfo.n_interior_seam_edges`; the local conforming
bisection itself is not implemented yet.

Copied from palace_tpu/mesh/crack.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from palace_torch.fem import reference as ref
from palace_torch.mesh.mesh import ElemBucket, Mesh


@dataclass
class CrackInfo:
    cracked_attrs: Set[int] = field(default_factory=set)
    n_dup_nodes: int = 0
    n_crack_facets: int = 0
    n_interior_seam_edges: int = 0
    # Vertex pairs (original mesh node ids) of edges interior to the crack
    # whose endpoints are both seam vertices: these stay coupled unless the
    # surrounding elements are bisected (see local_edge_split).
    interior_seam_edges: List[Tuple[int, int]] = field(default_factory=list)
    # Duplicated node id -> original node id (coincident coordinates).
    dup_to_orig: Dict[int, int] = field(default_factory=dict)
    # Owner (global) element ids of the crack facets adjacent to interior
    # seam edges — the reference's elem_to_refine set (geodata.cpp:3067-
    # 3082: both face-neighbors of every seam-adjacent boundary element).
    seam_refine_elems: List[int] = field(default_factory=list)


def _facet_defs(geom) -> List[Tuple[int, ...]]:
    """Corner-index tuples of the codim-1 facets of a domain geometry."""
    if ref.GEOM_DIM[geom] == 3:
        return [tuple(f) for f in ref.GEOM_FACES[geom]]
    return [tuple(e) for e in ref.GEOM_EDGES[geom]]


def _facet_key(verts: Sequence[int]) -> Tuple[int, ...]:
    return tuple(sorted(int(v) for v in verts))


def crack_internal_boundaries(mesh: Mesh, crack_attrs: Sequence[int]
                              ) -> Tuple[Mesh, CrackInfo]:
    """Return a cracked copy of `mesh` (and what was done).  No-op (returns
    the input mesh) when no interior facet carries a crackable attribute."""
    info = CrackInfo()
    crack_attrs = set(int(a) for a in crack_attrs)
    if not crack_attrs:
        return mesh, info
    dim = mesh.dim
    codim_geom_dim = dim - 1

    # --- global element ids over domain buckets
    offsets = np.cumsum([0] + [b.num_elem for b in mesh.buckets])

    # --- facet -> owner elements (and facet adjacency)
    facet_owners: Dict[Tuple[int, ...], List[int]] = {}
    for bi, b in enumerate(mesh.buckets):
        corners = b.corners
        for fdef in _facet_defs(b.geom):
            keys = np.sort(corners[:, list(fdef)].astype(np.int64), axis=-1)
            for e in range(b.num_elem):
                facet_owners.setdefault(tuple(keys[e]), []).append(
                    int(offsets[bi]) + e)

    # --- crack facet set (interior facets with crackable attributes)
    crack_keys: Set[Tuple[int, ...]] = set()
    for b in mesh.bdr_buckets:
        if ref.GEOM_DIM[b.geom] != codim_geom_dim:
            continue
        for e in range(b.num_elem):
            if int(b.attr[e]) not in crack_attrs:
                continue
            key = _facet_key(b.corners[e])
            owners = facet_owners.get(key, ())
            if len(owners) == 2:
                crack_keys.add(key)
                info.cracked_attrs.add(int(b.attr[e]))
    info.n_crack_facets = len(crack_keys)
    if not crack_keys:
        return mesh, info

    # --- element adjacency through interior non-crack facets
    adj: Dict[int, List[int]] = {}
    for key, owners in facet_owners.items():
        if len(owners) == 2 and key not in crack_keys:
            a, b_ = owners
            adj.setdefault(a, []).append(b_)
            adj.setdefault(b_, []).append(a)

    # --- node -> elements incidence over ALL geometry nodes
    node_elems: Dict[int, List[int]] = {}
    crack_nodes: Set[int] = set()
    for b in mesh.bdr_buckets:
        if ref.GEOM_DIM[b.geom] != codim_geom_dim:
            continue
        for e in range(b.num_elem):
            if _facet_key(b.corners[e]) in crack_keys:
                crack_nodes.update(int(n) for n in b.conn[e])
    for bi, b in enumerate(mesh.buckets):
        base = int(offsets[bi])
        for e, row in enumerate(b.conn):
            ge = base + e
            for n in row:
                n = int(n)
                if n in crack_nodes:
                    node_elems.setdefault(n, []).append(ge)

    # --- per-node component split (BFS excluding crack-facet adjacency)
    new_nodes = [mesh.nodes]
    next_id = mesh.nodes.shape[0]
    # element renumber instructions: gid -> {old_node: new_node}
    renum: Dict[int, Dict[int, int]] = {}
    seam_nodes: Set[int] = set()
    for n in sorted(crack_nodes):
        star = node_elems.get(n, [])
        star_set = set(star)
        unvisited = set(star)
        components: List[List[int]] = []
        while unvisited:
            seed = unvisited.pop()
            comp = [seed]
            queue = [seed]
            while queue:
                e = queue.pop()
                for nbr in adj.get(e, ()):
                    if nbr in unvisited and nbr in star_set:
                        unvisited.discard(nbr)
                        comp.append(nbr)
                        queue.append(nbr)
            components.append(comp)
        if len(components) == 1:
            seam_nodes.add(n)
            continue
        for comp in components[1:]:
            dup = next_id
            next_id += 1
            new_nodes.append(mesh.nodes[n][None])
            info.n_dup_nodes += 1
            info.dup_to_orig[dup] = n
            for ge in comp:
                renum.setdefault(ge, {})[n] = dup

    # --- interior seam edges (reference would locally bisect; we report)
    edge_count: Dict[Tuple[int, int], int] = {}
    edge_facets: Dict[Tuple[int, int], List[Tuple[int, ...]]] = {}
    for b in mesh.bdr_buckets:
        if ref.GEOM_DIM[b.geom] != codim_geom_dim:
            continue
        edges = ref.GEOM_EDGES[b.geom] if codim_geom_dim == 2 else [(0, 1)]
        for e in range(b.num_elem):
            fkey = _facet_key(b.corners[e])
            if fkey not in crack_keys:
                continue
            cs = b.corners[e]
            for (i, j) in edges:
                v0, v1 = int(cs[i]), int(cs[j])
                if v0 in seam_nodes and v1 in seam_nodes:
                    k = (min(v0, v1), max(v0, v1))
                    edge_count[k] = edge_count.get(k, 0) + 1
                    edge_facets.setdefault(k, []).append(fkey)
    info.interior_seam_edges = sorted(
        k for k, c in edge_count.items() if c > 1)
    info.n_interior_seam_edges = len(info.interior_seam_edges)
    refine: Set[int] = set()
    for k in info.interior_seam_edges:
        for fkey in edge_facets[k]:
            refine.update(facet_owners.get(fkey, ()))
    info.seam_refine_elems = sorted(refine)

    # --- apply renumbering to domain conns
    new_buckets = []
    for bi, b in enumerate(mesh.buckets):
        conn = b.conn.copy()
        base = int(offsets[bi])
        for ge, mapping in renum.items():
            if base <= ge < base + b.num_elem:
                row = conn[ge - base]
                for k in range(len(row)):
                    row[k] = mapping.get(int(row[k]), int(row[k]))
        new_buckets.append(ElemBucket(b.etype, b.geom, b.geo_order, conn,
                                      b.attr.copy()))

    # --- rebuild boundary facet conns from (renumbered) owner elements
    old_conn_pos: Dict[int, Dict[int, int]] = {}

    def owner_positions(ge: int, nodes: np.ndarray) -> np.ndarray:
        lut = old_conn_pos.get(ge)
        if lut is None:
            bi = int(np.searchsorted(offsets, ge, side="right")) - 1
            row = mesh.buckets[bi].conn[ge - int(offsets[bi])]
            lut = {int(v): k for k, v in enumerate(row)}
            old_conn_pos[ge] = lut
        return np.array([lut[int(v)] for v in nodes], np.int64)

    def new_row(ge: int, pos: np.ndarray) -> np.ndarray:
        bi = int(np.searchsorted(offsets, ge, side="right")) - 1
        return new_buckets[bi].conn[ge - int(offsets[bi])][pos]

    new_bdr = []
    for b in mesh.bdr_buckets:
        if ref.GEOM_DIM[b.geom] != codim_geom_dim:
            new_bdr.append(b)
            continue
        conns, attrs = [], []
        for e in range(b.num_elem):
            key = _facet_key(b.corners[e])
            owners = facet_owners.get(key, ())
            if not owners:
                conns.append(b.conn[e])
                attrs.append(b.attr[e])
                continue
            sides = owners if key in crack_keys else owners[:1]
            for ge in sides:
                pos = owner_positions(ge, b.conn[e])
                conns.append(new_row(ge, pos))
                attrs.append(b.attr[e])
        new_bdr.append(ElemBucket(b.etype, b.geom, b.geo_order,
                                  np.asarray(conns, np.int32),
                                  np.asarray(attrs, np.int32)))

    out = Mesh(np.concatenate(new_nodes), new_buckets, new_bdr,
               mesh.physical_names)
    return out, info


def local_edge_split(mesh: Mesh, edges: Sequence[Tuple[int, int]]) -> Mesh:
    """Bisect the ring of elements around each given edge (vertex pair).

    The purely local conforming edge-fan split used by the reference to
    resolve crack seam edges (reference: palace/utils/geodata.cpp:3110-3126
    LocalEdgeSplit, mesh.cpp): each element containing both endpoints is
    replaced by two children sharing the edge midpoint; boundary facets
    containing the edge split likewise.  Sequentially conforming: no global
    closure is needed because only faces containing the split edge change,
    and they change identically in every adjacent element.

    Simplex (tet/tri domain) straight-sided meshes only — matching the
    reference, which converts to simplices before crack refinement
    (geodata.cpp:3055-3060).
    """
    for b in mesh.buckets:
        if b.geom not in (ref.Geom.TET, ref.Geom.TRI) or b.geo_order != 1:
            raise NotImplementedError(
                "local_edge_split requires a straight-sided simplex mesh")

    nodes: List[np.ndarray] = [mesh.nodes]
    next_id = mesh.nodes.shape[0]

    def explode(buckets):
        """Per-bucket dict stores + node incidence."""
        stores = []
        for b in buckets:
            rows = {e: b.conn[e].astype(np.int64) for e in range(b.num_elem)}
            attrs = {e: int(b.attr[e]) for e in range(b.num_elem)}
            incid: Dict[int, Set[int]] = {}
            for e, row in rows.items():
                for v in row:
                    incid.setdefault(int(v), set()).add(e)
            stores.append([b, rows, attrs, incid, b.num_elem])
        return stores

    dom = explode(mesh.buckets)
    bdr = explode([b for b in mesh.bdr_buckets])

    for (a, c) in edges:
        mid = next_id
        next_id += 1
        nodes.append(0.5 * (mesh.nodes[a] + mesh.nodes[c])[None])
        for store in dom + bdr:
            _, rows, attrs, incid, _ = store
            ring = incid.get(a, set()) & incid.get(c, set())
            for eid in sorted(ring):
                row = rows.pop(eid)
                at = attrs.pop(eid)
                for v in row:
                    incid[int(v)].discard(eid)
                for old in (a, c):
                    child = row.copy()
                    child[child == old] = mid
                    cid = store[4]
                    store[4] += 1
                    rows[cid] = child
                    attrs[cid] = at
                    for v in child:
                        incid.setdefault(int(v), set()).add(cid)

    def collect(stores):
        out = []
        for b, rows, attrs, _, _ in stores:
            keys = sorted(rows)
            conn = np.array([rows[k] for k in keys], np.int32)
            attr = np.array([attrs[k] for k in keys], np.int32)
            out.append(ElemBucket(b.etype, b.geom, b.geo_order, conn, attr))
        return out

    return Mesh(np.concatenate(nodes), collect(dom), collect(bdr),
                mesh.physical_names)


def bc_attributes(iodata) -> List[int]:
    """All boundary-condition attributes (reference:
    palace/utils/configfile.cpp:940-977 BoundaryData attribute collection)."""
    bc = iodata.boundaries
    attrs: List[int] = []
    # Ground/ZeroCharge merge into PEC/PMC in the reference; electrostatic
    # Terminal attributes are a separate map and are NOT collected.
    attrs += list(bc.pec) + list(bc.pmc) + list(bc.ground)
    attrs += list(bc.zero_charge) + list(bc.wave_port_pec)
    for z in bc.impedances:
        attrs += list(z.attributes)
    for c in bc.conductivities:
        attrs += list(c.attributes)
    if bc.absorbing is not None:
        attrs += list(bc.absorbing.attributes)
    for p in bc.lumped_ports:
        for el in p.elements:
            attrs += list(el.attributes)
    for w in bc.wave_ports:
        attrs += list(w.attributes)
    for s in bc.surface_currents:
        attrs += list(s.attributes)
        for el in s.elements:
            attrs += list(el["attributes"] if isinstance(el, dict)
                          else el.attributes)
    return sorted(set(int(a) for a in attrs))


def crack_attributes(iodata) -> List[int]:
    """BC attributes eligible for cracking: everything except lumped-port
    element attributes (reference: geodata.cpp:2814-2833)."""
    exclude: Set[int] = set()
    for p in iodata.boundaries.lumped_ports:
        for el in p.elements:
            exclude.update(int(a) for a in el.attributes)
    return [a for a in bc_attributes(iodata) if a not in exclude]
