"""COMSOL (.mphtxt/.mphbin) and Nastran (.nas/.bdf) mesh readers.

Produces the same raw structure as the Gmsh reader (GmshMesh) so
`load_mesh` can treat every format uniformly (the reference converts these
formats to an in-memory Gmsh file instead: palace/utils/meshio.cpp
ConvertMeshComsol / ConvertMeshNastran; the element-type maps and node
ordering conventions below are format facts documented there and in the
Gmsh/COMSOL/Nastran manuals).

Attribute conventions (meshio.cpp:838-847): COMSOL geometric entity indices
are 0-based for boundary elements and 1-based for domain elements, so
boundary attributes get +1; Nastran attributes are the (1-based) property
ids of the element cards.

Copied from palace_tpu/mesh/convert.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Tuple

import numpy as np

from palace_torch.mesh.gmsh import GMSH_NUM_NODES, GmshMesh

# COMSOL type name -> (gmsh element type, element dimension)
_COMSOL_TYPES = {
    "vtx": (15, 0),
    "edg": (1, 1), "edg2": (8, 1),
    "tri": (2, 2), "tri2": (9, 2),
    "quad": (3, 2), "quad2": (10, 2),
    "tet": (4, 3), "tet2": (11, 3),
    "hex": (5, 3), "hex2": (12, 3),
    "prism": (6, 3), "prism2": (13, 3),
    "pyr": (7, 3), "pyr2": (14, 3),
}

# gmsh slot <- file slot scatter: conn_gmsh[:, perm] = conn_file
_COMSOL_PERM = {
    3: [0, 1, 3, 2],
    5: [0, 1, 3, 2, 4, 5, 7, 6],
    7: [0, 1, 3, 2, 4],
    9: [0, 1, 2, 3, 5, 4],
    10: [0, 1, 3, 2, 4, 7, 8, 5, 6],
    11: [0, 1, 2, 3, 4, 6, 5, 7, 9, 8],
    12: [0, 1, 3, 2, 4, 5, 7, 6, 8, 9, 20, 11, 13, 10, 21, 12, 22, 26, 23,
         15, 24, 14, 16, 17, 25, 18, 19],
    13: [0, 1, 2, 3, 4, 5, 6, 7, 9, 8, 15, 10, 16, 17, 11, 12, 13, 14],
    14: [0, 1, 3, 2, 4, 5, 6, 13, 8, 10, 7, 9, 12, 11],
}

# Nastran keyword -> low-order gmsh type
_NASTRAN_TYPES = {
    "CTRIA": 2, "CQUAD": 3, "CTETRA": 4, "CHEXA": 5, "CPENTA": 6,
    "CPYRAM": 7,
}

# (low-order gmsh type, node count) -> high-order gmsh type
_NASTRAN_HO = {
    (2, 6): 9, (3, 9): 10, (3, 8): 16, (4, 10): 11, (5, 20): 17,
    (6, 15): 18, (7, 13): 19,
}

_NASTRAN_PERM = {
    11: [0, 1, 2, 3, 4, 5, 6, 7, 9, 8],
    17: [0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 13, 9, 10, 12, 14, 15, 16, 18,
         19, 17],
    18: [0, 1, 2, 3, 4, 5, 6, 9, 7, 8, 10, 11, 12, 14, 13],
    19: [0, 1, 2, 3, 4, 5, 8, 10, 6, 7, 9, 11, 12],
}


# ---------------------------------------------------------------------------
# COMSOL


def _comsol_tokens_ascii(path: str):
    """Token stream: '#' starts a comment, strings are length-prefixed."""
    with open(path, "r", errors="replace") as f:
        for line in f:
            body = line.split("#", 1)[0]
            yield from body.split()


class _ComsolBinary:
    """Sequential binary scanner (.mphbin): little-endian i32/f64, strings
    as i32 length + raw bytes."""

    def __init__(self, path: str):
        self.buf = open(path, "rb").read()
        self.pos = 0

    def ints(self, n: int) -> List[int]:
        out = struct.unpack_from(f"<{n}i", self.buf, self.pos)
        self.pos += 4 * n
        return list(out)

    def doubles(self, n: int) -> List[float]:
        out = struct.unpack_from(f"<{n}d", self.buf, self.pos)
        self.pos += 8 * n
        return list(out)

    def string(self) -> str:
        (n,) = struct.unpack_from("<i", self.buf, self.pos)
        self.pos += 4
        s = self.buf[self.pos:self.pos + n].decode("ascii", "replace")
        self.pos += n
        return s


def read_comsol(path: str) -> GmshMesh:
    binary = path.lower().endswith(".mphbin")
    if binary:
        bf = _ComsolBinary(path)
        # Header: version (2 ints), #tags + tags, #types + types,
        # then the serialized object record.
        bf.ints(2)
        for _ in range(bf.ints(1)[0]):
            bf.string()
        for _ in range(bf.ints(1)[0]):
            bf.string()
        bf.ints(3)  # object class signature "0 0 1"
        assert bf.string().lower() == "mesh", "not a COMSOL Mesh object"
        bf.ints(1)  # object version
        sdim = bf.ints(1)[0]
        num_nodes = bf.ints(1)[0]
        start = bf.ints(1)[0]
        coords = np.array(bf.doubles(sdim * num_nodes)).reshape(num_nodes,
                                                                sdim)
        num_types = bf.ints(1)[0]

        def next_string():
            return bf.string()

        def next_ints(n):
            return bf.ints(n)
    else:
        toks = _comsol_tokens_ascii(path)

        def tok():
            return next(toks)

        def next_string():
            n = int(tok())
            return tok() if n else ""

        # version
        tok(), tok()
        for _ in range(int(tok())):  # tags
            next_string()
        for _ in range(int(tok())):  # types
            next_string()
        tok(), tok(), tok()  # object class signature "0 0 1"
        assert next_string().lower() == "mesh", "not a COMSOL Mesh object"
        tok()  # object version
        sdim = int(tok())
        num_nodes = int(tok())
        start = int(tok())
        coords = np.fromiter(
            (float(tok()) for _ in range(num_nodes * sdim)), np.float64
        ).reshape(num_nodes, sdim)
        num_types = int(tok())

        def next_ints(n):
            return [int(tok()) for _ in range(n)]

    nodes = np.zeros((num_nodes, 3))
    nodes[:, :sdim] = coords

    elements: Dict[int, tuple] = {}
    for _ in range(num_types):
        name = next_string()
        nn = next_ints(1)[0]
        ne = next_ints(1)[0]
        raw = np.array(next_ints(nn * ne), np.int64).reshape(ne, nn) - start
        ng = next_ints(1)[0]
        assert ng == ne, "COMSOL geometry tags must cover all elements"
        geom = np.array(next_ints(ne), np.int32)
        et_dim = _COMSOL_TYPES.get(name)
        if et_dim is None or et_dim[0] == 15:
            continue
        et, dim = et_dim
        if dim < sdim:
            geom = geom + 1  # 0-based boundary entities -> 1-based attrs
        conn = np.empty_like(raw)
        perm = _COMSOL_PERM.get(et, list(range(nn)))
        conn[:, perm] = raw
        elements[et] = (conn.astype(np.int32), geom,
                        np.zeros(ne, np.int32))
    return GmshMesh(nodes=nodes, elements=elements)


# ---------------------------------------------------------------------------
# Nastran


_NAS_NUM = re.compile(r"([0-9.][0-9.]*)([+-]\d+)$")


def _nas_float(word: str) -> float:
    """Nastran shorthand floats: '1.2345-3' means 1.2345e-3."""
    w = word.strip()
    m = _NAS_NUM.match(w)
    if m and "e" not in w.lower():
        return float(m.group(1) + "e" + m.group(2))
    return float(w)


def _nas_fields(line: str, wide: bool) -> List[str]:
    if "," in line:
        return [f.strip() for f in line.split(",")]
    w = 16 if wide else 8
    out = [line[:8].strip()]
    body = line[8:72 if not wide else 72]
    out += [body[i:i + w].strip() for i in range(0, len(body), w)]
    return out


def read_nastran(path: str) -> GmshMesh:
    lines = [ln.rstrip("\r\n") for ln in open(path, errors="replace")
             if not ln.startswith("$")]
    node_tags: List[int] = []
    coords: List[Tuple[float, float, float]] = []
    blocks: Dict[int, List[Tuple[int, List[int]]]] = {}

    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.strip() or line.startswith("ENDDATA"):
            if line.startswith("ENDDATA"):
                break
            continue
        key = _nas_fields(line, False)[0]
        if key == "GRID*":
            # Long field format: 8-char keyword + 16-char fields, with the
            # z coordinate on a '*'-continuation line.
            f = _nas_fields(line, True)
            nxt = _nas_fields(lines[i], True)
            i += 1
            node_tags.append(int(f[1]))
            coords.append((_nas_float(f[3]), _nas_float(f[4]),
                           _nas_float(nxt[1])))
        elif key == "GRID":
            f = _nas_fields(line, False)
            node_tags.append(int(f[1]))
            coords.append((_nas_float(f[3]), _nas_float(f[4]),
                           _nas_float(f[5])))
        else:
            lo = next((t for k, t in _NASTRAN_TYPES.items()
                       if key.startswith(k)), 0)
            if not lo:
                continue
            f = _nas_fields(line, False)
            attr = int(f[2])
            nids = [int(x) for x in f[3:] if x]
            while i < len(lines) and lines[i][:1] in "+*":
                nids += [int(x) for x in _nas_fields(lines[i], False)[1:]
                         if x]
                i += 1
            et = _NASTRAN_HO.get((lo, len(nids)), lo)
            assert GMSH_NUM_NODES[et] == len(nids), \
                f"unsupported Nastran {key} with {len(nids)} nodes"
            blocks.setdefault(et, []).append((attr, nids))

    tag_to_idx = {t: k for k, t in enumerate(node_tags)}
    elements: Dict[int, tuple] = {}
    for et, rows in blocks.items():
        ne = len(rows)
        nn = GMSH_NUM_NODES[et]
        raw = np.array([[tag_to_idx[t] for t in r[1]] for r in rows],
                       np.int64)
        conn = np.empty_like(raw)
        perm = _NASTRAN_PERM.get(et, list(range(nn)))
        conn[:, perm] = raw
        elements[et] = (conn.astype(np.int32),
                        np.array([r[0] for r in rows], np.int32),
                        np.zeros(ne, np.int32))
    return GmshMesh(nodes=np.array(coords, np.float64), elements=elements)


# ---------------------------------------------------------------------------
# MFEM native (.mesh) and VTK legacy (.vtk) readers
# (reference: MFEM's own readers reached via geodata.cpp LoadMesh; the
# format facts are from the MFEM mesh-v1.0 spec and the VTK file-formats
# documentation.)

# MFEM geometry id -> (gmsh element type, nodes); linear elements.
_MFEM_GEOM = {
    1: (15, 1),  # POINT
    2: (1, 2),   # SEGMENT
    3: (2, 3),   # TRIANGLE
    4: (3, 4),   # SQUARE
    5: (4, 4),   # TETRAHEDRON
    6: (5, 8),   # CUBE
    7: (6, 6),   # PRISM
}


def read_mfem(path: str) -> GmshMesh:
    """MFEM mesh v1.0/v1.2 (ASCII, straight-sided).  MFEM vertex orderings
    for segment/triangle/square/tet/cube/prism coincide with the Gmsh
    linear orderings.  Curved meshes (a `nodes` FiniteElementSpace section)
    are not supported — the corpus' curved meshes are Gmsh."""
    with open(path) as fh:
        txt = fh.read()
    lines = [ln.split("#", 1)[0].strip() for ln in txt.splitlines()]
    lines = [ln for ln in lines if ln]
    if not lines or not lines[0].startswith("MFEM mesh"):
        raise ValueError(f"{path}: not an MFEM mesh file")

    def section(name):
        try:
            return lines.index(name)
        except ValueError:
            return None

    i = section("dimension")
    dim = int(lines[i + 1])

    def read_elems(start):
        cnt = int(lines[start + 1])
        out: Dict[int, list] = {}
        for k in range(cnt):
            parts = lines[start + 2 + k].split()
            attr, geom = int(parts[0]), int(parts[1])
            et, nn = _MFEM_GEOM[geom]
            verts = [int(v) for v in parts[2:2 + nn]]
            out.setdefault(et, []).append((attr, verts))
        return out, start + 2 + cnt

    elements: Dict[int, tuple] = {}

    def add(blocks):
        for et, rows in blocks.items():
            conn = np.array([r[1] for r in rows], np.int32)
            attr = np.array([r[0] for r in rows], np.int32)
            if et in elements:
                c0, a0, z0 = elements[et]
                conn = np.concatenate([c0, conn])
                attr = np.concatenate([a0, attr])
            elements[et] = (conn, attr, np.zeros(len(attr), np.int32))

    i = section("elements")
    blocks, _ = read_elems(i)
    add(blocks)
    i = section("boundary")
    if i is not None:
        blocks, _ = read_elems(i)
        add(blocks)

    i = section("vertices")
    nv = int(lines[i + 1])
    if section("nodes") is not None:
        raise NotImplementedError(
            f"{path}: curved MFEM meshes (nodes FE section) not supported")
    vdim = int(lines[i + 2])
    coords = np.zeros((nv, 3))
    for k in range(nv):
        vals = [float(v) for v in lines[i + 3 + k].split()]
        coords[k, :vdim] = vals[:vdim]
    _ = dim
    return GmshMesh(nodes=coords, elements=elements)


# VTK cell type -> gmsh element type (linear cells).
_VTK_TYPES = {3: 1, 5: 2, 9: 3, 10: 4, 12: 5, 13: 6, 1: 15}


def read_vtk(path: str) -> GmshMesh:
    """VTK legacy ASCII UNSTRUCTURED_GRID with linear cells; cell
    attributes from the first CELL_DATA SCALARS array (the convention
    MFEM's VTK reader uses for material/boundary attributes)."""
    with open(path) as fh:
        tokens = fh.read().split()
    tl = [t.lower() for t in tokens]

    def find(word):
        try:
            return tl.index(word)
        except ValueError:
            return None

    i = find("points")
    if i is None:
        raise ValueError(f"{path}: no POINTS section")
    npts = int(tokens[i + 1])
    coords = np.array(tokens[i + 3:i + 3 + 3 * npts],
                      np.float64).reshape(npts, 3)

    i = find("cells")
    ncell = int(tokens[i + 1])
    pos = i + 3
    cells = []
    for _ in range(ncell):
        nn = int(tokens[pos])
        cells.append([int(v) for v in tokens[pos + 1:pos + 1 + nn]])
        pos += 1 + nn

    i = find("cell_types")
    types = [int(t) for t in tokens[i + 2:i + 2 + ncell]]

    attrs = np.ones(ncell, np.int32)
    i = find("cell_data")
    if i is not None:
        j = find("scalars")
        if j is not None:
            k = tl.index("lookup_table", j)
            attrs = np.array(tokens[k + 2:k + 2 + ncell], float).astype(
                np.int32)

    elements: Dict[int, list] = {}
    for c, ty, a in zip(cells, types, attrs):
        if ty not in _VTK_TYPES:
            raise NotImplementedError(
                f"{path}: VTK cell type {ty} not supported (linear only)")
        elements.setdefault(_VTK_TYPES[ty], []).append((a, c))
    out: Dict[int, tuple] = {}
    for et, rows in elements.items():
        out[et] = (np.array([r[1] for r in rows], np.int32),
                   np.array([r[0] for r in rows], np.int32),
                   np.zeros(len(rows), np.int32))
    return GmshMesh(nodes=coords, elements=out)
