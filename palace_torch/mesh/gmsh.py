"""Gmsh MSH 2.2 mesh file reader (ASCII and binary).

Covers the element types used by the reference solver's examples
(reference: examples/*/mesh/*.msh are all MSH 2.2, mostly binary, with
linear through cubic elements): lines, triangles, quadrilaterals,
tetrahedra, hexahedra, and prisms at geometric orders 1-3.

Copied from palace_tpu/mesh/gmsh.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

# gmsh element type -> (name, number of nodes)
GMSH_NUM_NODES = {
    1: 2, 2: 3, 3: 4, 4: 4, 5: 8, 6: 6, 7: 5,
    8: 3, 9: 6, 10: 9, 11: 10, 12: 27, 13: 18, 14: 14,
    15: 1, 16: 8, 17: 20, 21: 10, 26: 4, 29: 20, 36: 16,
}

# gmsh element type -> spatial dimension of the element
GMSH_DIM = {
    15: 0,
    1: 1, 8: 1, 26: 1,
    2: 2, 9: 2, 21: 2, 3: 2, 10: 2, 16: 2, 36: 2,
    4: 3, 11: 3, 29: 3, 5: 3, 12: 3, 17: 3, 6: 3, 13: 3, 7: 3, 14: 3,
}


@dataclass
class GmshMesh:
    """Raw parsed mesh: nodes and per-type element blocks."""

    nodes: np.ndarray  # (num_nodes, 3) float64
    # element type -> (connectivity (E, nn) int32 0-based, physical tag (E,),
    #                  elementary tag (E,))
    elements: Dict[int, tuple] = field(default_factory=dict)
    physical_names: Dict[tuple, str] = field(default_factory=dict)  # (dim, tag) -> name


def read(path: str) -> GmshMesh:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"$MeshFormat"):
        raise ValueError(f"{path}: not a Gmsh MSH file")
    hdr_end = data.index(b"\n", len(b"$MeshFormat") + 1)
    hdr = data[data.index(b"\n") + 1 : hdr_end].split()
    version, ftype, dsize = hdr[0].decode(), int(hdr[1]), int(hdr[2])
    if not version.startswith("2."):
        raise ValueError(f"{path}: unsupported MSH version {version} (need 2.x)")
    if ftype == 0:
        return _read_ascii(data.decode("latin-1"))
    return _read_binary(data, dsize)


def _section(data: bytes, name: str):
    start = data.find(b"$" + name.encode())
    if start < 0:
        return None, None
    body_start = data.index(b"\n", start) + 1
    end = data.find(b"$End" + name.encode(), body_start)
    return body_start, end


def _read_physical_names(data: bytes) -> Dict[tuple, str]:
    s, e = _section(data, "PhysicalNames")
    names = {}
    if s is None:
        return names
    lines = data[s:e].decode("latin-1").strip().splitlines()
    n = int(lines[0])
    for ln in lines[1 : n + 1]:
        parts = ln.split(maxsplit=2)
        names[(int(parts[0]), int(parts[1]))] = parts[2].strip().strip('"')
    return names


def _read_binary(data: bytes, dsize: int) -> GmshMesh:
    assert dsize == 8, "expected 8-byte floats in binary MSH"
    names = _read_physical_names(data)

    s, e = _section(data, "Nodes")
    nl_end = data.index(b"\n", s)
    num_nodes = int(data[s:nl_end])
    p = nl_end + 1
    # Each record: int32 tag + 3 float64.
    rec = np.frombuffer(data, dtype=np.uint8, count=num_nodes * 28, offset=p)
    rec = rec.reshape(num_nodes, 28)
    tags = rec[:, :4].copy().view(np.int32).ravel()
    xyz = rec[:, 4:].copy().view(np.float64).reshape(num_nodes, 3)
    node_index = _tag_map(tags, num_nodes)
    nodes = np.empty((num_nodes, 3))
    nodes[node_index(tags)] = xyz

    s, e = _section(data, "Elements")
    nl_end = data.index(b"\n", s)
    num_elem = int(data[s:nl_end])
    p = nl_end + 1
    blocks: Dict[int, list] = {}
    read = 0
    while read < num_elem:
        et, ne, ntags = struct.unpack_from("<iii", data, p)
        p += 12
        nn = GMSH_NUM_NODES[et]
        stride = 1 + ntags + nn
        arr = np.frombuffer(data, dtype=np.int32, count=ne * stride, offset=p)
        p += 4 * ne * stride
        arr = arr.reshape(ne, stride)
        phys = arr[:, 1] if ntags >= 1 else np.zeros(ne, np.int32)
        elem = arr[:, 2] if ntags >= 2 else np.zeros(ne, np.int32)
        conn = arr[:, 1 + ntags :]
        blocks.setdefault(et, []).append((conn, phys, elem))
        read += ne

    return _finalize(nodes, node_index, blocks, names)


def _read_ascii(text: str) -> GmshMesh:
    data = text.encode("latin-1")
    names = _read_physical_names(data)
    lines = text.splitlines()
    it = iter(range(len(lines)))
    idx = {ln.strip(): i for i, ln in enumerate(lines) if ln.startswith("$")}

    i = idx["$Nodes"] + 1
    num_nodes = int(lines[i])
    tags = np.empty(num_nodes, np.int64)
    xyz = np.empty((num_nodes, 3))
    for k in range(num_nodes):
        parts = lines[i + 1 + k].split()
        tags[k] = int(parts[0])
        xyz[k] = [float(parts[1]), float(parts[2]), float(parts[3])]
    node_index = _tag_map(tags, num_nodes)
    nodes = np.empty((num_nodes, 3))
    nodes[node_index(tags)] = xyz

    i = idx["$Elements"] + 1
    num_elem = int(lines[i])
    blocks: Dict[int, list] = {}
    rows: Dict[int, list] = {}
    for k in range(num_elem):
        parts = [int(x) for x in lines[i + 1 + k].split()]
        et, ntags = parts[1], parts[2]
        phys = parts[3] if ntags >= 1 else 0
        elem = parts[4] if ntags >= 2 else 0
        conn = parts[3 + ntags :]
        rows.setdefault(et, []).append((conn, phys, elem))
    for et, rws in rows.items():
        conn = np.array([r[0] for r in rws], np.int32)
        phys = np.array([r[1] for r in rws], np.int32)
        elem = np.array([r[2] for r in rws], np.int32)
        blocks[et] = [(conn, phys, elem)]
    return _finalize(nodes, node_index, blocks, names)


def _tag_map(tags, num_nodes):
    """Return fn mapping node tags -> contiguous 0-based indices."""
    tmin, tmax = int(tags.min()), int(tags.max())
    if tmin == 1 and tmax == num_nodes:
        return lambda t: np.asarray(t, np.int64) - 1
    # Sparse tags: lookup table.
    lut = np.full(tmax + 1, -1, np.int64)
    lut[np.asarray(tags, np.int64)] = np.arange(num_nodes)
    return lambda t: lut[np.asarray(t, np.int64)]


def _finalize(nodes, node_index, blocks, names) -> GmshMesh:
    mesh = GmshMesh(nodes=nodes, physical_names=names)
    for et, parts in blocks.items():
        conn = np.concatenate([c for c, _, _ in parts])
        phys = np.concatenate([p for _, p, _ in parts])
        elem = np.concatenate([e for _, _, e in parts])
        conn = node_index(conn).astype(np.int32)
        mesh.elements[et] = (conn, phys, elem)
    return mesh
