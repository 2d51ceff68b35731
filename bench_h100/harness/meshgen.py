"""The benchmark's own box hex mesh and its Gmsh MSH 2.2 file.

A uniform nx x ny x nz hex box on [0, lx] x [0, ly] x [0, lz], node
(i, j, k) numbered (i (ny + 1) + j) (nz + 1) + k, hexes in Gmsh vertex
order, and the six faces as boundary quads with attributes 1 (x = 0),
2 (x = lx), 3 (y = 0), 4 (y = ly), 5 (z = 0) and 6 (z = lz); the volume
has attribute 1.  Both sides of the comparison read this one mesh: the
program from the file, the reference from the arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BoxMesh:
    nodes: np.ndarray  # (N, 3) in mesh units
    hexes: np.ndarray  # (E, 8) node ids, Gmsh order
    quads: np.ndarray  # (Q, 4) boundary node ids
    quad_attr: np.ndarray  # (Q,)


def box_hex(cells, size) -> BoxMesh:
    nx, ny, nz = (int(c) for c in cells)
    xs, ys, zs = (np.linspace(0.0, float(s), n + 1)
                  for s, n in zip(size, (nx, ny, nz)))
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    nid = np.arange((nx + 1) * (ny + 1) * (nz + 1)).reshape(
        nx + 1, ny + 1, nz + 1)
    c = nid[:-1, :-1, :-1]
    hexes = np.stack([
        c, nid[1:, :-1, :-1], nid[1:, 1:, :-1], nid[:-1, 1:, :-1],
        nid[:-1, :-1, 1:], nid[1:, :-1, 1:], nid[1:, 1:, 1:],
        nid[:-1, 1:, 1:]], -1).reshape(-1, 8)

    def face(plane):
        # plane: (a+1, b+1) node ids of one face, cyclic quads over it.
        return np.stack([plane[:-1, :-1], plane[1:, :-1], plane[1:, 1:],
                         plane[:-1, 1:]], -1).reshape(-1, 4)

    quads, attrs = [], []
    for attr, plane in ((1, nid[0]), (2, nid[-1]), (3, nid[:, 0]),
                        (4, nid[:, -1]), (5, nid[:, :, 0]),
                        (6, nid[:, :, -1])):
        q = face(plane)
        quads.append(q)
        attrs.append(np.full(len(q), attr))
    return BoxMesh(nodes, hexes.astype(np.int64), np.concatenate(quads),
                   np.concatenate(attrs))


def write_msh(mesh: BoxMesh, path: str) -> None:
    """MSH 2.2 ASCII: nodes tagged 1..N in order, boundary quads (type 3)
    then hexes (type 5), physical and elementary tag both the attribute."""
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str(len(mesh.nodes))]
    lines += [f"{i + 1} {x:.16g} {y:.16g} {z:.16g}"
              for i, (x, y, z) in enumerate(mesh.nodes)]
    lines += ["$EndNodes", "$Elements",
              str(len(mesh.quads) + len(mesh.hexes))]
    eid = 1
    for etype, conn, attr in ((3, mesh.quads, mesh.quad_attr),
                              (5, mesh.hexes, np.ones(len(mesh.hexes), int))):
        for row, a in zip(conn, attr):
            lines.append(f"{eid} {etype} 2 {a} {a} "
                         + " ".join(str(v + 1) for v in row))
            eid += 1
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
