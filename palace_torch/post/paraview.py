"""ParaView (VTU XML) field output (reference: palace PostOperator ParaView
data collections, palace/models/postoperator.cpp InitializeParaviewDataCollection).

Writes an unstructured grid per save step with nodal point data (fields are
averaged over adjacent elements at shared nodes, matching ParaView's
rendering of the reference's Lagrange-projected output), plus a .pvd
collection file.

Copied from palace_tpu/post/paraview.py, imports pointed at palace_torch;
`write_vtu` and `write_pvd` write on rank 0 only (a multi-rank run writes
its files once).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from palace_torch import parallel
from palace_torch.fem import reference as ref

# gmsh etype -> (VTK cell type, node permutation gmsh->vtk)
_VTK = {
    2: (5, [0, 1, 2]),                  # tri3
    3: (9, [0, 1, 2, 3]),               # quad4
    4: (10, [0, 1, 2, 3]),              # tet4
    5: (12, list(range(8))),            # hex8
    9: (22, [0, 1, 2, 3, 4, 5]),        # tri6
    11: (24, [0, 1, 2, 3, 4, 5, 6, 7, 9, 8]),  # tet10 (gmsh<->vtk swap 8,9)
    12: (12, list(range(8))),           # hex27 -> write linear corners
    10: (9, [0, 1, 2, 3]),              # quad9 -> linear corners
    6: (13, list(range(6))),            # prism6
    13: (13, list(range(6))),           # prism18 -> linear corners
}


def nodal_average_nd(space, u: np.ndarray, which: str = "value") -> np.ndarray:
    """ND vector field (or its curl) averaged at mesh nodes: (num_nodes, sdim)."""
    mesh = space.mesh
    sdim = mesh.nodes.shape[1]
    acc = np.zeros((mesh.num_nodes, sdim), dtype=u.dtype)
    cnt = np.zeros(mesh.num_nodes)
    from palace_torch.utils import smallmat

    for bi, b in enumerate(mesh.buckets):
        geom, order, pts = ref.gmsh_node_coords(b.etype)
        V, C = space.basis_tables(b.geom, pts)  # (nn, nd, rdim)
        gb = ref.gmsh_geometry_basis(b.etype)
        Gg = gb.eval_grad(pts)  # (nn, nn_geo, rdim)
        X = mesh.nodes[b.conn]  # (E, nn_geo, sdim)
        J = np.einsum("ens,pnr->epsr", X, Gg)
        ue = u[space.elem_dofs[bi]]
        sg = getattr(space, "elem_signs", None)
        if sg is not None and sg[bi] is not None:
            ue = ue * sg[bi]
        if which == "value":
            Jinv = smallmat.inv(J)
            vals = np.einsum("eprs,pnr,en->eps", Jinv, V, ue)
        elif C.shape[-1] == 1:
            detJ = smallmat.det(J)
            vals = np.zeros((len(X), len(pts), sdim), dtype=u.dtype)
            vals[..., 0] = np.einsum("pn,en->ep", C[..., 0], ue) / detJ
        else:
            detJ = smallmat.det(J)
            vals = np.einsum("epsr,pnr,en->eps", J, C, ue) / \
                smallmat.det(J)[..., None]
        np.add.at(acc, b.conn.ravel(), vals.reshape(-1, sdim))
        np.add.at(cnt, b.conn.ravel(), 1.0)
    cnt[cnt == 0] = 1.0
    return acc / cnt[:, None]


def nodal_average_h1(space, u: np.ndarray) -> np.ndarray:
    """H1 scalar field at mesh nodes."""
    mesh = space.mesh
    acc = np.zeros(mesh.num_nodes, dtype=u.dtype)
    cnt = np.zeros(mesh.num_nodes)
    for bi, b in enumerate(mesh.buckets):
        geom, order, pts = ref.gmsh_node_coords(b.etype)
        B = space.basis(b.geom).eval(pts)  # (nn, nd)
        ue = u[space.elem_dofs[bi]]
        vals = ue @ B.T
        np.add.at(acc, b.conn.ravel(), vals.ravel())
        np.add.at(cnt, b.conn.ravel(), 1.0)
    cnt[cnt == 0] = 1.0
    return acc / cnt


def write_vtu(path: str, mesh, point_fields: Dict[str, np.ndarray]):
    """ASCII VTU with the mesh cells and nodal point data."""
    if not parallel.is_root():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    nodes = mesh.nodes
    if nodes.shape[1] == 2:
        nodes = np.concatenate([nodes, np.zeros((len(nodes), 1))], axis=1)
    cells = []
    types = []
    for b in mesh.buckets:
        vtk_type, perm = _VTK[b.etype]
        conn = b.conn[:, perm] if len(perm) == b.conn.shape[1] else \
            b.conn[:, perm]
        for row in conn:
            cells.append(row)
            types.append(vtk_type)
    offsets = np.cumsum([len(c) for c in cells])
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{len(nodes)}" '
                f'NumberOfCells="{len(cells)}">\n')
        f.write('<Points>\n<DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        np.savetxt(f, nodes, fmt="%.10g")
        f.write('</DataArray>\n</Points>\n<Cells>\n')
        f.write('<DataArray type="Int64" Name="connectivity" format="ascii">\n')
        f.write(" ".join(" ".join(map(str, c)) for c in cells) + "\n")
        f.write('</DataArray>\n<DataArray type="Int64" Name="offsets" '
                'format="ascii">\n')
        f.write(" ".join(map(str, offsets)) + "\n")
        f.write('</DataArray>\n<DataArray type="UInt8" Name="types" '
                'format="ascii">\n')
        f.write(" ".join(map(str, types)) + "\n")
        f.write('</DataArray>\n</Cells>\n<PointData>\n')
        for name, vals in point_fields.items():
            vals = np.asarray(vals)
            ncomp = 1 if vals.ndim == 1 else vals.shape[1]
            if ncomp == 2:
                vals = np.concatenate(
                    [vals, np.zeros((len(vals), 1), vals.dtype)], axis=1)
                ncomp = 3
            f.write(f'<DataArray type="Float64" Name="{name}" '
                    f'NumberOfComponents="{ncomp}" format="ascii">\n')
            np.savetxt(f, vals.reshape(len(vals), -1), fmt="%.10g")
            f.write('</DataArray>\n')
        f.write('</PointData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')


def write_pvd(path: str, entries: List[Tuple[float, str]]):
    """ParaView collection: entries = [(time_or_index, vtu_relpath)]."""
    if not parallel.is_root():
        return
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n<VTKFile type="Collection" '
                'version="0.1">\n<Collection>\n')
        for t, rel in entries:
            f.write(f'<DataSet timestep="{t}" part="0" file="{rel}"/>\n')
        f.write('</Collection>\n</VTKFile>\n')


class ParaviewSaver:
    """Accumulates save steps and writes the collection on finalize."""

    def __init__(self, post_dir: str, name: str, mesh):
        self.dir = os.path.join(post_dir, "paraview", name)
        self.name = name
        self.mesh = mesh
        self.entries: List[Tuple[float, str]] = []

    def save(self, step_value: float, fields: Dict[str, np.ndarray]):
        fn = f"{self.name}_{len(self.entries):04d}.vtu"
        write_vtu(os.path.join(self.dir, fn), self.mesh, fields)
        self.entries.append((step_value, fn))

    def finalize(self):
        if self.entries:
            write_pvd(os.path.join(self.dir, f"{self.name}.pvd"), self.entries)
