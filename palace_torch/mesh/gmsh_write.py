"""Minimal Gmsh MSH 2.2 ASCII writer (for generated meshes and tests).

Copied from palace_tpu/mesh/gmsh_write.py, imports pointed at palace_torch.
"""

from __future__ import annotations


from palace_torch.mesh.mesh import Mesh

# Reverse of gmsh element types for the buckets we generate.
_GEOM_TO_ETYPE = {}


def write(mesh: Mesh, path: str):
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{mesh.num_nodes}\n")
        for i, p in enumerate(mesh.nodes):
            x, y, z = (list(p) + [0.0, 0.0])[:3]
            f.write(f"{i + 1} {x:.16g} {y:.16g} {z:.16g}\n")
        f.write("$EndNodes\n")
        nelem = sum(b.num_elem for b in mesh.buckets + mesh.bdr_buckets)
        f.write(f"$Elements\n{nelem}\n")
        eid = 1
        for b in mesh.bdr_buckets + mesh.buckets:
            for row, attr in zip(b.conn, b.attr):
                nodes = " ".join(str(v + 1) for v in row)
                f.write(f"{eid} {b.etype} 2 {attr} {attr} {nodes}\n")
                eid += 1
        f.write("$EndElements\n")
