"""Periodic boundary identification (reference: palace/utils/geodata.cpp
MakePeriodic / mfem::Mesh::MakePeriodic).

Receiver-surface nodes are identified with their donor images under the
configured translation (or general 4x4 affine transform): the mesh gains a
`node_ident` map used by the finite element spaces when keying dof entities,
so donor/receiver entities share dofs while element geometry keeps the raw
coordinates.  Composition across multiple pairs (e.g. x- and y-periodic unit
cells, where corner nodes chain through both maps) is resolved with a
union-find collapse to the representative node.

Copied from palace_tpu/mesh/periodic.py, imports pointed at palace_torch.
"""

from __future__ import annotations


import numpy as np

from palace_torch.mesh.mesh import Mesh


def _surface_nodes(mesh: Mesh, attrs) -> np.ndarray:
    ids = []
    attrs = set(int(a) for a in attrs)
    for b in mesh.bdr_buckets:
        sel = np.isin(b.attr, list(attrs))
        if sel.any():
            ids.append(np.unique(b.conn[sel]))
    if not ids:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(ids)).astype(np.int64)


def _match(donor_pts: np.ndarray, mapped_pts: np.ndarray, tol: float
           ) -> np.ndarray:
    """Index of the donor point closest to each mapped receiver point."""
    from scipy.spatial import cKDTree

    tree = cKDTree(donor_pts)
    d, j = tree.query(mapped_pts)
    if d.max() > tol:
        raise ValueError(
            f"periodic boundary matching failed: worst node distance "
            f"{d.max():.3e} exceeds tolerance {tol:.3e} (check the "
            "Translation/AffineTransform and that the paired surface "
            "meshes are congruent)")
    return j


def apply_periodic(mesh: Mesh, pairs, length_scale: float) -> int:
    """Set mesh.node_ident from config periodic boundary pairs.

    `pairs` are PeriodicConfig entries; Translation (and AffineTransform,
    row-major 4x4) are given in mesh length units and scaled by
    1/length_scale into the nondimensional frame, matching the already
    scaled coordinates.  Returns the number of identified nodes.
    """
    if not pairs:
        return 0
    n = mesh.nodes.shape[0]
    parent = np.arange(n, dtype=np.int64)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    sdim = mesh.nodes.shape[1]
    bb = mesh.nodes.max(axis=0) - mesh.nodes.min(axis=0)
    tol = 1e-6 * float(np.linalg.norm(bb))
    total = 0
    for p in pairs:
        donor = _surface_nodes(mesh, p.donor_attributes)
        recv = _surface_nodes(mesh, p.receiver_attributes)
        if len(donor) == 0 or len(recv) == 0:
            raise ValueError("periodic boundary pair has empty surfaces")
        if len(donor) != len(recv):
            raise ValueError(
                f"periodic pair surfaces are not congruent "
                f"({len(donor)} vs {len(recv)} nodes)")
        pts = mesh.nodes[recv]
        if p.affine_transform is not None:
            T = np.asarray(p.affine_transform, float).reshape(4, 4)
            R = T[:sdim, :sdim]
            t = T[:sdim, 3] / length_scale
            # Inverse map: receiver = T(donor) -> donor = T^-1(receiver).
            j = _match(mesh.nodes[donor], (pts - t) @ np.linalg.inv(R).T,
                       tol)
        else:
            if p.translation is None:
                # Automatic translation detection from the surface geometry
                # (reference: geodata.cpp DeterminePeriodicVertexMapping —
                # centroid offset, validated by the node match below).
                t = (mesh.nodes[recv].mean(axis=0)
                     - mesh.nodes[donor].mean(axis=0)) * length_scale
                if np.linalg.norm(t) < tol:
                    raise ValueError(
                        "periodic pair translation auto-detection failed "
                        "(coincident surface centroids); set Translation")
            else:
                t = np.asarray(p.translation, float)[:sdim]
            t = t[:sdim] / length_scale
            # Translation maps donor -> receiver (receiver = donor + t);
            # accept either sign convention.
            try:
                j = _match(mesh.nodes[donor], pts - t, tol)
            except ValueError:
                j = _match(mesh.nodes[donor], pts + t, tol)
        for r, dn in zip(recv, donor[j]):
            a, b = find(int(r)), find(int(dn))
            if a != b:
                parent[max(a, b)] = min(a, b)
                total += 1
    ident = np.fromiter((find(i) for i in range(n)), np.int64, n)
    mesh.node_ident = ident
    return total
