"""Structured mesh generation (for tests and built-in geometries).

Box meshes with per-face boundary attributes:
  attributes 1..6 = x=0, x=Lx, y=0, y=Ly, z=0, z=Lz faces; domain attr 1.

Copied from palace_tpu/mesh/generate.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import numpy as np

from palace_torch.mesh.mesh import ElemBucket, Mesh


def uniform_segment(x0: float, x1: float, h: float) -> np.ndarray:
    """Ascending points covering [x0, x1] with ~h spacing (>= 1 cell)."""
    n = max(1, int(round((x1 - x0) / h)))
    return np.linspace(x0, x1, n + 1)


def _geometric_steps(length: float, h: float, ratio: float):
    """Step sizes from a fine end: h, h*ratio, ... summing exactly to
    `length` (remainder merged into the last step when small)."""
    steps, s, acc = [], h, 0.0
    while acc + s < length:
        steps.append(s)
        acc += s
        s *= ratio
    rem = length - acc
    if steps and rem < 0.4 * steps[-1]:
        steps[-1] += rem
    else:
        steps.append(rem)
    return steps


def graded_segment(x0: float, x1: float, h: float,
                   ratio: float = 1.9) -> np.ndarray:
    """Points on [x0, x1] with spacing ~h at BOTH ends, geometrically
    growing toward the middle (for gaps between refined features)."""
    L = x1 - x0
    if L <= 1.5 * h:
        return np.asarray([x0, x1])
    half = np.concatenate([[0.0], np.cumsum(_geometric_steps(
        0.5 * L, h, ratio))])
    return np.concatenate([x0 + half, (x1 - half)[::-1][1:]])


def graded_one_sided(x0: float, x1: float, h: float,
                     ratio: float = 1.9) -> np.ndarray:
    """Points on [x0, x1] with spacing ~h at the x1 end, geometrically
    growing toward x0 (for far-field padding)."""
    L = x1 - x0
    if L <= 1.5 * h:
        return np.asarray([x0, x1])
    d = np.concatenate([[0.0], np.cumsum(_geometric_steps(L, h, ratio))])
    return (x1 - d)[::-1]


def stitch_segments(*segs) -> np.ndarray:
    """Concatenate ascending segments that share endpoints into one axis."""
    pts = [np.asarray(segs[0], float)]
    for s in segs[1:]:
        s = np.asarray(s, float)
        assert abs(s[0] - pts[-1][-1]) < 1e-12 * max(1.0, abs(s[0]))
        pts.append(s[1:])
    return np.concatenate(pts)


def box_hex_coords(xs, ys, zs, z_sheets=()) -> Mesh:
    """Box hex mesh on explicit (graded) coordinate lines.  `z_sheets` is a
    list of (k0, attr_fn) pairs: at grid plane z = zs[k0], each cell
    footprint (i, j) gets an internal sheet quad with attribute
    attr_fn(xc, yc) (0 = no sheet) — used for embedded PEC ribbons /
    surface-current terminals (e.g. the rings-style inductance geometries).
    """
    xs, ys, zs = (np.asarray(a, float) for a in (xs, ys, zs))
    nx, ny, nz = len(xs) - 1, len(ys) - 1, len(zs) - 1
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    conn = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                conn.append(
                    [
                        nid(i, j, k), nid(i + 1, j, k),
                        nid(i + 1, j + 1, k), nid(i, j + 1, k),
                        nid(i, j, k + 1), nid(i + 1, j, k + 1),
                        nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1),
                    ]
                )
    conn = np.array(conn, np.int32)
    buckets = [ElemBucket(5, __import__(
        "palace_torch.fem.reference", fromlist=["Geom"]).Geom.HEX, 1, conn,
        np.ones(len(conn), np.int32))]

    bq, battr = [], []
    for j in range(ny):
        for k in range(nz):
            bq.append([nid(0, j, k), nid(0, j + 1, k),
                       nid(0, j + 1, k + 1), nid(0, j, k + 1)]); battr.append(1)
            bq.append([nid(nx, j, k), nid(nx, j + 1, k),
                       nid(nx, j + 1, k + 1), nid(nx, j, k + 1)]); battr.append(2)
    for i in range(nx):
        for k in range(nz):
            bq.append([nid(i, 0, k), nid(i + 1, 0, k),
                       nid(i + 1, 0, k + 1), nid(i, 0, k + 1)]); battr.append(3)
            bq.append([nid(i, ny, k), nid(i + 1, ny, k),
                       nid(i + 1, ny, k + 1), nid(i, ny, k + 1)]); battr.append(4)
    for i in range(nx):
        for j in range(ny):
            bq.append([nid(i, j, 0), nid(i + 1, j, 0),
                       nid(i + 1, j + 1, 0), nid(i, j + 1, 0)]); battr.append(5)
            bq.append([nid(i, j, nz), nid(i + 1, j, nz),
                       nid(i + 1, j + 1, nz), nid(i, j + 1, nz)]); battr.append(6)
    for (k0, attr_fn) in z_sheets:
        for i in range(nx):
            for j in range(ny):
                a = int(attr_fn(0.5 * (xs[i] + xs[i + 1]),
                                0.5 * (ys[j] + ys[j + 1])))
                if a:
                    bq.append([nid(i, j, k0), nid(i + 1, j, k0),
                               nid(i + 1, j + 1, k0), nid(i, j + 1, k0)])
                    battr.append(a)
    from palace_torch.fem.reference import Geom

    bdr = [ElemBucket(3, Geom.QUAD, 1, np.array(bq, np.int32),
                      np.array(battr, np.int32))]
    return Mesh(nodes, buckets, bdr)


def box_hex(nx=4, ny=4, nz=4, lx=1.0, ly=1.0, lz=1.0, sheet_j=None,
            sheet_attr=7) -> Mesh:
    """Box hex mesh; optional internal sheet of quads at y-layer `sheet_j`
    (attr `sheet_attr`) for surface-current excitation tests."""
    xs = np.linspace(0, lx, nx + 1)
    ys = np.linspace(0, ly, ny + 1)
    zs = np.linspace(0, lz, nz + 1)
    mesh = box_hex_coords(xs, ys, zs)
    if sheet_j is not None:
        ny_, nz_ = ny, nz

        def nid(i, j, k):
            return (i * (ny_ + 1) + j) * (nz_ + 1) + k

        bq, battr = [], []
        for i in range(nx):
            for k in range(nz):
                bq.append([nid(i, sheet_j, k), nid(i + 1, sheet_j, k),
                           nid(i + 1, sheet_j, k + 1),
                           nid(i, sheet_j, k + 1)])
                battr.append(sheet_attr)
        b = mesh.bdr_buckets[0]
        from palace_torch.fem.reference import Geom

        mesh = Mesh(mesh.nodes, mesh.buckets, [ElemBucket(
            3, Geom.QUAD, 1,
            np.concatenate([b.conn, np.array(bq, np.int32)]),
            np.concatenate([b.attr, np.array(battr, np.int32)]))])
    return mesh


_KUHN_TETS = [
    (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
    (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6),
]


def box_tet(nx=4, ny=4, nz=4, lx=1.0, ly=1.0, lz=1.0, sheet_j=None,
            sheet_attr=7) -> Mesh:
    """Box split into 6 tets per hex (Kuhn triangulation: conforming on a
    structured grid because every hex uses the same diagonal direction)."""
    hexm = box_hex(nx, ny, nz, lx, ly, lz, sheet_j=sheet_j, sheet_attr=sheet_attr)
    return tetrahedralize(hexm)


def box_tet_coords(xs, ys, zs, z_sheets=()) -> Mesh:
    """Kuhn-split tet mesh on explicit coordinate lines with optional
    embedded z-plane sheets (see box_hex_coords)."""
    return tetrahedralize(box_hex_coords(xs, ys, zs, z_sheets))


def tetrahedralize(hexm: Mesh) -> Mesh:
    hconn = hexm.buckets[0].conn
    tconn = np.concatenate([hconn[:, list(t)] for t in _KUHN_TETS], axis=0)
    from palace_torch.fem.reference import Geom

    buckets = [ElemBucket(4, Geom.TET, 1, tconn.astype(np.int32),
                          np.ones(len(tconn), np.int32))]
    # Split boundary quads along the diagonal that exists in the Kuhn split:
    # quad (a, b, c, d) -> tris consistent with tet faces. The Kuhn split of
    # the cube cuts each face along the diagonal through the locally smallest
    # "corner parity"; here we cut along (q0, q2) for faces oriented as built.
    bq = hexm.bdr_buckets[0]
    tris, attrs = [], []
    # Determine actual tet faces to pick matching diagonals.
    tet_faces = set()
    for row in tconn:
        for f in [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]:
            tet_faces.add(tuple(sorted(row[list(f)])))
    for quad, a in zip(bq.conn, bq.attr):
        q = quad.tolist()
        if tuple(sorted((q[0], q[1], q[2]))) in tet_faces:
            tris += [[q[0], q[1], q[2]], [q[0], q[2], q[3]]]
        else:
            tris += [[q[0], q[1], q[3]], [q[1], q[2], q[3]]]
        attrs += [a, a]
    bdr = [ElemBucket(2, Geom.TRI, 1, np.array(tris, np.int32),
                      np.array(attrs, np.int32))]
    return Mesh(hexm.nodes, buckets, bdr)


def box_prism(nx=4, ny=4, nz=4, lx=1.0, ly=1.0, lz=1.0) -> Mesh:
    """Box wedge mesh: each (i, j) footprint quad split into two triangles,
    extruded along z (the layered structure fem/nd_prism.py requires).
    Boundary attrs match box_hex: 1/2 x-min/max, 3/4 y-min/max, 5/6 z."""
    from palace_torch.fem.reference import Geom

    xs = np.linspace(0, lx, nx + 1)
    ys = np.linspace(0, ly, ny + 1)
    zs = np.linspace(0, lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    tris = []  # footprint triangles as (i, j) corner index triples
    for i in range(nx):
        for j in range(ny):
            tris.append(((i, j), (i + 1, j), (i + 1, j + 1)))
            tris.append(((i, j), (i + 1, j + 1), (i, j + 1)))
    conn = []
    for t in tris:
        for k in range(nz):
            conn.append([nid(a, b, k) for (a, b) in t]
                        + [nid(a, b, k + 1) for (a, b) in t])
    buckets = [ElemBucket(6, Geom.PRISM, 1, np.array(conn, np.int32),
                          np.ones(len(conn), np.int32))]

    bt, btattr = [], []  # top/bottom caps: triangles
    for t in tris:
        bt.append([nid(a, b, 0) for (a, b) in t]); btattr.append(5)
        bt.append([nid(a, b, nz) for (a, b) in t]); btattr.append(6)
    bq, bqattr = [], []  # side walls: quads
    for j in range(ny):
        for k in range(nz):
            bq.append([nid(0, j, k), nid(0, j + 1, k),
                       nid(0, j + 1, k + 1), nid(0, j, k + 1)]); bqattr.append(1)
            bq.append([nid(nx, j, k), nid(nx, j + 1, k),
                       nid(nx, j + 1, k + 1), nid(nx, j, k + 1)]); bqattr.append(2)
    for i in range(nx):
        for k in range(nz):
            bq.append([nid(i, 0, k), nid(i + 1, 0, k),
                       nid(i + 1, 0, k + 1), nid(i, 0, k + 1)]); bqattr.append(3)
            bq.append([nid(i, ny, k), nid(i + 1, ny, k),
                       nid(i + 1, ny, k + 1), nid(i, ny, k + 1)]); bqattr.append(4)
    bdr = [ElemBucket(2, Geom.TRI, 1, np.array(bt, np.int32),
                      np.array(btattr, np.int32)),
           ElemBucket(3, Geom.QUAD, 1, np.array(bq, np.int32),
                      np.array(bqattr, np.int32))]
    return Mesh(nodes, buckets, bdr)
