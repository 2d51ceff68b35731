"""Field evaluation: point location, probes, and boundary traces.

Replaces the reference solver's GSLIB-based interpolation (reference:
palace/fem/interpolator.hpp:33-89) with KD-tree candidate search plus
Newton inversion of the (curved) isoparametric map, and provides the
boundary-trace quadrature used for surface flux/charge integrals
(reference: palace/models/surfacepostoperator.hpp).

Copied from palace_tpu/fem/evaluation.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from palace_torch.fem import reference as ref
from palace_torch.fem.reference import Geom
from palace_torch.mesh import geometry
from palace_torch.mesh.mesh import Mesh


def _inside(geom: Geom, xi: np.ndarray, tol: float = 1e-8) -> bool:
    if geom in (Geom.TET, Geom.TRI):
        return bool((xi >= -tol).all() and xi.sum() <= 1 + tol)
    if geom in (Geom.HEX, Geom.QUAD, Geom.LINE):
        return bool((xi >= -tol).all() and (xi <= 1 + tol).all())
    if geom is Geom.PRISM:
        return bool(
            (xi >= -tol).all() and xi[0] + xi[1] <= 1 + tol and xi[2] <= 1 + tol
        )
    raise ValueError(geom)


def _newton_invert(basis: ref.NodalBasis, X: np.ndarray, p: np.ndarray,
                   xi0: np.ndarray, iters: int = 30) -> Tuple[np.ndarray, float]:
    """Solve sum_i N_i(xi) X_i = p for xi.  Returns (xi, residual)."""
    xi = xi0.copy()
    for _ in range(iters):
        B = basis.eval(xi[None, :])[0]  # (nn,)
        G = basis.eval_grad(xi[None, :])[0]  # (nn, rdim)
        r = B @ X - p  # (sdim,)
        J = X.T @ G  # (sdim, rdim)
        try:
            if J.shape[0] == J.shape[1]:
                dxi = np.linalg.solve(J, r)
            else:
                dxi = np.linalg.lstsq(J, r, rcond=None)[0]
        except np.linalg.LinAlgError:
            break
        xi = xi - dxi
        if np.linalg.norm(dxi) < 1e-14:
            break
    B = basis.eval(xi[None, :])[0]
    return xi, float(np.linalg.norm(B @ X - p))


@dataclass
class PointLocation:
    bucket: int
    elem: int
    xi: np.ndarray  # reference coords


class PointLocator:
    """Locate physical points in (possibly curved) mesh elements."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        cents, owners = [], []
        for bi, b in enumerate(mesh.buckets):
            c = mesh.nodes[b.corners].mean(axis=1)
            cents.append(c)
            owners.append(np.stack(
                [np.full(b.num_elem, bi), np.arange(b.num_elem)], axis=1))
        self.centroids = np.concatenate(cents)
        self.owners = np.concatenate(owners)
        self.tree = cKDTree(self.centroids)

    def locate(self, points: np.ndarray, k: int = 24) -> List[PointLocation]:
        points = np.atleast_2d(points)
        out = []
        for p in points:
            _, idxs = self.tree.query(p, k=min(k, len(self.centroids)))
            idxs = np.atleast_1d(idxs)
            best = None
            for gi in idxs:
                bi, ei = self.owners[gi]
                b = self.mesh.buckets[bi]
                basis = ref.gmsh_geometry_basis(b.etype)
                X = self.mesh.nodes[b.conn[ei]]
                xi0 = ref.GEOM_VERTICES[b.geom].mean(axis=0)
                xi, res = _newton_invert(basis, X, p, xi0)
                if res < 1e-10 and _inside(b.geom, xi, tol=1e-6):
                    best = PointLocation(int(bi), int(ei), xi)
                    break
                if res < 1e-10 and best is None and _inside(b.geom, xi, tol=0.05):
                    best = PointLocation(int(bi), int(ei), xi)
            if best is None:
                raise RuntimeError(f"point {p} not located in mesh")
            out.append(best)
        return out


def eval_h1(space, u: np.ndarray, locs: List[PointLocation]):
    """Evaluate (value, physical gradient) of an H1 field at located points."""
    mesh = space.mesh
    vals = np.zeros((len(locs),) + u.shape[1:], dtype=u.dtype)
    grads = np.zeros((len(locs), mesh.nodes.shape[1]) + u.shape[1:], dtype=u.dtype)
    for i, loc in enumerate(locs):
        b = mesh.buckets[loc.bucket]
        basis = space.basis(b.geom)
        gb = ref.gmsh_geometry_basis(b.etype)
        dofs = space.elem_dofs[loc.bucket][loc.elem]
        ue = u[dofs]
        xi = loc.xi[None, :]
        B = basis.eval(xi)[0]
        G = basis.eval_grad(xi)[0]  # (nd, rdim)
        X = mesh.nodes[b.conn[loc.elem]]
        J = X.T @ gb.eval_grad(xi)[0]  # (sdim, rdim)
        Jinv = np.linalg.inv(J)
        vals[i] = B @ ue
        grads[i] = Jinv.T @ (G.T @ ue)
    return vals, grads


def eval_nd(space, u: np.ndarray, locs: List[PointLocation],
            which: str = "value") -> np.ndarray:
    """ND field value or curl at located points: (npts, 3)."""
    mesh = space.mesh
    sdim = mesh.nodes.shape[1]
    out = np.zeros((len(locs), sdim), dtype=u.dtype)
    for i, loc in enumerate(locs):
        b = mesh.buckets[loc.bucket]
        xi = loc.xi[None, :]
        V, C = space.basis_tables(b.geom, xi)
        gb = ref.gmsh_geometry_basis(b.etype)
        X = mesh.nodes[b.conn[loc.elem]]
        J = X.T @ gb.eval_grad(xi)[0]
        ue = u[space.elem_dofs[loc.bucket][loc.elem]]
        sg = getattr(space, "elem_signs", None)
        if sg is not None and sg[loc.bucket] is not None:
            ue = ue * sg[loc.bucket][loc.elem]
        if which == "value":
            out[i] = np.linalg.inv(J).T @ (V[0].T @ ue)
        else:
            out[i] = J @ (C[0].T @ ue) / np.linalg.det(J)
    return out


@dataclass
class BoundaryTrace:
    """Quadrature data for evaluating volume fields on boundary facets.

    For each selected boundary element: adjacent volume element, the volume
    reference coordinates of every surface quadrature point, the surface
    measure weights, and the outward (or center-oriented) unit normals.
    """

    bucket: np.ndarray  # (n,) volume bucket per facet
    elem: np.ndarray  # (n,) volume element per facet
    xi: np.ndarray  # (n, nq, rdim) volume ref coords
    wdetJ: np.ndarray  # (n, nq) surface quadrature weights
    normal: np.ndarray  # (n, nq, sdim) oriented unit normals
    xq: np.ndarray  # (n, nq, sdim) physical points
    attr: np.ndarray  # (n,) boundary attribute
    # Second side of interior facets (element -1 where the facet is a true
    # boundary); filled when boundary_trace(..., both_sides=True).
    bucket2: Optional[np.ndarray] = None
    elem2: Optional[np.ndarray] = None
    xi2: Optional[np.ndarray] = None

    def side2(self) -> "BoundaryTrace":
        """View of the second side as a trace (facets with elem2 >= 0)."""
        sel = self.elem2 >= 0
        return BoundaryTrace(
            bucket=self.bucket2[sel], elem=self.elem2[sel], xi=self.xi2[sel],
            wdetJ=self.wdetJ[sel], normal=self.normal[sel], xq=self.xq[sel],
            attr=self.attr[sel],
        )


def boundary_trace(
    mesh: Mesh,
    attrs,
    qorder: int,
    center: Optional[np.ndarray] = None,
    both_sides: bool = False,
) -> BoundaryTrace:
    """Build trace data for boundary elements with the given attributes.

    Normals are oriented away from `center` if given, else outward from the
    first adjacent volume element.  With both_sides=True, interior facets
    also record their second adjacent element (for jump/average evaluation,
    reference: palace/fem/coefficient.hpp BdrGridFunctionCoefficient).
    """
    attrs = [int(a) for a in attrs]
    from palace_torch.mesh.mesh import _lookup_rows

    is_2d = mesh.nodes.shape[1] == 2
    if is_2d:
        # 2D: facets are mesh edges.
        uniq_edges, bucket_edge_ids = mesh.edge_table()
        uniq_faces = np.concatenate(
            [np.full((len(uniq_edges), 2), -1, np.int64), uniq_edges], axis=1
        )
        bucket_face_ids = bucket_edge_ids
    else:
        uniq_faces, bucket_face_ids, counts = mesh.face_table()

    # facet key -> [(volume bucket, elem), ...] (two entries for interior
    # sheets; the tangential trace is single-valued, normal components jump).
    owners: dict = {}
    for bi, (b, fids) in enumerate(zip(mesh.buckets, bucket_face_ids)):
        for local in range(fids.shape[1]):
            for ei, fid in enumerate(fids[:, local]):
                owners.setdefault(int(fid), []).append((bi, int(ei)))

    rows = {"bucket": [], "elem": [], "xi": [], "w": [], "n": [], "x": [],
            "attr": [], "bucket2": [], "elem2": [], "xi2": []}
    for bb in mesh.bdr_buckets:
        sel = np.isin(bb.attr, attrs)
        if not sel.any():
            continue
        idx = np.where(sel)[0]
        gf = geometry.compute(mesh.nodes, bb, qorder, compute_xq=True)
        nv = bb.num_corners
        keys = np.full((len(idx), 4), -1, np.int64)
        keys[:, 4 - nv:] = np.sort(bb.corners[idx].astype(np.int64), axis=-1)
        fids = _lookup_rows(uniq_faces, keys)
        def invert(vbi, vei, xq):
            vb = mesh.buckets[vbi]
            vbasis = ref.gmsh_geometry_basis(vb.etype)
            X = mesh.nodes[vb.conn[vei]]
            xi0 = ref.GEOM_VERTICES[vb.geom].mean(axis=0)
            xis = np.empty((xq.shape[0], ref.GEOM_DIM[vb.geom]))
            for q in range(xq.shape[0]):
                xi, res = _newton_invert(vbasis, X, xq[q], xi0)
                if res > 1e-8:
                    raise RuntimeError("surface point inversion failed")
                xis[q] = xi
            return xis

        for row, ei_b in enumerate(idx):
            fid = int(fids[row])
            own = owners.get(fid, [])
            if fid < 0 or not own:
                raise RuntimeError("boundary element has no adjacent volume element")
            vbi, vei = own[0]
            vb = mesh.buckets[vbi]
            xq = gf.xq[ei_b]  # (nq, sdim)
            xis = invert(vbi, vei, xq)
            # Orient normal: baseline = outward from the owning element.
            n = gf.normal[ei_b].copy()  # (nq, sdim)
            cent = mesh.nodes[vb.corners[vei]].mean(axis=0)
            sgn = np.sign(np.einsum("qs,qs->q", n, xq - cent[None, :]))
            n *= np.where(sgn == 0, 1.0, sgn)[:, None]
            if center is not None:
                # Flip to point away from `center`; when the center lies in
                # the surface plane (cosine ~ 0, e.g. planar flux surfaces)
                # keep the baseline outward orientation.
                d = xq - center[None, :]
                dn = np.linalg.norm(d, axis=-1)
                cos = np.einsum("qs,qs->q", n, d) / np.where(dn > 0, dn, 1.0)
                n *= np.where(cos < -1e-8, -1.0, 1.0)[:, None]
            rows["bucket"].append(vbi)
            rows["elem"].append(vei)
            rows["xi"].append(xis)
            rows["w"].append(gf.wdetJ[ei_b])
            rows["n"].append(n)
            rows["x"].append(xq)
            rows["attr"].append(bb.attr[ei_b])
            if both_sides and len(own) > 1:
                vbi2, vei2 = own[1]
                rows["bucket2"].append(vbi2)
                rows["elem2"].append(vei2)
                rows["xi2"].append(invert(vbi2, vei2, xq))
            else:
                rows["bucket2"].append(-1)
                rows["elem2"].append(-1)
                rows["xi2"].append(np.zeros_like(rows["xi"][-1]))

    return BoundaryTrace(
        bucket=np.array(rows["bucket"], np.int32),
        elem=np.array(rows["elem"], np.int32),
        xi=np.array(rows["xi"]),
        wdetJ=np.array(rows["w"]),
        normal=np.array(rows["n"]),
        xq=np.array(rows["x"]),
        attr=np.array(rows["attr"], np.int32),
        bucket2=np.array(rows["bucket2"], np.int32),
        elem2=np.array(rows["elem2"], np.int32),
        xi2=np.array(rows["xi2"]),
    )


def trace_nd(space, u: np.ndarray, tr: BoundaryTrace, which: str = "value"
             ) -> np.ndarray:
    """ND field (or its curl) at boundary-trace quadrature points: (n, nq, 3).

    which="value": u_phys = J^{-T} u_ref; which="curl": curl u = (1/detJ) J c_ref.
    """
    from palace_torch.utils import smallmat

    mesh = space.mesh
    n, nq = tr.wdetJ.shape
    sdim = mesh.nodes.shape[1]
    out = np.zeros((n, nq, sdim), dtype=u.dtype)
    for bi, b in enumerate(mesh.buckets):
        sel = np.where(tr.bucket == bi)[0]
        if len(sel) == 0:
            continue
        xis = tr.xi[sel].reshape(-1, tr.xi.shape[-1])
        V, C = space.basis_tables(b.geom, xis)
        V = V.reshape(len(sel), nq, -1, V.shape[-1])
        C = C.reshape(len(sel), nq, -1, C.shape[-1])
        gb = ref.gmsh_geometry_basis(b.etype)
        Gg = gb.eval_grad(xis).reshape(len(sel), nq, -1, xis.shape[-1])
        X = mesh.nodes[b.conn[tr.elem[sel]]]
        J = np.einsum("ens,enqr->eqsr", X, Gg.transpose(0, 2, 1, 3))
        ue = u[space.elem_dofs[bi][tr.elem[sel]]]
        sg = getattr(space, "elem_signs", None)
        if sg is not None and sg[bi] is not None:
            ue = ue * sg[bi][tr.elem[sel]]
        if which == "value":
            Jinv = smallmat.inv(J)
            vref = np.einsum("eqnr,en->eqr", V, ue)
            out[sel] = np.einsum("eqrs,eqr->eqs", Jinv, vref)
        elif C.shape[-1] == 1:
            # 2D scalar curl: curl u = curl_ref u_ref / detJ.
            detJ = smallmat.det(J)
            cref = np.einsum("eqn,en->eq", C[..., 0], ue)
            out[sel, :, 0] = cref / detJ
        else:
            detJ = smallmat.det(J)
            cref = np.einsum("eqnr,en->eqr", C, ue)
            out[sel] = np.einsum("eqsr,eqr->eqs", J, cref) / detJ[..., None]
    return out


def trace_gradient(space, u: np.ndarray, tr: BoundaryTrace) -> np.ndarray:
    """Physical gradient of an H1 field at boundary-trace quadrature points:
    (n, nq, sdim)."""
    mesh = space.mesh
    n, nq = tr.wdetJ.shape
    sdim = mesh.nodes.shape[1]
    out = np.zeros((n, nq, sdim), dtype=u.dtype)
    for bi, b in enumerate(mesh.buckets):
        sel = np.where(tr.bucket == bi)[0]
        if len(sel) == 0:
            continue
        basis = space.basis(b.geom)
        gb = ref.gmsh_geometry_basis(b.etype)
        xis = tr.xi[sel].reshape(-1, tr.xi.shape[-1])  # (n_sel*nq, rdim)
        G = basis.eval_grad(xis).reshape(len(sel), nq, -1, xis.shape[-1])
        Gg = gb.eval_grad(xis).reshape(len(sel), nq, -1, xis.shape[-1])
        X = mesh.nodes[b.conn[tr.elem[sel]]]  # (n_sel, nn, sdim)
        J = np.einsum("ens,enqr->eqsr", X, Gg.transpose(0, 2, 1, 3))
        Jinv = np.linalg.inv(J)
        ue = u[space.elem_dofs[bi][tr.elem[sel]]]  # (n_sel, nd)
        gref = np.einsum("eqnr,en->eqr", G, ue)
        out[sel] = np.einsum("eqrs,eqr->eqs", Jinv, gref)
    return out
