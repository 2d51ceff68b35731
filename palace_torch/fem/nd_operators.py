"""H(curl) bilinear forms: mass (eps u, v), curl-curl (nu curl u, curl v)
and the antisymmetric Floquet cross term (counterpart of
palace_tpu/fem/nd_operators.py; `nd_operator` also in qdata mode).

Covariant (value) transform: u = J^{-T} u_ref, so the mass qdata is
Jinv C Jinv^T; contravariant (curl) transform: curl u = (1/detJ) J curl_ref
u_ref, so the curl-curl qdata is (w / |detJ|) J^T nu J.  Element matrices are
assembled on the host (numpy) and held by a `PAOperator` on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from palace_torch.fem import reference as ref
from palace_torch.fem.nd import NDSpace
from palace_torch.fem.operators import _per_elem_tensor, default_qorder
from palace_torch.mesh import geometry
from palace_torch.ops.partial import BucketTables, PAOperator


def _planar_sandwich(Ap, C, right_p, wscale):
    """W[r, u] = wscale * sum_{s,t} Ap[r,s] C[:,s,t] right_p[u,t], planar."""
    r = Ap.shape[0]
    sdim = C.shape[-1]
    Wp = np.zeros((r, r) + wscale.shape)
    for rr in range(r):
        for uu in range(r):
            for s_ in range(sdim):
                for t_ in range(sdim):
                    cst = C[:, s_, t_]
                    if not np.any(cst):
                        continue
                    Wp[rr, uu] += Ap[rr, s_] * cst[:, None] * right_p[uu, t_]
    Wp *= wscale[None, None]
    return Wp


def _assemble_mixed(L: np.ndarray, R: np.ndarray, Wp: np.ndarray
                    ) -> np.ndarray:
    """A[e]_ij = sum_q L_q[i]^T W_q R_q[j] with distinct left and right
    tables (both (nq, nd, d)); Wp planar (d, d, E, nq)."""
    nq, nd, d = L.shape
    E = Wp.shape[2]
    S = (
        L.transpose(2, 0, 1)[:, None, :, :, None]
        * R.transpose(2, 0, 1)[None, :, :, None, :]
    ).reshape(d * d * nq, nd * nd)
    W = np.ascontiguousarray(
        np.moveaxis(Wp.reshape(d * d, E, nq), 1, 0)
    ).reshape(E, d * d * nq)
    return (W @ S).reshape(E, nd, nd)


def _assemble(G: np.ndarray, Wp: np.ndarray) -> np.ndarray:
    """A[e] = sum_q G_q^T W_q G_q from planar qdata Wp (d, d, E, nq) and
    shared tables G (nq, nd, d): one dgemm against the static S tensor."""
    return _assemble_mixed(G, G, Wp)


def nd_operator(
    space: NDSpace,
    *,
    curl_coef: Optional[Dict[int, np.ndarray]] = None,
    mass_coef: Optional[Dict[int, np.ndarray]] = None,
    device: torch.device = torch.device("cpu"),
    mode: str = "element",
) -> PAOperator:
    """(nu curl u, curl v) + (eps u, v) on an ND space.  On a 2D mesh (a
    wave port's cross-section) the curl is the scalar out-of-plane component
    and its coefficient the zz entry of each 3x3 `curl_coef` tensor.

    mode="element": dense per-element matrices (one batched matmul apply).
    mode="qdata": quadrature-point partial assembly with shared basis tables
    (the curl table in G, the value table in G2); the curl term is 3D-only
    there, as in palace_tpu."""
    mesh = space.mesh
    sdim = mesh.nodes.shape[1]
    signs_list = getattr(space, "elem_signs", [None] * len(mesh.buckets))
    buckets: List[BucketTables] = []
    for b, ed, sg in zip(mesh.buckets, space.elem_dofs, signs_list):
        p = space.order
        q = default_qorder(p, b.geo_order, b.geom)
        gf = geometry.compute(mesh.nodes, b, q)
        V, C = space.basis_tables(b.geom, gf.qpts)  # (nq, nd, dim), (nq, nd, dc)
        if mode == "qdata":
            bt = BucketTables(gidx=ed, signs=sg)
            if mass_coef is not None:
                Cm = _per_elem_tensor(mass_coef, b.attr, sdim)
                Wm = _planar_sandwich(gf.Jinvp, Cm, gf.Jinvp, gf.wdetJ)
                bt.G2 = V
                bt.qd_diff2 = np.ascontiguousarray(
                    np.moveaxis(Wm, (0, 1), (2, 3)))
            if curl_coef is not None:
                if sdim != 3:
                    raise NotImplementedError("qdata mode is 3D-only for now")
                Cc = _per_elem_tensor(curl_coef, b.attr, sdim)
                JT = gf.Jp.transpose(1, 0, 2, 3)
                wsc = gf.w[None, :] / np.abs(gf.detJ)
                Wc = _planar_sandwich(JT, Cc, JT, wsc)
                bt.G = C
                bt.qd_diff = np.ascontiguousarray(
                    np.moveaxis(Wc, (0, 1), (2, 3)))
            buckets.append(bt)
            continue
        A = None
        if mass_coef is not None:
            Cm = _per_elem_tensor(mass_coef, b.attr, sdim)
            Wm = _planar_sandwich(gf.Jinvp, Cm, gf.Jinvp, gf.wdetJ)
            A = _assemble(V, Wm)
        if curl_coef is not None:
            if sdim == 3:
                Cc = _per_elem_tensor(curl_coef, b.attr, sdim)
                JT = gf.Jp.transpose(1, 0, 2, 3)  # (r, s, E, nq)
                wsc = gf.w[None, :] / np.abs(gf.detJ)
                Wc = _planar_sandwich(JT, Cc, JT, wsc)
            else:
                # 2D: (w / |detJ|) nu_zz, read before any in-plane
                # truncation.
                uniq = np.unique(b.attr)
                lut = np.zeros(int(uniq.max()) + 1)
                for a in uniq:
                    t = np.asarray(curl_coef[int(a)], float)
                    lut[int(a)] = (float(t) if t.ndim == 0 else
                                   float(t[2, 2]) if t.shape[0] > 2 else
                                   float(t[0, 0]))
                Wc = (gf.w[None, :] / np.abs(gf.detJ)
                      * lut[b.attr][:, None])[None, None]
            Ac = _assemble(C, Wc)
            A = Ac if A is None else A + Ac
        buckets.append(BucketTables(gidx=ed, A=A, signs=sg))
    op = PAOperator(space.num_dofs, buckets, device=device, mode=mode)
    op.space = space  # for locality partitioning (parallel/dofsharded.py)
    return op


def nd_cross_operator(space: NDSpace, coef: Dict[int, np.ndarray],
                      device: torch.device = torch.device("cpu")
                      ) -> PAOperator:
    """Antisymmetric Floquet cross term -(B - B^T), B_ij = (Q u_j, curl v_i)
    with Q = mu^-1 [k x] (reference: palace/models/spaceoperator.cpp:302-306,
    materialoperator.cpp:351).

    Consumed as K + i * (this): the Hermitian Bloch operator
    K_cc + (kx)^T mu^-1 kx - i (B - B^T), whose spectrum on a periodic PEC
    box is the exact omega^2 = pi^2 (m^2 + n^2) + (k + 2 pi l)^2 for both
    propagation directions; the symmetric combination B + B^T loses the
    backward branch.  Pullbacks: value u = J^-T u_ref, curl u = (1/detJ)
    J curl_ref u_ref, so B has qdata w sign(detJ) J^T Q J^-T."""
    mesh = space.mesh
    sdim = mesh.nodes.shape[1]
    if sdim != 3:
        raise NotImplementedError(
            "Floquet cross term is 3D-only (reference: "
            "materialoperator.cpp:390-392)")
    signs_list = getattr(space, "elem_signs", [None] * len(mesh.buckets))
    buckets: List[BucketTables] = []
    for b, ed, sg in zip(mesh.buckets, space.elem_dofs, signs_list):
        q = default_qorder(space.order, b.geo_order, b.geom)
        gf = geometry.compute(mesh.nodes, b, q)
        V, C = space.basis_tables(b.geom, gf.qpts)
        Q = _per_elem_tensor(coef, b.attr, sdim)
        JT = gf.Jp.transpose(1, 0, 2, 3)  # (r, s, E, nq): J^T planar
        wsgn = gf.w[None, :] * np.sign(gf.detJ)
        B = _assemble_mixed(C, V, _planar_sandwich(JT, Q, gf.Jinvp, wsgn))
        buckets.append(BucketTables(gidx=ed, A=B.transpose(0, 2, 1) - B,
                                    signs=sg))
    op = PAOperator(space.num_dofs, buckets, device=device)
    op.space = space
    return op


def nd_h1_gradient(nd_space: NDSpace, h1_space):
    """Discrete gradient matrix G: H1_p -> ND_p with grad(V_h) = G V_h exactly
    (one reference-space least squares per geometry, assembled into a global
    scipy CSR; both transforms are covariant)."""
    import scipy.sparse as sp

    mesh = nd_space.mesh
    rows, cols, vals = [], [], []
    seen = np.zeros(nd_space.num_dofs, bool)
    for bi, b in enumerate(mesh.buckets):
        geom = b.geom
        p = nd_space.order
        pts, _ = ref.quadrature(geom, 2 * p + 2)
        V, _ = nd_space.basis_tables(geom, pts)  # (nq, nd_nd, dim)
        Gh1 = h1_space.basis(geom).eval_grad(pts)  # (nq, nd_h1, dim)
        nq, ndn, dim = V.shape
        ndh = Gh1.shape[1]
        Vm = V.transpose(0, 2, 1).reshape(nq * dim, ndn)
        Gm = Gh1.transpose(0, 2, 1).reshape(nq * dim, ndh)
        loc = np.linalg.lstsq(Vm, Gm, rcond=None)[0]  # (ndn, ndh)
        resid = np.linalg.norm(Vm @ loc - Gm)
        if resid > 1e-8:
            raise RuntimeError(
                f"discrete gradient: grad(H1_{p}) not contained in ND_{p} "
                f"basis span on {geom} (residual {resid:.2e})")
        loc[np.abs(loc) < 1e-12] = 0.0
        ndofs = nd_space.elem_dofs[bi]
        hdofs = h1_space.elem_dofs[bi]
        sg = getattr(nd_space, "elem_signs", [None] * len(mesh.buckets))[bi]
        # Each ND row is written by (any) one adjacent element.
        for n in range(ndn):
            nz = np.nonzero(loc[n])[0]
            if len(nz) == 0:
                continue
            r = ndofs[:, n]
            uniq_r, first = np.unique(r, return_index=True)
            keep = first[~seen[uniq_r]]
            if len(keep) == 0:
                continue
            seen[r[keep]] = True
            sk = sg[keep, n] if sg is not None else 1.0
            for m in nz:
                rows.append(r[keep])
                cols.append(hdofs[keep, m])
                vals.append(loc[n, m] * np.ones(len(keep)) * sk)
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nd_space.num_dofs, h1_space.num_dofs),
    ).tocsr()
