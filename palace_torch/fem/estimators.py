"""Flux-recovery error estimation for H(curl) fields (counterpart of
palace_tpu/fem/estimators.py: `_solver`, `grad_flux_indicators`,
`curl_flux_indicators`, in 3D and on 2D meshes).

The discontinuous fluxes (eps E onto RT_{p-1}, mu^-1 curl E onto ND_p) are
L2-projected with a Jacobi-CG mass solve on the operator's device; the
per-element energy-norm mismatch is integrated on the host.  Caches live on
the space object under palace_torch-specific names.
"""

from __future__ import annotations

import numpy as np
import torch

from palace_torch.fem.nd import NDSpace
from palace_torch.fem.nd_operators import nd_operator
from palace_torch.fem.operators import default_qorder
from palace_torch.linalg.iterative import cg
from palace_torch.linalg.smoothers import jacobi
from palace_torch.mesh import geometry as geom_mod
from palace_torch.utils import provenance


def count_mass_route(route: str):
    """Count one flux-recovery mass solve under `route` ("device-cg" or
    "host-splu") in the provenance's `estimator_mass_route`."""
    counts = dict(provenance.snapshot().get("estimator_mass_route", {}))
    counts[route] = counts.get(route, 0) + 1
    provenance.record("estimator_mass_route", counts)


#: Jacobi-CG iteration cap of the flux-recovery mass solves; a solve that
#: reaches it switches its operator to sparse direct.
MASS_CG_MAX_ITS = 1500


def _solver(op):
    """Mass solve for the flux recovery: Jacobi-CG on the operator's device;
    once CG stalls (high order, curved elements) factor the assembled matrix
    and stay sparse-direct, since an unconverged recovery inflates every
    indicator.  Every solve counts its route in the provenance."""
    prec = jacobi(op.diagonal())
    state = {}

    def solve(v):
        if "lu" not in state:
            res = cg(op, torch.as_tensor(np.ascontiguousarray(v),
                                         device=op.device),
                     M=prec, tol=1e-10, max_its=MASS_CG_MAX_ITS)
            if res.converged:
                count_mass_route("device-cg")
                return res.x.cpu().numpy()
            from scipy.sparse.linalg import splu

            state["lu"] = splu(op.assemble_csr().tocsc())
        count_mass_route("host-splu")
        return state["lu"].solve(np.asarray(v))

    return solve


def _phys_rows(Vref: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Physical basis values as (e, n, q * s) rows: X[e, n, (q, s)] =
    sum_r Vref[q, n, r] T[e, q, r, s] (Vref (q, n, r), T (e, q, r, s)).
    Every per-element contraction below is then a batched BLAS product."""
    X = np.matmul(Vref[None], T)  # (e, q, n, s)
    e, q, n, s = X.shape
    return np.ascontiguousarray(X.transpose(0, 2, 1, 3)).reshape(e, n, q * s)


def _at_points(X: np.ndarray, ue: np.ndarray) -> np.ndarray:
    """sum_n ue[e, n] X[e, n, :] -> (e, q * s), for real or complex ue."""
    def mv(u):
        return np.matmul(u[:, None, :], X)[:, 0, :]
    return mv(ue.real) + 1j * mv(ue.imag) if np.iscomplexobj(ue) else mv(ue)


def _moments(X: np.ndarray, f: np.ndarray) -> np.ndarray:
    """sum_(q, s) X[e, n, (q, s)] f[e, (q, s)] -> (e, n), real or complex f."""
    def mv(g):
        return np.matmul(X, g[:, :, None])[:, :, 0]
    return mv(f.real) + 1j * mv(f.imag) if np.iscomplexobj(f) else mv(f)


def _matsqrt_batch(A: np.ndarray) -> np.ndarray:
    """Principal square roots of a batch of symmetric PSD tensors."""
    w, V = np.linalg.eigh(0.5 * (A + np.swapaxes(A, -1, -2)))
    return np.einsum("...ij,...j,...kj->...ik", V, np.sqrt(
        np.maximum(w, 0.0)), V)


def _rt_flux_setup(space: NDSpace, materials, device):
    """(rt, per-bucket setup, M_RT solver), cached on the space (RT order =
    solver order - 1, the reference's B-field space)."""
    cache = getattr(space, "_torch_gradflux_cache", None)
    if cache is not None:
        return cache
    from palace_torch.fem.rt import RTSpace
    from palace_torch.ops.partial import BucketTables, PAOperator

    mesh = space.mesh
    sdim = mesh.nodes.shape[1]
    rt = RTSpace(mesh, space.order - 1)
    setup = []
    mass_tables = []
    for bi, b in enumerate(mesh.buckets):
        q = default_qorder(space.order, b.geo_order, b.geom)
        gf = geom_mod.compute(mesh.nodes, b, q)
        V, _ = space.basis_tables(b.geom, gf.qpts)
        Vr = rt.basis_tables(b.geom, gf.qpts)  # (nq, ndr, sdim)
        ndphys = _phys_rows(V, gf.Jinv)  # J^-T u_ref
        # Signed Piola J w_ref / detJ.
        rtphys = _phys_rows(Vr, np.swapaxes(gf.J, -1, -2)
                            / gf.detJ[:, :, None, None])
        if rt.elem_signs[bi] is not None:
            rtphys = rtphys * rt.elem_signs[bi][:, :, None]
        eps = materials.attr_tensor(
            {a: np.real(t) for a, t in materials.permittivity.items()},
            b.attr)[:, :sdim, :sdim]
        setup.append((gf, ndphys, rtphys, eps, bi))
        w = np.repeat(gf.wdetJ, sdim, axis=1)[:, None, :]
        A = np.matmul(rtphys * w, rtphys.transpose(0, 2, 1))
        mass_tables.append((rt.elem_dofs[bi], A))
    Mrt = PAOperator(rt.num_dofs,
                     [BucketTables(gidx=g, A=A) for g, A in mass_tables],
                     device=device)
    cache = space._torch_gradflux_cache = (rt, setup, _solver(Mrt))
    return cache


def grad_flux_indicators(space: NDSpace, materials, E: np.ndarray,
                         device: torch.device = torch.device("cpu")
                         ) -> np.ndarray:
    """Squared per-element grad-flux indicators for an ND field E:
    eta_K^2 = int_K |sqrt(eps) E - sqrt(eps^-1) D|^2, M_RT D = (eps E, w)."""
    mesh = space.mesh
    signs_list = getattr(space, "elem_signs", [None] * len(mesh.buckets))
    E = np.asarray(E)
    cplx = np.iscomplexobj(E)
    rt, setup, solve = _rt_flux_setup(space, materials, device)

    per_bucket = []
    rows_b = np.zeros(rt.num_dofs, np.complex128 if cplx else np.float64)
    for (gf, ndphys, rtphys, eps, bi) in setup:
        ue = E[space.elem_dofs[bi]]
        if signs_list[bi] is not None:
            ue = ue * signs_list[bi]
        Eq = _at_points(ndphys, ue).reshape(gf.wdetJ.shape + (-1,))
        per_bucket.append((gf, rtphys, eps, Eq, bi))
        flux = np.einsum("est,eqt->eqs", eps, Eq)
        c = _moments(rtphys, (flux * gf.wdetJ[..., None]).reshape(
            flux.shape[0], -1))
        np.add.at(rows_b, rt.elem_dofs[bi].ravel(), c.ravel())
    D = solve(rows_b.real) + (1j * solve(rows_b.imag) if cplx else 0.0)

    eta2 = np.zeros(sum(b.num_elem for b in mesh.buckets))
    ofs = 0
    for (gf, rtphys, eps, Eq, bi) in per_bucket:
        b = mesh.buckets[bi]
        Dq = _at_points(rtphys, D[rt.elem_dofs[bi]]).reshape(Eq.shape)
        sq = _matsqrt_batch(eps)
        isq = _matsqrt_batch(np.linalg.inv(eps))
        diff = (np.einsum("est,eqt->eqs", sq, Eq)
                - np.einsum("est,eqt->eqs", isq, Dq))
        eta2[ofs:ofs + b.num_elem] = np.real(
            np.einsum("eqs,eqs,eq->e", np.conj(diff), diff, gf.wdetJ))
        ofs += b.num_elem
    return eta2


def _floquet_corrected(space: NDSpace, materials, E: np.ndarray,
                       floquet_k: np.ndarray, curls, device):
    """curl E - i y per bucket, y the RT_{p-1} projection of k x E
    (M_RT y = (k x E, w)); the unprojected k x E gives 2.9e-2 on the
    cylinder_floquet indicator Norm, the projection is exact."""
    signs_list = getattr(space, "elem_signs", [None] * len(space.mesh.buckets))
    cplx = np.iscomplexobj(E)
    rt, setup, rsolve = _rt_flux_setup(space, materials, device)
    b_rt = np.zeros(rt.num_dofs, np.complex128 if cplx else np.float64)
    for (gf, ndphys, rtphys, eps, bi) in setup:
        ue = E[space.elem_dofs[bi]]
        if signs_list[bi] is not None:
            ue = ue * signs_list[bi]
        Eq = _at_points(ndphys, ue).reshape(gf.wdetJ.shape + (-1,))
        cx = np.cross(np.broadcast_to(floquet_k, Eq.shape), Eq)
        c = _moments(rtphys, (cx * gf.wdetJ[..., None]).reshape(
            cx.shape[0], -1))
        np.add.at(b_rt, rt.elem_dofs[bi].ravel(), c.ravel())
    y = rsolve(b_rt.real) + (1j * rsolve(b_rt.imag) if cplx else 0.0)
    return [curl - 1j * _at_points(rtphys, y[rt.elem_dofs[bi]]).reshape(
        curl.shape) for (gf, ndphys, rtphys, eps, bi), curl in zip(setup,
                                                                   curls)]


def curl_flux_indicators(space: NDSpace, materials, E: np.ndarray,
                         floquet_k: np.ndarray | None = None,
                         device: torch.device = torch.device("cpu")
                         ) -> np.ndarray:
    """Squared, un-normalized per-element curl-flux indicators for an ND
    field E (complex supported): F = mu^-1 curl E projected onto ND_p,
    eta_K^2 = int_K (curl E - mu F)^T mu^-1 (curl E - mu F).  On a 2D mesh
    the curl is the out-of-plane scalar and F its projection onto scalar
    H1 (`_curl_flux_2d`).

    floquet_k: Bloch wave vector; the estimated flux is then that of the
    physical i omega B = curl E - i k x E, with k x E fed in as its L2
    projection onto the B-field RT space, solved on the device CG
    (reference: eigensolver.cpp:433-439, linalg/floquetcorrection.cpp:
    26-80)."""
    mesh = space.mesh
    if mesh.nodes.shape[1] == 2:
        return _curl_flux_2d(space, materials, np.asarray(E), device)
    signs_list = getattr(space, "elem_signs", [None] * len(mesh.buckets))
    E = np.asarray(E)
    cplx = np.iscomplexobj(E)

    cache = getattr(space, "_torch_curlflux_cache", None)
    if cache is None:
        cache = []
        for b in mesh.buckets:
            q = default_qorder(space.order, b.geo_order, b.geom)
            gf = geom_mod.compute(mesh.nodes, b, q)
            V, C = space.basis_tables(b.geom, gf.qpts)
            muinv = materials.attr_tensor(materials.inv_permeability, b.attr)
            vphys = _phys_rows(V, gf.Jinv)
            cache.append((gf, C, muinv, vphys))
        Mop = nd_operator(space, mass_coef={int(a): np.eye(3)
                                            for a in mesh.attributes()},
                          device=device)
        cache = space._torch_curlflux_cache = (cache, _solver(Mop))
    per_elem, msolve = cache

    per_bucket = []
    for bi, (gf, C, muinv, vphys) in enumerate(per_elem):
        ue = E[space.elem_dofs[bi]]
        if signs_list[bi] is not None:
            ue = ue * signs_list[bi]
        curl_ref = np.einsum("qnc,en->eqc", C, ue)
        per_bucket.append(np.einsum("sreq,eqr->eqs", gf.Jp, curl_ref)
                          / gf.detJ[..., None])
    if floquet_k is not None:
        per_bucket = _floquet_corrected(space, materials, E, floquet_k,
                                        per_bucket, device)
        cplx = True

    b_vec = np.zeros(space.num_dofs, np.complex128 if cplx else np.float64)
    for bi, ((gf, C, muinv, vphys), curl) in enumerate(zip(per_elem,
                                                             per_bucket)):
        flux = np.einsum("est,eqt->eqs", muinv[:, :3, :3], curl)
        c = _moments(vphys, (flux * gf.wdetJ[..., None]).reshape(
            flux.shape[0], -1))
        if signs_list[bi] is not None:
            c = c * signs_list[bi]
        np.add.at(b_vec, space.elem_dofs[bi].ravel(), c.ravel())
    w = msolve(b_vec.real) + (1j * msolve(b_vec.imag) if cplx else 0.0)

    eta2 = np.zeros(sum(b.num_elem for b in mesh.buckets))
    ofs = 0
    for bi, ((gf, C, muinv, vphys), curl) in enumerate(zip(per_elem,
                                                             per_bucket)):
        b = mesh.buckets[bi]
        we = w[space.elem_dofs[bi]]
        if signs_list[bi] is not None:
            we = we * signs_list[bi]
        wq = _at_points(vphys, we).reshape(curl.shape)
        mu = np.linalg.inv(muinv[:, :3, :3])
        diff = curl - np.einsum("est,eqt->eqs", mu, wq)
        mid = np.einsum("est,eqt->eqs", muinv[:, :3, :3], diff)
        eta2[ofs:ofs + b.num_elem] = np.real(
            np.einsum("eqs,eqs,eq->e", np.conj(diff), mid, gf.wdetJ))
        ofs += b.num_elem
    return eta2


def _curl_flux_2d(space: NDSpace, materials, E: np.ndarray,
                  device: torch.device) -> np.ndarray:
    """The 2D branch of `curl_flux_indicators`: the out-of-plane flux
    mu^-1_zz curl E projected onto scalar H1 of the same order (Jacobi-CG
    mass solve on `device`), eta_K^2 = int_K mu^-1_zz |curl E - mu_zz F|^2.
    Geometry, bases and the mass solver are cached on the space."""
    mesh = space.mesh
    signs_list = getattr(space, "elem_signs", [None] * len(mesh.buckets))
    cplx = np.iscomplexobj(E)
    cache = getattr(space, "_torch_curlflux2d_cache", None)
    if cache is None:
        from palace_torch.fem.h1 import H1Space
        from palace_torch.fem.operators import h1_operator

        h1 = H1Space(mesh, space.order)
        per_elem = []
        for b in mesh.buckets:
            q = default_qorder(space.order, b.geo_order, b.geom)
            gf = geom_mod.compute(mesh.nodes, b, q)
            _, C = space.basis_tables(b.geom, gf.qpts)
            muinv_zz = materials.attr_tensor(materials.inv_permeability,
                                             b.attr)[:, 2, 2]
            per_elem.append((gf, C[..., 0], muinv_zz,
                             h1.basis(b.geom).eval(gf.qpts)))
        Mh = h1_operator(h1, mass_coef={int(a): np.eye(3)
                                        for a in mesh.attributes()},
                         device=device)
        cache = space._torch_curlflux2d_cache = (h1, per_elem, _solver(Mh))
    h1, per_elem, hsolve = cache

    curls = []
    bh = np.zeros(h1.num_dofs, np.complex128 if cplx else np.float64)
    for bi, (gf, C0, muinv_zz, B) in enumerate(per_elem):
        ue = E[space.elem_dofs[bi]]
        if signs_list[bi] is not None:
            ue = ue * signs_list[bi]
        curl = np.einsum("qn,en->eq", C0, ue) / gf.detJ
        curls.append(curl)
        c = np.einsum("qn,eq->en", B, curl * muinv_zz[:, None] * gf.wdetJ)
        np.add.at(bh, h1.elem_dofs[bi].ravel(), c.ravel())
    w = hsolve(bh.real) + (1j * hsolve(bh.imag) if cplx else 0.0)

    eta2 = np.zeros(sum(b.num_elem for b in mesh.buckets))
    ofs = 0
    for bi, ((gf, C0, muinv_zz, B), curl) in enumerate(zip(per_elem, curls)):
        n = curl.shape[0]
        wq = np.einsum("qn,en->eq", B, w[h1.elem_dofs[bi]])
        diff = curl - wq / muinv_zz[:, None]
        eta2[ofs:ofs + n] = np.einsum("eq,e,eq->e", np.abs(diff) ** 2,
                                      muinv_zz, gf.wdetJ)
        ofs += n
    return eta2
