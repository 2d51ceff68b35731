"""Wave port boundaries: the 2D boundary-mode eigenproblem on the port
cross-section (counterpart of palace_tpu/models/waveport.py; reference:
palace/models/waveportoperator.cpp, modeeigensolver.cpp).

Per frequency, solve the Vardapetyan-Demkowicz linearized boundary-mode
generalized eigenproblem on the extracted port submesh

    [Att  Atn] [et ]          [Btt  0] [et ]
    [-s Btn Ann] [en~] = lam  [Btn  0] [en~],   Btn = -Atn^T,

with Att = (mucc^-1 curl_t u, curl_t v) - w^2 (eps_t u, v) - s (mu_t^-1 u, v),
Ann = -(mu_t^-1 grad u, grad v) + w^2 (eps_nn u, v), Atn = -(mu_t^-1 grad u, v),
shift s = -w^2 mu eps_max 1.1, kn = sqrt(-s - lam)
(modeeigensolver.hpp:37-95, waveportoperator.cpp:497-655), on the host
(scipy `eigs` in shift-invert form over one SuperLU factorization).  The 2D
H(curl) and H1 forms are the port's own `nd_operator` / `h1_operator` on a
2D mesh, assembled to scipy CSRs on the CPU.

The propagating mode couples into the 3D driven system as (a) a boundary
term +i Re kn (mu^-1 u_t, v_t) on the port surface and (b) the excitation
RHS2 built from the modal n x H field (waveportoperator.cpp:1258-1330);
S-parameters are modal overlaps S = -int conj(s_field) . E dS
(waveportoperator.cpp:832-850).

Differences from the JAX package: the gradient deflation's setup catches
only SuperLU's singular-factor error (an H1 space with no essential dof on
the port), where palace_tpu drops the deflation on any exception; whether
it ran is recorded in the provenance (`waveport<i>_deflation`), as are the
count and host seconds of the uncached mode solves (`waveport_mode_solves`,
`waveport_mode_seconds`), and each solution says which phase reference
`_normalize` used (`ModeSolution.phase`).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import scipy.sparse as sp

from palace_torch.config import IoData
from palace_torch.fem import reference as ref
from palace_torch.fem.h1 import H1Space
from palace_torch.fem.nd import NDSpace
from palace_torch.fem.nd_operators import nd_h1_gradient, nd_operator
from palace_torch.fem.operators import default_qorder, h1_operator
from palace_torch.fem.reference import Geom
from palace_torch.mesh import geometry
from palace_torch.mesh.mesh import ElemBucket, Mesh, canonicalize_simplices
from palace_torch.utils import provenance


@dataclass
class ModeSolution:
    kn: complex
    et: np.ndarray  # complex, port ND dofs
    en: np.ndarray  # complex, port H1 dofs (physical En after back-transform)
    V_exc: complex = 0.0  # mode voltage int E_mode . dl along the VoltagePath
    #: Phase reference `_normalize` used: "quadrant" (the reference's
    #: polarization functional) or "largest-dof" (its degenerate fallback).
    phase: str = "quadrant"


class WavePortData:
    """One wave port: extracted 2D submesh, spaces, and per-frequency mode."""

    def __init__(self, iodata: IoData, mesh: Mesh, cfg, materials, dbc_attrs):
        from palace_torch.fem.evaluation import boundary_trace

        self.cfg = cfg
        self._iodata = iodata
        self.index = cfg.index
        self.attrs = list(cfg.attributes)
        self.excitation = cfg.excitation
        self.active = cfg.active
        self.mode_idx = max(cfg.mode, 1)
        self.materials = materials
        order = iodata.solver.order

        # -- port facets (tris or quads, possibly curved)
        facets = []  # full facet conns (geometry nodes included)
        fgeom, fetype, fgorder = None, None, 1
        for bb in mesh.bdr_buckets:
            if bb.geom not in (Geom.TRI, Geom.QUAD):
                continue
            sel = np.isin(bb.attr, self.attrs)
            if sel.any():
                if fgeom is not None and fgeom is not bb.geom:
                    raise NotImplementedError(
                        f"wave port {self.index}: mixed facet geometries")
                fgeom, fetype, fgorder = bb.geom, bb.etype, bb.geo_order
                facets.append(bb.conn[sel])
        if not facets:
            raise ValueError(f"wave port {self.index}: no boundary facets")
        connfull = np.concatenate(facets)  # (F, nn) all geometry nodes
        ncorner = len(ref.GEOM_VERTICES[fgeom])
        conn3d = connfull[:, :ncorner]
        # Straight triangular ports are rebuilt from corners (affine
        # inversion); curved tri ports (mid-edge nodes off the edge
        # midpoints) keep the full isoparametric geometry, as quad ports
        # always do.
        if fgeom is Geom.TRI and fgorder > 1:
            dev = 0.0
            # Gmsh tri6/tri10 edge k = (0,1), (1,2), (2,0); the first 3
            # higher-order nodes are the corresponding mid-edge nodes.
            for k, (a, c) in enumerate(((0, 1), (1, 2), (2, 0))):
                mid = 0.5 * (mesh.nodes[connfull[:, a]]
                             + mesh.nodes[connfull[:, c]])
                el = np.linalg.norm(mesh.nodes[connfull[:, a]]
                                    - mesh.nodes[connfull[:, c]], axis=1)
                dev = max(dev, float((np.linalg.norm(
                    mesh.nodes[connfull[:, ncorner + k]] - mid, axis=1)
                    / np.maximum(el, 1e-300)).max()))
            if dev < 1e-10:
                connfull = conn3d
                fetype, fgorder = 2, 1
        elif fgeom is Geom.TRI:
            connfull = conn3d
            fetype, fgorder = 2, 1

        # -- plane frame (t1, t2, n), n oriented outward from the domain
        nodes_ids = np.unique(connfull.ravel())
        P3 = mesh.nodes[nodes_ids]
        self._port_nodes3 = P3
        self.origin = P3.mean(axis=0)
        X = P3 - self.origin
        _, svals, VT = np.linalg.svd(X, full_matrices=False)
        if svals[-1] > 1e-8 * svals[0]:
            raise NotImplementedError(
                f"wave port {self.index}: non-planar port surface")
        n = VT[2]
        t1 = VT[0]
        t2 = np.cross(n, t1)  # right-handed (t1, t2, n)
        self.trace = boundary_trace(mesh, self.attrs,
                                    default_qorder(order, fgorder, fgeom))
        vb = mesh.buckets[self.trace.bucket[0]]
        cent = mesh.nodes[vb.corners[self.trace.elem[0]]].mean(axis=0)
        if np.dot(n, cent - self.origin) > 0:
            n = -n
            t2 = -t2
        self.normal, self.t1, self.t2 = n, t1, t2

        # -- 2D submesh in the (t1, t2) frame
        g2l = {int(g): i for i, g in enumerate(nodes_ids)}
        nodes2 = np.stack([X @ t1, X @ t2], axis=1)
        conn2full = np.vectorize(g2l.get)(connfull).astype(np.int32)
        conn2 = conn2full[:, :ncorner]
        self.l2g = nodes_ids  # 2d node -> 3d node

        # Boundary edges of the submesh, with the parent 3D Dirichlet
        # surfaces (PEC, WavePortPEC and the other ports' attributes) marked
        # essential; those may also be interior lines of the submesh (a
        # metal trace crossing the port plane).
        edge_locals = (ref.GEOM_EDGES[Geom.TRI] if fgeom is Geom.TRI
                       else ref.GEOM_EDGES[Geom.QUAD])
        edges = np.sort(conn2[:, [list(e) for e in edge_locals]].reshape(
            -1, 2), axis=1)
        uniq, counts = np.unique(edges, axis=0, return_counts=True)
        dbc_all = self._mark_dbc_edges(mesh, uniq, dbc_attrs)
        sel = (counts == 1) | dbc_all
        bedges = uniq[sel]
        bdr_attr = np.where(dbc_all[sel], 1, 2).astype(np.int32)  # 1 = dbc

        self.mesh2 = Mesh(
            nodes2,
            [ElemBucket(fetype, fgeom, fgorder, conn2full,
                        np.ones(len(conn2full), np.int32))],
            [ElemBucket(1, Geom.LINE, 1, bedges.astype(np.int32), bdr_attr)],
            {},
        )
        # Per-element volume attribute (from the 3D trace, same facet order).
        attr_of_facet = np.empty(len(conn2), np.int32)
        for bi, b in enumerate(mesh.buckets):
            s = self.trace.bucket == bi
            attr_of_facet[s] = b.attr[self.trace.elem[s]]
        self.mesh2.buckets[0].attr = attr_of_facet
        canonicalize_simplices(self.mesh2)

        self.nd = NDSpace(self.mesh2, order)
        self.h1 = H1Space(self.mesh2, order)
        self.ess_nd = self.nd.boundary_dofs([1])
        self.ess_h1 = self.h1.boundary_dofs([1])

        # -- projected material tensors per attribute
        Pm = np.stack([t1, t2], axis=1)  # (3, 2)
        self.eps_t: Dict[int, np.ndarray] = {}
        self.muinv_t: Dict[int, np.ndarray] = {}
        self.mucc: Dict[int, np.ndarray] = {}
        self.eps_nn: Dict[int, float] = {}
        self.eps_t_imag: Dict[int, np.ndarray] = {}
        lossy = materials.has_loss()
        epsc = materials.complex_permittivity() if lossy else {
            a: t.astype(complex) for a, t in materials.permittivity.items()}
        mu_eps_max = 0.0
        for a in np.unique(attr_of_facet):
            a = int(a)
            eps3 = epsc[a]
            mi3 = materials.inv_permeability[a]
            self.eps_t[a] = Pm.T @ np.real(eps3) @ Pm
            self.eps_t_imag[a] = Pm.T @ np.imag(eps3) @ Pm
            self.muinv_t[a] = Pm.T @ mi3 @ Pm
            self.mucc[a] = np.diag([0.0, 0.0, float(n @ mi3 @ n)])
            self.eps_nn[a] = float(np.real(n @ eps3 @ n))
            mu3 = np.linalg.inv(mi3)
            w = np.linalg.eigvalsh(0.5 * (mu3 @ np.real(eps3)
                                          + (mu3 @ np.real(eps3)).T))
            mu_eps_max = max(mu_eps_max, float(w.max()))
        self.mu_eps_max = mu_eps_max * 1.1

        # Frequency-independent matrices.
        self._Btt = self._nd_mass(self.muinv_t)
        self._Ktt = nd_operator(self.nd, curl_coef=self.mucc).assemble_csr()
        self._Mtt = self._nd_mass(self.eps_t)
        self._Mtt_i = (self._nd_mass(self.eps_t_imag)
                       if any(np.any(t != 0) for t in self.eps_t_imag.values())
                       else None)
        self._Atn = self._mixed_grad(self.muinv_t)
        self._Knn = h1_operator(self.h1, diffusion_coef={
            a: _pad3(t) for a, t in self.muinv_t.items()}).assemble_csr()
        self._Mnn = h1_operator(self.h1, mass_coef={
            a: np.eye(3) * self.eps_nn[a] for a in self.eps_nn}).assemble_csr()
        # Discrete gradient and the essential-eliminated Knn factorization
        # for the gradient deflation in solve_mode.  Knn is singular when no
        # H1 dof of the port is essential; the mode is then solved without
        # the deflation, as in palace_tpu, and the provenance says so.
        from scipy.sparse.linalg import splu

        self._Gnd = nd_h1_gradient(self.nd, self.h1)
        Ke = self._Knn.astype(complex).tolil()
        Ke[self.ess_h1, :] = 0.0
        Ke[:, self.ess_h1] = 0.0
        Ke[self.ess_h1, self.ess_h1] = 1.0
        try:
            self._Knn_lu = splu(Ke.tocsc())
        except RuntimeError:  # SuperLU: "Factor is exactly singular"
            self._Gnd = None
        provenance.record(f"waveport{self.index}_deflation",
                          self._Gnd is not None)

        self._mode_cache: Dict[float, ModeSolution] = {}

    # -- assembly helpers ---------------------------------------------------

    def _nd_mass(self, coef2):
        return nd_operator(self.nd, mass_coef={
            a: _pad3(t) for a, t in coef2.items()}).assemble_csr()

    def _mixed_grad(self, coef2) -> sp.csr_matrix:
        """Atn = +(mu_t^-1 grad_t u_h1, v_nd) as (nd, h1) CSR.

        Sign convention: with e_n_tilde = i kn E_n and lambda = kn^2 the
        self-consistent pencil is
          [Ktt - w^2 Mtt,  Atn ] [et ]         [Btt,    0] [et ]
          [      0,        Ann ] [en~] = lam   [Atn^T,  0] [en~]
        (equivalent to the reference's -Atn / -kn^2 bookkeeping,
        modeeigensolver.hpp:37-55, up to simultaneous sign flips).
        """
        b = self.mesh2.buckets[0]
        q = default_qorder(self.nd.order, b.geo_order, b.geom)
        gf = geometry.compute(self.mesh2.nodes, b, q)
        V, _ = self.nd.basis_tables(b.geom, gf.qpts)  # (nq, ndn, 2)
        Gh = self.h1.basis(b.geom).eval_grad(gf.qpts)  # (nq, ndh, 2)
        uniq = np.unique(b.attr)
        C = np.stack([_trunc2(coef2[int(a)]) for a in uniq])
        lut_i = {int(a): i for i, a in enumerate(uniq)}
        Ce = C[[lut_i[int(a)] for a in b.attr]]  # (E, 2, 2)
        J = np.moveaxis(gf.Jinvp, (0, 1), (2, 3))  # (E, nq, r, s)
        # physical: grad u = Jinv^T G, v = Jinv^T V
        gph = np.einsum("eqrs,qnr->eqns", J, Gh)
        vph = np.einsum("eqrs,qnr->eqns", J, V)
        cg = np.einsum("est,eqnt->eqns", Ce, gph)
        A = np.einsum("eq,eqms,eqns->emn", gf.wdetJ, vph, cg, optimize=True)
        if self.nd.elem_signs[0] is not None:
            A = A * self.nd.elem_signs[0][:, :, None]
        nd_d = self.nd.elem_dofs[0]
        h1_d = self.h1.elem_dofs[0]
        E, ndn = nd_d.shape
        ndh = h1_d.shape[1]
        rows = np.repeat(nd_d, ndh, axis=1).ravel()
        cols = np.tile(h1_d, (1, ndn)).ravel()
        return sp.coo_matrix(
            (A.reshape(E, -1).ravel(), (rows, cols)),
            shape=(self.nd.num_dofs, self.h1.num_dofs)).tocsr()

    # -- mode solve ---------------------------------------------------------

    def solve_mode(self, omega: float) -> ModeSolution:
        key = round(omega, 12)
        if key in self._mode_cache:
            return self._mode_cache[key]
        from scipy.sparse.linalg import LinearOperator, eigs, splu

        t0 = time.perf_counter()
        # lambda = -kn^2; shift at minus the max propagation constant squared
        # (reference: waveportoperator.cpp:497-502,639).
        sigma = -omega * omega * self.mu_eps_max
        Att = (self._Ktt - omega * omega * self._Mtt).astype(complex)
        if self._Mtt_i is not None:
            Att = Att - 1j * omega * omega * self._Mtt_i
        Ann = (-self._Knn + omega * omega * self._Mnn).astype(complex)
        Atn = (-self._Atn).tocsr().astype(complex)
        Btn = self._Atn.T.tocsr().astype(complex)
        nnd, nh1 = self.nd.num_dofs, self.h1.num_dofs

        def elim(M, ess_r, ess_c, diag):
            M = M.tolil()
            M[ess_r, :] = 0.0
            M[:, ess_c] = 0.0
            if diag:
                M[ess_r, ess_r] = 1.0
            return M.tocsr()

        Att = elim(Att, self.ess_nd, self.ess_nd, True)
        Ann = elim(Ann, self.ess_h1, self.ess_h1, True)
        Atn = elim(Atn, self.ess_nd, self.ess_h1, False)
        Btn = elim(Btn, self.ess_h1, self.ess_nd, False)
        Btt = elim(self._Btt.astype(complex), self.ess_nd, self.ess_nd, False)

        A = sp.bmat([[Att, Atn],
                     [sp.csr_matrix((nh1, nnd)), Ann]], format="csc")
        B = sp.bmat([[Btt, None],
                     [Btn, sp.csr_matrix((nh1, nh1))]], format="csc")
        nev = self.mode_idx + 4
        # Shift-and-invert by hand: T = (A - sigma B)^-1 B as a plain
        # nonsymmetric eigenproblem (ARPACK's generalized mode needs an SPD
        # mass matrix, which the singular nonsymmetric B is not).
        lu = splu((A - sigma * B).tocsc())
        n_tot = nnd + nh1
        T = LinearOperator((n_tot, n_tot), matvec=lambda x: lu.solve(B @ x),
                           dtype=complex)
        mu, vecs = eigs(T, k=nev, which="LM", tol=self.cfg.eig_tol)
        lam = sigma + 1.0 / mu
        # kn = sqrt(-lambda), sorted by decreasing Re(kn) (most strongly
        # propagating first).
        kn = np.sqrt(-lam + 0j)
        kn = np.where(np.real(kn) < 0, -kn, kn)
        order = np.argsort(-np.real(kn))
        pick = order[self.mode_idx - 1]
        kn_m = complex(kn[pick])
        v = vecs[:, pick]
        et = v[:nnd]
        en_t = v[nnd:]
        # The pencil carries a family of gradient-type eigenvalues from the
        # port's Dirichlet spectrum; one near the physical lambda mixes into
        # the Arnoldi vector.  Deflate: remove the (Btt-orthogonal) gradient
        # component et -= G Knn^-1 G^T Btt et and recompute en from the
        # n-equation.
        if self._Gnd is not None:
            lam_m = complex(lam[pick])
            g = self._Gnd.T @ (self._Btt @ et)
            g[self.ess_h1] = 0.0
            y = self._Knn_lu.solve(g)
            et = et - self._Gnd @ y
            et[self.ess_nd] = 0.0
            rn = lam_m * (Btn @ et)
            rn[self.ess_h1] = 0.0
            en_t = splu(Ann.tocsc()).solve(rn)
        en = en_t / (1j * kn_m)  # VD back-transform
        sol = ModeSolution(kn_m, et, en)
        self._normalize(sol, omega)
        self._mode_cache[key] = sol
        provenance.add("waveport_mode_solves", 1)
        provenance.add("waveport_mode_seconds", time.perf_counter() - t0)
        return sol

    # -- field evaluation at the 3D trace quadrature points -----------------

    def _facet_tables(self):
        """2D basis tables at the trace quadrature points of each facet."""
        if hasattr(self, "_ft"):
            return self._ft
        mesh2 = self.mesh2
        b = mesh2.buckets[0]
        tr = self.trace
        nfac, nq = tr.wdetJ.shape
        # 2D coordinates of the 3D quadrature points.
        xq2 = np.einsum("fqs,sr->fqr", tr.xq - self.origin,
                        np.stack([self.t1, self.t2], axis=1))
        geom = b.geom
        if geom is Geom.TRI and b.geo_order == 1:
            # Reference coords in each (straight) 2D triangle.
            X = mesh2.nodes[b.corners]  # (F, 3, 2)
            v0 = X[:, 0]
            Jm = np.stack([X[:, 1] - v0, X[:, 2] - v0], axis=2)  # (F, 2, 2)
            Ja = np.linalg.inv(Jm)  # (F, 2, 2)
            xi = np.einsum("frs,fqs->fqr", Ja, xq2 - v0[:, None, :])
            Jinv = np.broadcast_to(Ja[:, None], (nfac, nq, 2, 2))
        else:
            # Curved quads/tris: Newton-invert the isoparametric map per
            # facet, with the per-point inverse Jacobian for the transforms.
            gb = ref.gmsh_geometry_basis(b.etype)
            Xn = mesh2.nodes[b.conn]  # (F, nn, 2)
            xi0 = 1.0 / 3.0 if geom is Geom.TRI else 0.5
            xi = np.full((nfac, nq, 2), xi0)
            for _ in range(25):
                B = np.stack([gb.eval(xi[f]) for f in range(nfac)])
                G = np.stack([gb.eval_grad(xi[f]) for f in range(nfac)])
                x_cur = np.einsum("fqn,fns->fqs", B, Xn)
                Jq = np.einsum("fqnr,fns->fqsr", G, Xn)  # dx_s/dxi_r
                r = xq2 - x_cur
                if np.abs(r).max() < 1e-12:
                    break
                xi = xi + np.einsum("fqrs,fqs->fqr", np.linalg.inv(Jq), r)
            # inv of J[s,r] = dx_s/dxi_r gives Jinv[r,s] = dxi_r/dx_s, the
            # same (r, s) layout as the affine path.
            Jinv = np.linalg.inv(Jq)  # (F, nq, 2, 2)
        VA, CA, GH, BH = [], [], [], []
        h1b = self.h1.basis(geom)
        for f in range(nfac):
            V, C = self.nd.basis_tables(geom, xi[f])
            GH.append(h1b.eval_grad(xi[f]))
            BH.append(h1b.eval(xi[f]))
            VA.append(V)
            CA.append(C)
        self._ft = (np.stack(VA), np.stack(CA), np.stack(BH), np.stack(GH),
                    Jinv)
        return self._ft

    def mode_fields_at_trace(self, sol: ModeSolution):
        """(Et3, gradEn3, En) at trace qpoints: 3D-frame complex arrays."""
        VA, _, BH, GH, Jinv = self._facet_tables()
        nd_d = self.nd.elem_dofs[0]
        h1_d = self.h1.elem_dofs[0]
        et_e = sol.et[nd_d]  # (F, ndn)
        if self.nd.elem_signs[0] is not None:
            et_e = et_e * self.nd.elem_signs[0]
        en_e = sol.en[h1_d]
        # Covariant transforms with the per-(facet, point) Jinv.
        et2 = np.einsum("fqrs,fqnr,fn->fqs", Jinv, VA, et_e)
        gn2 = np.einsum("fqrs,fqnr,fn->fqs", Jinv, GH, en_e)
        en_q = np.einsum("fqn,fn->fq", BH, en_e)
        lift = np.stack([self.t1, self.t2], axis=0)  # (2, 3)
        Et3 = np.einsum("fqs,st->fqt", et2, lift)
        Gn3 = np.einsum("fqs,st->fqt", gn2, lift)
        return Et3, Gn3, en_q

    def nxh_field(self, sol: ModeSolution, omega: float) -> np.ndarray:
        """Complex modal (n x H)-type vector at trace qpoints (the reference's
        BdrSubmeshHVectorCoefficient, waveportoperator.cpp:121-150):
        V = mu^-1 (-kn_re Et - (1/i) grad_t En) / omega."""
        Et3, Gn3, _ = self.mode_fields_at_trace(sol)
        attrs = self.mesh2.buckets[0].attr  # facet volume attrs (same order)
        muinv = self.materials.attr_tensor(self.materials.inv_permeability,
                                           attrs)
        kr = sol.kn.real
        U_re = -kr * np.real(Et3) - np.imag(Gn3)
        U_im = -kr * np.imag(Et3) + np.real(Gn3)
        U = U_re + 1j * U_im
        return np.einsum("fst,fqt->fqs", muinv, U) / omega

    def _quadrant_mask(self):
        """Indicator of the port's "upper-right quadrant" at the trace
        quadrature points: x[da] >= c_a and x[db] >= c_b in the parent 3D
        frame, where da/db are the two largest bbox extents of the port
        (reference: waveportoperator.cpp:533-577 TDirection / port_S0t)."""
        if hasattr(self, "_quad_mask"):
            return self._quad_mask
        P3 = self._port_nodes3
        bbmin, bbmax = P3.min(axis=0), P3.max(axis=0)
        order = np.argsort(-(bbmax - bbmin), kind="stable")
        da, db = int(order[0]), int(order[1])
        ca = 0.5 * (bbmax[da] + bbmin[da])
        cb = 0.5 * (bbmax[db] + bbmin[db])
        xq = self.trace.xq  # (F, nq, 3)
        self._quad_mask = ((xq[..., da] >= ca)
                           & (xq[..., db] >= cb)).astype(float)
        return self._quad_mask

    def _normalize(self, sol: ModeSolution, omega: float):
        """Unit power |int E . (-n x H*) dS| = 1 with the reference's phase
        convention: rotate so that int_quadrant sum_s (n x H)_s dS is
        real-positive (the S0t polarization functional, reference:
        waveportoperator.cpp:121-146 Normalize + 533-577 port_S0t; the ND
        interpolant of the quadrant indicator is replaced by its pointwise
        quadrature evaluation)."""
        s_field = self.nxh_field(sol, omega)
        Et3, _, _ = self.mode_fields_at_trace(sol)
        tr = self.trace
        dot = -np.einsum("fq,fqs,fqs->", tr.wdetJ, np.conj(s_field), Et3)
        power = abs(dot)
        if power <= 0:
            raise RuntimeError("wave port mode has zero power")
        dot0 = np.einsum("fq,fqs->", tr.wdetJ * self._quadrant_mask(),
                         s_field)
        if abs(dot0) < 1e-12 * np.abs(s_field).max() * tr.wdetJ.sum():
            # Degenerate polarization functional: the largest-dof phase
            # (still deterministic).
            k = int(np.argmax(np.abs(sol.et)))
            dot0 = np.exp(1j * np.angle(sol.et[k]))
            sol.phase = "largest-dof"
        scale = abs(dot0) / (dot0 * math.sqrt(power))
        sol.et *= scale
        sol.en *= scale
        # VoltagePath polarity: flip the mode so that the modal voltage
        # V_exc = int E_mode . dl along the path is real-positive
        # (reference: waveportoperator.cpp:721-748).
        if getattr(self.cfg, "voltage_path", None):
            V = self.excitation_voltage(sol)
            if V.real < 0:
                sol.et *= -1.0
                sol.en *= -1.0
                V = -V
            sol.V_exc = complex(V)

    # -- VoltagePath line integrals (reference: waveportoperator.cpp:943-1016
    # GetVoltage/GetExcitationVoltage, with GSLIB interpolation replaced by
    # the KD-tree + Newton point locator) ------------------------------------

    def _voltage_rule(self):
        """Gauss-Legendre samples (pts3 (n,3), w dl (n,3)) along the
        VoltagePath polyline, in the nondimensional mesh frame."""
        if hasattr(self, "_vrule"):
            return self._vrule
        path = getattr(self.cfg, "voltage_path", None)
        if not path or len(path) < 2:
            self._vrule = None
            return None
        from palace_torch.drivers.common import nondim_point

        n = max(1, int(getattr(self.cfg, "n_samples", 100)))
        xg, wg = np.polynomial.legendre.leggauss(n // 2 + 1)
        t, w = 0.5 * (xg + 1.0), 0.5 * wg
        P = [np.asarray(nondim_point(self._iodata, p), float) for p in path]
        pts, wdl = [], []
        for a, b in zip(P[:-1], P[1:]):
            dl = b - a
            pts.append(a[None, :] + t[:, None] * dl[None, :])
            wdl.append(w[:, None] * dl[None, :])
        self._vrule = (np.concatenate(pts), np.concatenate(wdl))
        return self._vrule

    def excitation_voltage(self, sol: ModeSolution) -> complex:
        """Modal voltage int E_mode . dl over the path (2D submesh; the path
        lies in the port plane, so only the tangential field counts)."""
        rule = self._voltage_rule()
        if rule is None:
            return 0.0 + 0.0j
        from palace_torch.fem.evaluation import PointLocator, eval_nd

        pts3, wdl3 = rule
        T = np.stack([self.t1, self.t2], axis=1)  # (3, 2)
        if not hasattr(self, "_vlocs2"):
            self._vlocs2 = PointLocator(self.mesh2).locate(
                (pts3 - self.origin) @ T)
        Ev = eval_nd(self.nd, sol.et, self._vlocs2)  # (n, 2) complex
        return complex(np.einsum("ns,ns->", Ev, wdl3 @ T))

    def solution_voltage(self, space, E: np.ndarray) -> complex:
        """Total-field wave port voltage V_wp = int E . dl along the path,
        evaluated on the 3D solution (reference: GetVoltage)."""
        rule = self._voltage_rule()
        if rule is None:
            return 0.0 + 0.0j
        from palace_torch.fem.evaluation import PointLocator, eval_nd

        pts3, wdl3 = rule
        if not hasattr(self, "_vlocs3"):
            loc = getattr(space.mesh, "_plocator", None)
            if loc is None:
                loc = PointLocator(space.mesh)
                space.mesh._plocator = loc
            self._vlocs3 = loc.locate(pts3)
        Ev = eval_nd(space, E, self._vlocs3)  # (n, 3) complex
        return complex(np.einsum("ns,ns->", Ev, wdl3))

    def _mark_dbc_edges(self, mesh, bedges, dbc_attrs):
        """Which submesh edges lie on 3D Dirichlet (PEC) surfaces."""
        dbc = _facet_edge_set(mesh, dbc_attrs) if dbc_attrs else set()
        g = self.l2g
        out = np.zeros(len(bedges), bool)
        for k, (a, b) in enumerate(bedges):
            out[k] = (min(g[a], g[b]), max(g[a], g[b])) in dbc
        return out


def _pad3(t2: np.ndarray) -> np.ndarray:
    out = np.zeros((3, 3))
    out[:2, :2] = t2
    return out


def _trunc2(t: np.ndarray) -> np.ndarray:
    return t[:2, :2]


def _facet_edge_set(mesh: Mesh, attrs) -> set:
    """All (sorted) vertex-pair edges of boundary facets with given attrs."""
    out = set()
    for bb in mesh.bdr_buckets:
        sel = np.isin(bb.attr, list(attrs))
        if not sel.any():
            continue
        c = bb.corners[sel]
        for (i, j) in ref.GEOM_EDGES[bb.geom]:
            e = np.sort(c[:, [i, j]].astype(np.int64), axis=1)
            out.update(map(tuple, e))
    return out
