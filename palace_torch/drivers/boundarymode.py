"""BoundaryMode driver: 2D waveguide cross-section mode analysis on a native
2D mesh, or on the boundary submesh of a 3D mesh (counterpart of
palace_tpu/drivers/boundarymode.py; reference:
palace/drivers/boundarymodesolver.cpp, palace/models/boundarymodeoperator.cpp).

Solves the Vardapetyan-Demkowicz pencil of the wave-port path
(models/waveport.py) with propagation normal to the mesh plane, then
postprocesses per-mode kn / n_eff, voltage-path integrals, the
power-voltage impedance Z_PV = |V|^2 / (2 P) with L = Z n_eff / c0 and
C = n_eff / (c0 Z) (mode-kn.csv, mode-V.csv, mode-Z.csv), domain energies,
interface participations and flux-recovery error indicators.

The forms and the pencil solve (one `splu` and ARPACK `eigs`, started from
a random vector as in palace_tpu) stay on the host in scipy, as palace_tpu
keeps them; the indicators' mass solves run on the device Jacobi-CG.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import scipy.sparse as sp
import torch

from palace_torch.config import IoData, ValueType
from palace_torch.drivers.common import (
    make_output_dir, nondim_point, prepare_mesh, print_log,
    write_error_indicators,
)
from palace_torch.fem.evaluation import boundary_trace
from palace_torch.fem.h1 import H1Space
from palace_torch.fem.nd import NDSpace
from palace_torch.fem.nd_boundary import boundary_mass_bucket, nd_trace_basis
from palace_torch.fem.nd_operators import nd_operator
from palace_torch.fem.operators import default_qorder, h1_operator
from palace_torch.fem.reference import Geom
from palace_torch.mesh import geometry
from palace_torch.mesh.mesh import canonicalize_simplices
from palace_torch.models.materials import MaterialOperator
from palace_torch.post.tables import Column, Table, index_column
from palace_torch.utils import constants as em
from palace_torch.utils import provenance, timers


class BoundaryModeProblem:
    """VD mode GEP on a native 2D mesh, propagation along +z."""

    def __init__(self, iodata: IoData, mesh, materials: MaterialOperator):
        canonicalize_simplices(mesh)
        self.mesh = mesh
        self.materials = materials
        order = iodata.solver.order
        self.nd = NDSpace(mesh, order)
        self.h1 = H1Space(mesh, order)
        pec = list(iodata.boundaries.pec)
        self.ess_nd = self.nd.boundary_dofs(pec) if pec else np.zeros(0, int)
        self.ess_h1 = self.h1.boundary_dofs(pec) if pec else np.zeros(0, int)

        lossy = materials.has_loss()
        epsc = materials.complex_permittivity() if lossy else {
            a: t.astype(complex) for a, t in materials.permittivity.items()}
        eps_t = {a: np.real(t) for a, t in epsc.items()}
        eps_ti = {a: np.imag(t) for a, t in epsc.items()}
        muinv = materials.inv_permeability
        self._Btt = nd_operator(self.nd, mass_coef=muinv).assemble_csr()
        self._Ktt = nd_operator(self.nd, curl_coef=muinv).assemble_csr()
        self._Mtt = nd_operator(self.nd, mass_coef=eps_t).assemble_csr()
        self._Mtt_i = (nd_operator(self.nd, mass_coef=eps_ti).assemble_csr()
                       if lossy else None)
        self._Knn = h1_operator(self.h1, diffusion_coef=muinv).assemble_csr()
        self._Mnn = h1_operator(self.h1, mass_coef={
            a: np.eye(3) * float(np.real(epsc[a][2, 2]))
            for a in epsc}).assemble_csr()
        self._Mnn_i = (h1_operator(self.h1, mass_coef={
            a: np.eye(3) * float(np.imag(epsc[a][2, 2]))
            for a in epsc}).assemble_csr() if lossy else None)
        self._epsc = epsc
        # Mixed Atn = (muinv grad u_h1, v_nd).
        self._Atn = self._mixed_grad(muinv)

        # Surface impedance sheets (1/Ls + i w/Rs - w^2 Cs) line masses on
        # both the in-plane tangential (ND) and out-of-plane (H1) fields
        # (reference: surfaceimpedanceoperator.cpp coefficients entering the
        # mode pencil's omega-dependent block).
        units = iodata.units
        self._imp_terms = []
        for imp in iodata.boundaries.impedances:
            Rs = imp.Rs / units.scale_factor(ValueType.IMPEDANCE)
            Ls = imp.Ls / units.scale_factor(ValueType.INDUCTANCE)
            Cs = imp.Cs / units.scale_factor(ValueType.CAPACITANCE)
            q = default_qorder(order, 1, mesh.bdr_buckets[0].geom)
            tr = boundary_trace(mesh, imp.attributes, q)
            tb = nd_trace_basis(self.nd, tr)
            bk = boundary_mass_bucket(tb, np.ones(len(tr.elem)))
            Mt = self._bucket_csr(np.asarray(bk.gidx), np.asarray(bk.A),
                                  self.nd.num_dofs)
            # H1 line mass from parent-element basis at the trace points.
            Mn = self._h1_line_mass(tr)
            self._imp_terms.append((Rs, Ls, Cs, Mt, Mn))

        # First-order absorbing (farfield) rim edges: i w invZ line masses
        # with invZ = sqrt(mu^-1 eps)(0,0) of the adjacent element's
        # material, added to both blocks of the mode pencil (reference:
        # modeeigensolver.cpp AssembleAtt and AssembleAnn).
        self._ff_terms = []
        ab = iodata.boundaries.absorbing
        if ab is not None and ab.attributes:
            q = default_qorder(order, 1, mesh.bdr_buckets[0].geom)
            tr = boundary_trace(mesh, ab.attributes, q)
            if len(tr.elem):
                invz_by_attr = {}
                for a, eps in epsc.items():
                    t = muinv[a] @ np.real(eps)
                    w, V = np.linalg.eig(t)
                    s = (V * np.sqrt(np.maximum(w.real, 0.0))) @ \
                        np.linalg.inv(V)
                    invz_by_attr[a] = float(np.real(s[0, 0]))
                coef = np.empty(len(tr.elem))
                for bi, b in enumerate(mesh.buckets):
                    s = tr.bucket == bi
                    coef[s] = [invz_by_attr[int(a)]
                               for a in b.attr[tr.elem[s]]]
                tb = nd_trace_basis(self.nd, tr)
                bk = boundary_mass_bucket(tb, coef)
                Mt = self._bucket_csr(np.asarray(bk.gidx),
                                      np.asarray(bk.A), self.nd.num_dofs)
                Mn = self._h1_line_mass(tr, weight=coef)
                self._ff_terms.append((Mt, Mn))
        mu_eps_max = 0.0
        for a in epsc:
            mu3 = np.linalg.inv(muinv[a])
            w = np.linalg.eigvalsh(0.5 * (mu3 @ np.real(epsc[a])
                                          + (mu3 @ np.real(epsc[a])).T))
            mu_eps_max = max(mu_eps_max, float(w.max()))
        self.mu_eps_max = mu_eps_max * 1.1

    @staticmethod
    def _bucket_csr(gidx, A, n) -> sp.csr_matrix:
        E, nd = gidx.shape
        rows = np.repeat(gidx, nd, axis=1).ravel()
        cols = np.tile(gidx, (1, nd)).ravel()
        return sp.coo_matrix((A.reshape(E, -1).ravel(), (rows, cols)),
                             shape=(n, n)).tocsr()

    def _h1_line_mass(self, tr, weight=None) -> sp.csr_matrix:
        mesh = self.mesh
        rows, cols, vals = [], [], []
        for bi, b in enumerate(mesh.buckets):
            sel = np.where(tr.bucket == bi)[0]
            if len(sel) == 0:
                continue
            nq = tr.wdetJ.shape[1]
            xis = tr.xi[sel].reshape(-1, tr.xi.shape[-1])
            B = self.h1.basis(b.geom).eval(xis).reshape(len(sel), nq, -1)
            wd = tr.wdetJ[sel]
            if weight is not None:
                wd = wd * np.asarray(weight)[sel][:, None]
            A = np.einsum("eq,eqn,eqm->enm", wd, B, B)
            g = self.h1.elem_dofs[bi][tr.elem[sel]]
            E, nd = g.shape
            rows.append(np.repeat(g, nd, axis=1).ravel())
            cols.append(np.tile(g, (1, nd)).ravel())
            vals.append(A.reshape(E, -1).ravel())
        return sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=(self.h1.num_dofs,) * 2).tocsr()

    def _mixed_grad(self, coef) -> sp.csr_matrix:
        mesh = self.mesh
        b = mesh.buckets[0]
        q = default_qorder(self.nd.order, b.geo_order, b.geom)
        gf = geometry.compute(mesh.nodes, b, q)
        V, _ = self.nd.basis_tables(b.geom, gf.qpts)
        Gh = self.h1.basis(b.geom).eval_grad(gf.qpts)
        Ce = self.materials.attr_tensor(coef, b.attr)[:, :2, :2]
        Ji = np.ascontiguousarray(np.moveaxis(gf.Jinvp, (2, 3), (0, 1)))
        gph = np.einsum("eqrs,qnr->eqns", Ji, Gh)
        vph = np.einsum("eqrs,qnr->eqns", Ji, V)
        cg = np.einsum("est,eqnt->eqns", Ce, gph)
        A = np.einsum("eq,eqms,eqns->emn", gf.wdetJ, vph, cg, optimize=True)
        nd_d = self.nd.elem_dofs[0]
        h1_d = self.h1.elem_dofs[0]
        E, ndn = nd_d.shape
        ndh = h1_d.shape[1]
        rows = np.repeat(nd_d, ndh, axis=1).ravel()
        cols = np.tile(h1_d, (1, ndn)).ravel()
        return sp.coo_matrix((A.reshape(E, -1).ravel(), (rows, cols)),
                             shape=(self.nd.num_dofs, self.h1.num_dofs)
                             ).tocsr()

    def solve(self, omega: float, kn_target: float, nev: int):
        """Returns list of (kn, et, en) sorted by |kn - target|."""
        from scipy.sparse.linalg import LinearOperator, eigs, splu

        sigma = -(kn_target ** 2) if kn_target > 0 else \
            -omega * omega * self.mu_eps_max
        Att = (self._Ktt - omega * omega * self._Mtt).astype(complex)
        if self._Mtt_i is not None:
            Att = Att - 1j * omega * omega * self._Mtt_i
        Ann = (-self._Knn + omega * omega * self._Mnn).astype(complex)
        if self._Mnn_i is not None:
            Ann = Ann + 1j * omega * omega * self._Mnn_i
        for (Rs, Ls, Cs, Mt, Mn) in self._imp_terms:
            coef = 0.0 + 0.0j
            if abs(Ls) > 0:
                coef += 1.0 / Ls
            if abs(Rs) > 0:
                coef += 1j * omega / Rs
            if abs(Cs) > 0:
                coef -= omega * omega * Cs
            Att = (Att + coef * Mt).tocsr()
            Ann = (Ann - coef * Mn).tocsr()
        for (Mt, Mn) in self._ff_terms:
            # 1st-order ABC rim: +i w invZ on the tangential block, -i w
            # invZ on the normal block (reference sign pattern above).
            Att = (Att + 1j * omega * Mt).tocsr()
            Ann = (Ann - 1j * omega * Mn).tocsr()
        Atn = (-self._Atn).tocsr().astype(complex)
        Btn = self._Atn.T.tocsr().astype(complex)
        nnd, nh1 = self.nd.num_dofs, self.h1.num_dofs

        def elim(M, er, ec, diag):
            M = M.tolil()
            M[er, :] = 0.0
            M[:, ec] = 0.0
            if diag:
                M[er, er] = 1.0
            return M.tocsr()

        Att = elim(Att, self.ess_nd, self.ess_nd, True)
        Ann = elim(Ann, self.ess_h1, self.ess_h1, True)
        Atn = elim(Atn, self.ess_nd, self.ess_h1, False)
        Btn = elim(Btn, self.ess_h1, self.ess_nd, False)
        Btt = elim(self._Btt.astype(complex), self.ess_nd, self.ess_nd, False)
        A = sp.bmat([[Att, Atn], [sp.csr_matrix((nh1, nnd)), Ann]],
                    format="csc")
        B = sp.bmat([[Btt, None], [Btn, sp.csr_matrix((nh1, nh1))]],
                    format="csc")
        lu = splu((A - sigma * B).tocsc())
        n_tot = nnd + nh1
        T = LinearOperator((n_tot, n_tot), matvec=lambda x: lu.solve(B @ x),
                           dtype=complex)
        mu, vecs = eigs(T, k=nev + 4, which="LM", tol=1e-10)
        lam = sigma + 1.0 / mu
        kn = np.sqrt(-lam + 0j)
        kn = np.where(np.real(kn) < 0, -kn, kn)
        if kn_target > 0:
            order = np.argsort(np.abs(kn - kn_target))
        else:
            order = np.argsort(-np.real(kn))
        out = []
        for i in order[:nev]:
            et = vecs[:nnd, i]
            en = vecs[nnd:, i] / (1j * kn[i])
            out.append([complex(kn[i]), et, en])
        return out

    # -- mode postprocessing -------------------------------------------------

    def domain_fields(self, et, en, kn, omega):
        """(gf, Eq (E,nq,3), Hq (E,nq,3)) full 3-component fields at volume
        quadrature points (z components from en / the mode H formula)."""
        mesh = self.mesh
        b = mesh.buckets[0]
        q = default_qorder(self.nd.order, b.geo_order, b.geom)
        gf = geometry.compute(mesh.nodes, b, q)
        V, C = self.nd.basis_tables(b.geom, gf.qpts)
        Bh = self.h1.basis(b.geom).eval(gf.qpts)
        Gh = self.h1.basis(b.geom).eval_grad(gf.qpts)
        Ji = np.ascontiguousarray(np.moveaxis(gf.Jinvp, (2, 3), (0, 1)))
        ete = et[self.nd.elem_dofs[0]]
        ene = en[self.h1.elem_dofs[0]]
        Et = np.einsum("eqrs,qnr,en->eqs", Ji, V, ete)  # (E, nq, 2)
        En = np.einsum("qn,en->eq", Bh, ene)
        Gn = np.einsum("eqrs,qnr,en->eqs", Ji, Gh, ene)
        Eq = np.concatenate([Et, En[..., None]], axis=-1)
        muinv = self.materials.attr_tensor(self.materials.inv_permeability,
                                           b.attr)
        # W = mu^-1 (-kn Et + i grad En)/omega; true H_t = z x W (the
        # reference's n x H coefficient, waveportoperator.cpp:121-150).
        U = -kn.real * Et + 1j * Gn
        W = np.einsum("est,eqt->eqs", muinv[:, :2, :2], U) / omega
        Ht2 = np.stack([-W[..., 1], W[..., 0]], axis=-1)
        # H_z = z . curl E / (i omega mu) = curl2(Et) / (i omega mu).
        curl2 = np.einsum("qn,en->eq", C[..., 0], ete) / gf.detJ
        Hz = muinv[:, 2, 2][:, None] * curl2 / (1j * omega)
        Hq = np.concatenate([Ht2, Hz[..., None]], axis=-1)
        return gf, Eq, Hq

    def power(self, et, en, kn, omega) -> complex:
        """P = int (E x conj(H)) . z dA = int Et . conj(W) dA with the
        unrotated W = mu^-1(-kn Et + i grad En)/omega (the in-plane identity
        (A x (z x B)) . z = A . B)."""
        gf, Eq, Hq = self.domain_fields(et, en, kn, omega)
        # Undo the rotation: W = (Hy, -Hx).
        W = np.stack([Hq[..., 1], -Hq[..., 0]], axis=-1)
        Sz = np.einsum("eqs,eqs->eq", Eq[..., :2], np.conj(W))
        return complex(np.einsum("eq,eq->", gf.wdetJ, Sz))

    def voltage(self, et, en, path, nsamples) -> complex:
        """V = -int E . dl along the path (trapezoid over nsamples)."""
        from palace_torch.fem import evaluation

        p0, p1 = np.asarray(path[0], float), np.asarray(path[1], float)
        ts = np.linspace(0.0, 1.0, nsamples)
        pts = p0[None, :] + ts[:, None] * (p1 - p0)[None, :]
        locs = evaluation.PointLocator(self.mesh).locate(pts)
        Er = evaluation.eval_nd(self.nd, np.real(et).copy(), locs, "value")
        Ei = evaluation.eval_nd(self.nd, np.imag(et).copy(), locs, "value")
        Ec = Er + 1j * Ei
        dl = (p1 - p0)
        integrand = Ec @ dl
        return complex(-np.trapezoid(integrand, ts))


def _extract_boundary_submesh(mesh, attrs, pec_attrs=()):
    """2D cross-section submesh from the boundary facets of a 3D mesh with
    the given attributes (reference: boundarymodesolver.cpp runs on a
    boundary submesh when Solver/BoundaryMode/Attributes is set).  Domain
    attrs are inherited from the adjacent volume elements; rim edges become
    LINE boundary facets carrying the attr of the adjacent 3D boundary sheet
    (PEC rims stay essential)."""
    from palace_torch.mesh.mesh import ElemBucket, Mesh
    from palace_torch.post.surfaces import _domain_attrs

    tr = boundary_trace(mesh, attrs, 2)
    dom_attr = _domain_attrs(mesh, tr.bucket, tr.elem)

    conns, etypes, geo_orders = [], [], []
    k = 0
    fac_attr = []
    for bb in mesh.bdr_buckets:
        sel = np.isin(bb.attr, list(attrs))
        if not sel.any():
            continue
        if bb.geom is not Geom.TRI:
            raise NotImplementedError(
                "boundary-mode submesh extraction supports tri facets")
        conns.append(bb.conn[sel])
        etypes.append(bb.etype)
        geo_orders.append(bb.geo_order)
        fac_attr.append(dom_attr[k:k + int(sel.sum())])
        k += int(sel.sum())
    conn = np.concatenate(conns)
    attr_arr = np.concatenate(fac_attr).astype(np.int32)

    used = np.unique(conn)
    remap = np.full(mesh.num_nodes, -1, np.int64)
    remap[used] = np.arange(len(used))
    X = mesh.nodes[used]
    # Plane frame from the facet geometry.
    c0 = X.mean(axis=0)
    _, _, Vt = np.linalg.svd(X - c0, full_matrices=False)
    t1, t2 = Vt[0], Vt[1]
    frame = np.stack([t1, t2, np.cross(t1, t2)])  # rows: local x, y, z
    nodes2d = np.stack([(X - c0) @ t1, (X - c0) @ t2], axis=1)
    conn2 = remap[conn].astype(np.int32)

    # Rim edges (appear in exactly one facet) -> LINE boundary facets with
    # the attr of the adjacent non-port 3D boundary sheet.
    corners = conn2[:, :3].astype(np.int64)
    edges = np.concatenate([corners[:, [0, 1]], corners[:, [1, 2]],
                            corners[:, [0, 2]]])
    se = np.sort(edges, axis=1)
    uniq, counts = np.unique(se, axis=0, return_counts=True)
    rim = uniq[counts == 1]
    interior = uniq[counts == 2]
    edge_attr = {}
    for bb in mesh.bdr_buckets:
        nc = bb.num_corners
        cc = bb.corners.astype(np.int64)
        pairs = [(i, j) for i in range(nc) for j in range(i + 1, nc)]
        for (i, j) in pairs:
            a = remap[cc[:, i]]
            b = remap[cc[:, j]]
            ok = (a >= 0) & (b >= 0)
            for aa, bbb, at in zip(a[ok], b[ok], bb.attr[ok]):
                if int(at) in attrs:
                    continue
                key = (min(int(aa), int(bbb)), max(int(aa), int(bbb)))
                # Prefer PEC sheets: an edge on both a PEC trace and
                # another surface (e.g. the cut between two port halves
                # through the center conductor) must stay essential.
                if key not in edge_attr or (int(at) in pec_attrs
                                            and edge_attr[key]
                                            not in pec_attrs):
                    edge_attr[key] = int(at)
    rim_attr = np.array([edge_attr.get((int(a), int(b)), 0)
                         for a, b in rim], np.int32)
    lines = [rim.astype(np.int32)]
    lattr = [rim_attr]
    # Interior edges lying on 3D boundary sheets (e.g. PEC traces crossing
    # the port plane) become boundary lines too, so their dofs can be
    # eliminated (the interior-PEC port edges of the wave-port solver).
    int_hits = [(e, edge_attr[(int(e[0]), int(e[1]))]) for e in interior
                if (int(e[0]), int(e[1])) in edge_attr]
    if int_hits:
        lines.append(np.array([e for e, _ in int_hits], np.int32))
        lattr.append(np.array([a for _, a in int_hits], np.int32))
    bdr = [ElemBucket(1, Geom.LINE, 1, np.concatenate(lines),
                      np.concatenate(lattr))]
    sub = Mesh(nodes2d, [ElemBucket(etypes[0], Geom.TRI, geo_orders[0],
                                    conn2, attr_arr)], bdr)
    return sub, frame


def _rotate_materials(mats, R):
    """MaterialOperator with every 3x3 tensor conjugated into the submesh
    frame T' = R T R^T (rows of R: in-plane t1, t2, out-of-plane normal),
    required for anisotropic materials: the global [:2, :2] block picks the
    wrong components on a port whose normal is not global z."""

    def rot(d):
        out = {}
        for a, t in d.items():
            t = np.asarray(t)
            out[a] = R @ t @ R.T if t.ndim == 2 else t
        return out

    return MaterialOperator(rot(mats.permittivity),
                            rot(mats.inv_permeability),
                            rot(mats.loss_tan), rot(mats.conductivity),
                            dict(mats.london_depth))


def solve(iodata: IoData, output_dir: str | None = None,
          device: torch.device = torch.device("cpu")):
    """The BoundaryMode run: the host pencil solve, then the tables, with
    the indicators' mass solves on `device`."""
    t0 = time.time()
    with timers.block("Mesh preprocessing"):
        mesh = prepare_mesh(iodata)
    post_dir = make_output_dir(iodata, output_dir)
    units = iodata.units
    cfg = iodata.solver.boundary_mode
    sub_frame = None
    if cfg.attributes and mesh.nodes.shape[1] == 3:
        surf = {int(a) for a in cfg.attributes}
        pec = set(int(a) for a in iodata.boundaries.pec)
        # Other wave ports on the same cross-section act as conducting
        # boundaries for this mode solve: relabel their rim edges to PEC
        # (reference: boundarymodesolver.cpp:126-166 other_waveport_attrs
        # relabel to min PEC attribute).
        other_wp = {int(a) for wp in iodata.boundaries.wave_ports
                    for a in wp.attributes} - surf
        with timers.block("Mesh preprocessing"):
            mesh, sub_frame = _extract_boundary_submesh(
                mesh, sorted(surf), pec_attrs=pec | other_wp)
        if other_wp and pec:
            pec_attr = min(pec)
            bb = mesh.bdr_buckets[0]
            sel = np.isin(bb.attr, sorted(other_wp))
            if sel.any():
                bb.attr[sel] = pec_attr
                print_log(iodata, f"relabelled {int(sel.sum())} "
                                  "other-waveport rim edge(s) as PEC")
        print_log(iodata, f"boundary-mode submesh: {mesh.num_elements} "
                          "facets")

    with timers.block("Operator construction"):
        materials = MaterialOperator.build(iodata)
        if sub_frame is not None:
            materials = _rotate_materials(materials, sub_frame)
        prob = BoundaryModeProblem(iodata, mesh, materials)
    print_log(iodata, f"boundarymode: {prob.nd.num_dofs}+{prob.h1.num_dofs} "
                      f"dofs, {mesh.num_elements} elements")

    fscale = units.scale_factor(ValueType.FREQUENCY)
    omega = 2 * math.pi * cfg.freq / fscale
    # Target is n_eff; kn_target = n_eff * omega (c = 1 nondim).
    kn_target = cfg.target * omega if cfg.target > 0 else 0.0
    with timers.block("Eigenvalue solve"):
        modes = prob.solve(omega, kn_target, max(cfg.n, 1))
    provenance.record("eigen_path", "host-arpack")

    with timers.block("Postprocessing"):
        # Normalize modes to unit time-average power (peak-field convention:
        # int E x conj(H) . n dS = 2) with deterministic phase.
        for m in modes:
            kn, et, en = m
            P = prob.power(et, en, kn, omega)
            scale = math.sqrt(2.0 / abs(P))
            k = int(np.argmax(np.abs(et)))
            phase = np.exp(-1j * np.angle(et[k]))
            m[1] = et * scale * phase
            m[2] = en * scale * phase
        _write_mode_tables(iodata, post_dir, prob, modes, omega)
        mode_energy = _write_domain_energy(iodata, post_dir, prob, mesh,
                                           materials, modes, omega)
        if iodata.boundaries.dielectrics:
            _write_surface_q(iodata, post_dir, prob, mesh, materials, modes,
                             mode_energy)

    # Flux-recovery indicators per propagating mode: grad flux of Et plus
    # the out-of-plane Bz = curl Et / (i omega) curl flux (reference:
    # boundarymodesolver.cpp:316-333 BoundaryModeFluxErrorEstimator).  RT
    # spaces on quadrilaterals are not there (in palace_tpu either): then
    # the table is zero, as in palace_tpu.
    from palace_torch.fem.estimators import (curl_flux_indicators,
                                             grad_flux_indicators)

    eta2_steps, energies = [], []
    with timers.block("Estimator solve"):
        try:
            for i, (kn, et, en) in enumerate(modes):
                if not (kn.real > abs(kn.imag)):
                    continue  # evanescent
                e2 = (grad_flux_indicators(prob.nd, materials, et,
                                           device=device)
                      + curl_flux_indicators(prob.nd, materials, et,
                                             device=device)
                      / (omega * omega))
                eta2_steps.append(e2)
                energies.append(mode_energy[i])
        except NotImplementedError:
            eta2_steps = []
    if eta2_steps:
        write_error_indicators(post_dir, eta2_steps, energies)
    else:
        write_error_indicators(post_dir, [np.zeros(mesh.num_elements)])
    from palace_torch.post import metadata

    metadata.save_problem(post_dir, "BoundaryMode", mesh.num_elements,
                          prob.nd.num_dofs + prob.h1.num_dofs)
    metadata.save_timing(post_dir)
    neffs = [complex(m[0] / omega) for m in modes]
    print_log(iodata, f"boundarymode done in {time.time() - t0:.1f}s; "
                      f"n_eff[0] = {neffs[0].real:.6f}")
    return dict(post_dir=post_dir, n_eff=neffs, modes=modes, problem=prob,
                provenance=provenance.snapshot())


def _write_mode_tables(iodata, post_dir, prob, modes, omega):
    """mode-kn.csv, and mode-V.csv / mode-Z.csv from the voltage paths."""
    units = iodata.units
    inv_m = 1.0 / units.scale_factor(ValueType.LENGTH)  # 1/m scale for kn
    t = Table()
    t.add(index_column("m"))
    t.add(Column("rekn", "Re{kn} (1/m)"))
    t.add(Column("imkn", "Im{kn} (1/m)"))
    t.add(Column("reneff", "Re{n_eff}"))
    t.add(Column("imneff", "Im{n_eff}"))
    t.add(Column("errb", "Error (Bkwd.)"))
    t.add(Column("erra", "Error (Abs.)"))
    for i, (kn, et, en) in enumerate(modes):
        t.col("i").data.append(float(i + 1))
        t.col("rekn").data.append(kn.real * inv_m)
        t.col("imkn").data.append(kn.imag * inv_m)
        neff = kn / omega
        t.col("reneff").data.append(neff.real)
        t.col("imneff").data.append(neff.imag)
        t.col("errb").data.append(0.0)
        t.col("erra").data.append(0.0)
    t.write(os.path.join(post_dir, "mode-kn.csv"))

    volts = units.scale_factor(ValueType.VOLTAGE)
    vpaths = iodata.boundaries.voltages
    zpaths = iodata.boundaries.impedance_posts
    if vpaths:
        tv = Table()
        tv.add(index_column("m"))
        for vp in vpaths:
            tv.add(Column(f"rev{vp.index}", f"Re{{V[{vp.index}]}} (V)"))
            tv.add(Column(f"imv{vp.index}", f"Im{{V[{vp.index}]}} (V)"))
        for i, (kn, et, en) in enumerate(modes):
            tv.col("i").data.append(float(i + 1))
            for vp in vpaths:
                path = [nondim_point(iodata, p) for p in vp.voltage_path]
                V = prob.voltage(et, en, path, vp.n_samples) * volts
                tv.col(f"rev{vp.index}").data.append(V.real)
                tv.col(f"imv{vp.index}").data.append(V.imag)
        tv.write(os.path.join(post_dir, "mode-V.csv"))
    if zpaths:
        tz = Table()
        tz.add(index_column("m"))
        for zp in zpaths:
            tz.add(Column(f"z{zp.index}", f"Z_PV[{zp.index}] (Ohm)"))
            tz.add(Column(f"l{zp.index}", f"L_PV[{zp.index}] (H/m)"))
            tz.add(Column(f"c{zp.index}", f"C_PV[{zp.index}] (F/m)"))
        for i, (kn, et, en) in enumerate(modes):
            tz.col("i").data.append(float(i + 1))
            for zp in zpaths:
                path = [nondim_point(iodata, p) for p in zp.voltage_path]
                V = prob.voltage(et, en, path, zp.n_samples) * volts
                Z = abs(V) ** 2 / 2.0  # unit-power normalization, 1 W
                neff = (kn / omega).real
                tz.col(f"z{zp.index}").data.append(Z)
                tz.col(f"l{zp.index}").data.append(Z * neff / em.C0)
                tz.col(f"c{zp.index}").data.append(neff / (em.C0 * Z))
        tz.write(os.path.join(post_dir, "mode-Z.csv"))


def _write_domain_energy(iodata, post_dir, prob, mesh, materials, modes,
                         omega):
    """domain-E.csv per mode; returns each mode's electric energy, the
    indicators' normalization (reference: postoperator.cpp:1038-1044
    MeasureAndPrintAll returns the electric field energy only)."""
    J = iodata.units.scale_factor(ValueType.ENERGY)
    td = Table()
    td.add(index_column("m"))
    td.add(Column("Ee", "E_elec (J)"))
    td.add(Column("Em", "E_mag (J)"))
    td.add(Column("Ec", "E_cap (J)"))
    td.add(Column("Ei", "E_ind (J)"))
    for ecfg in iodata.domains.energies:
        td.add(Column(f"Ee{ecfg.index}", f"E_elec[{ecfg.index}] (J)"))
        td.add(Column(f"pe{ecfg.index}", f"p_elec[{ecfg.index}]"))
        td.add(Column(f"Em{ecfg.index}", f"E_mag[{ecfg.index}] (J)"))
        td.add(Column(f"pm{ecfg.index}", f"p_mag[{ecfg.index}]"))
    b = mesh.buckets[0]
    eps = materials.attr_tensor(materials.permittivity, b.attr)
    mut = materials.attr_tensor({a: np.linalg.inv(t) for a, t in
                                 materials.inv_permeability.items()}, b.attr)
    mode_energy = []
    for i, (kn, et, en) in enumerate(modes):
        gf, Eq, Hq = prob.domain_fields(et, en, kn, omega)
        dens_e = 0.5 * np.real(np.einsum("est,eqs,eqt->eq", eps, np.conj(Eq),
                                         Eq))
        dens_m = 0.5 * np.real(np.einsum("est,eqs,eqt->eq", mut, np.conj(Hq),
                                         Hq))
        Ee_el = np.einsum("eq,eq->e", gf.wdetJ, dens_e)
        Em_el = np.einsum("eq,eq->e", gf.wdetJ, dens_m)
        Ee, Em = float(Ee_el.sum()), float(Em_el.sum())
        mode_energy.append(Ee)
        td.col("i").data.append(float(i + 1))
        td.col("Ee").data.append(Ee * J)
        td.col("Em").data.append(Em * J)
        td.col("Ec").data.append(0.0)
        td.col("Ei").data.append(0.0)
        for ecfg in iodata.domains.energies:
            msk = np.isin(b.attr, ecfg.attributes)
            eE = float((Ee_el * msk).sum())
            eM = float((Em_el * msk).sum())
            td.col(f"Ee{ecfg.index}").data.append(eE * J)
            td.col(f"pe{ecfg.index}").data.append(eE / Ee if Ee > 0 else 0.0)
            td.col(f"Em{ecfg.index}").data.append(eM * J)
            td.col(f"pm{ecfg.index}").data.append(eM / Em if Em > 0 else 0.0)
    td.write(os.path.join(post_dir, "domain-E.csv"))
    return mode_energy


def _write_surface_q(iodata, post_dir, prob, mesh, materials, modes,
                     mode_energy):
    """surface-Q.csv: thin-layer interface dielectric participation per
    mode (reference: postoperator.cpp MeasureInterfaceEFieldEnergy on the
    in-plane E grid function; denominator the electric energy)."""
    from types import SimpleNamespace

    from palace_torch.post.surfaces import interface_energy

    units = iodata.units
    shim = SimpleNamespace(space=prob.nd, mesh=mesh, materials=materials)
    tq = Table()
    tq.add(index_column("m"))
    for d in iodata.boundaries.dielectrics:
        tq.add(Column(f"p{d.index}", f"p_surf[{d.index}]"))
        tq.add(Column(f"q{d.index}", f"Q_surf[{d.index}]"))
    bq = default_qorder(prob.nd.order, 1, mesh.bdr_buckets[0].geom)
    traces = {d.index: boundary_trace(mesh, d.attributes, bq,
                                      both_sides=True)
              for d in iodata.boundaries.dielectrics}
    for i, (kn, et, en) in enumerate(modes):
        tq.col("i").data.append(float(i + 1))
        denom = mode_energy[i]
        for d in iodata.boundaries.dielectrics:
            dcfg = SimpleNamespace(
                type=d.type, thickness=d.thickness / units.mesh_length_scale,
                permittivity=d.permittivity)
            e_i = interface_energy(shim, dcfg, traces[d.index], et)
            p = e_i / denom if denom > 0 else 0.0
            Q = (np.inf if (p == 0.0 or d.loss_tan == 0.0)
                 else 1.0 / (d.loss_tan * p))
            tq.col(f"p{d.index}").data.append(p)
            tq.col(f"q{d.index}").data.append(Q)
    tq.write(os.path.join(post_dir, "surface-Q.csv"))
