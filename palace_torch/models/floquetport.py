"""Floquet (diffraction-order) ports for quasi-periodic driven problems.

The DtN boundary condition on a periodic unit cell's open faces, expanded
in diffraction orders (reference: palace/models/floquetportoperator.cpp):

  - a full-rank Robin term i gamma_00(omega) mu^-1 boundary mass is part of
    the system damping (AddExtraSystemBdrCoefficients, :980-996);
  - a low-rank correction F(omega) = sum_k g_k v_k v_k^H (NOT
    g conj(v) v^T; the r2 fix, commit 7c5b853, matched the reference's
    LowRankComplexOperator::AddMult semantics) over the BZ-centered order
    range gives each diffraction order its correct DtN eigenvalue
    (LowRankComplexOperator, ComputeDtNCorrectionCoeff :702-741);
  - the incident plane wave enters as RHS2 = c_inc 2i alpha_p lambda_p /
    mu_r conj(v_p) for the (0,0) TE/TM modes (AddExcitationVector :876-915);
  - per-order S-parameters are power-normalized Fourier amplitudes
    (GetAllSParameters :787-874).

Copied from palace_tpu/models/floquetport.py, imports pointed at
palace_torch.

v_k are the tangential Fourier projection vectors
int_Gamma N_j . e_pol exp(-i B_mn . r) dS assembled once per port from
Cartesian component vectors (AssembleFourierProjections :459-545).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


def _cross(a, b):
    return np.cross(np.asarray(a, float), np.asarray(b, float))


def reciprocal_lattice(a1: np.ndarray, a2: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """b_i with a_i . b_j = 2 pi delta_ij, in the lattice plane
    (reference: floquetportoperator.cpp:327-370)."""
    n = _cross(a1, a2)
    vol2 = float(n @ n)
    if vol2 <= 0:
        raise ValueError("degenerate Floquet lattice vectors")
    b1 = 2.0 * math.pi * _cross(a2, n) / vol2
    b2 = 2.0 * math.pi * _cross(n, a1) / vol2
    assert abs(a1 @ b1 - 2 * math.pi) < 1e-9 and abs(a2 @ b2 - 2 * math.pi) < 1e-9
    return b1, b2


def _polarization(kt: np.ndarray, normal: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(e_te, e_tm) unit vectors (floquetportoperator.cpp:560-624)."""
    ktn = np.linalg.norm(kt)
    if ktn > 1e-12:
        e_te = _cross(kt / ktn, normal)
        nrm = np.linalg.norm(e_te)
        if nrm > 1e-12:
            e_te = e_te / nrm
        e_tm = _cross(normal, e_te)
        nrm = np.linalg.norm(e_tm)
        if nrm > 1e-12:
            e_tm = e_tm / nrm
        return e_te, e_tm
    abs_n = np.abs(normal)
    ref = np.zeros(3)
    ref[int(np.argmin(abs_n))] = 1.0
    e_te = _cross(ref, abs_n)
    e_te = e_te / np.linalg.norm(e_te)
    e_tm = _cross(abs_n, e_te)
    e_tm = e_tm / np.linalg.norm(e_tm)
    return e_te, e_tm


@dataclass
class FloquetOrder:
    m: int
    n: int
    out: bool  # user-requested (S-parameter output)
    dtn: bool  # BZ-centered (DtN correction)
    B: np.ndarray  # projection wavevector (BZ-shifted)
    e_te: np.ndarray = None
    e_tm: np.ndarray = None
    v_te: np.ndarray = None  # complex projection vectors
    v_tm: np.ndarray = None
    v_comp: np.ndarray = None  # (3, num_dofs) Cartesian projections
    gamma_sq: float = 0.0


class FloquetPortData:
    """One Floquet port boundary (reference: FloquetPortData)."""

    def __init__(self, iodata, mesh, space, cfg: dict, materials,
                 k_wrapped: np.ndarray, omega_ref: float, bdr_qorder: int):
        from palace_torch.config import ValueType
        from palace_torch.fem.evaluation import boundary_trace
        from palace_torch.fem.nd_boundary import nd_trace_basis

        self.index = int(cfg.get("Index"))
        self.attributes = [int(a) for a in cfg.get("Attributes")]
        ex = cfg.get("Excitation", 0)
        self.excitation = int(ex) if not isinstance(ex, bool) else (
            self.index if ex else 0)
        pol = str(cfg.get("IncidentPolarization", "TE")).upper()
        s2 = 1.0 / math.sqrt(2.0)
        self.alpha_te, self.alpha_tm = {
            "TE": (1.0 + 0.0j, 0.0j), "TM": (0.0j, 1.0 + 0.0j),
            "RHC": (s2 + 0.0j, 1j * s2), "LHC": (s2 + 0.0j, -1j * s2),
        }[pol]
        max_order = int(cfg.get("MaxOrder", -1))

        units = iodata.units
        mls = units.mesh_length_scale
        # Lattice vectors from the (two) periodic boundary pairs'
        # translations (auto-detected centroid offsets are fine).
        pairs = iodata.boundaries.periodic
        if len(pairs) != 2:
            raise ValueError(
                "FloquetPort requires exactly two periodic boundary pairs")
        from palace_torch.mesh.periodic import _surface_nodes

        def lattice_vec(p):
            if p.translation is not None:
                return np.asarray(p.translation, float)[:3] / mls
            d = _surface_nodes(mesh, p.donor_attributes)
            r = _surface_nodes(mesh, p.receiver_attributes)
            return (mesh.nodes[r].mean(axis=0) - mesh.nodes[d].mean(axis=0))

        a1, a2 = lattice_vec(pairs[0]), lattice_vec(pairs[1])
        self.b1, self.b2 = reciprocal_lattice(a1, a2)

        # Wrapped k (consistent with the volume Bloch terms; k0 = k_F/w_ref
        # when FloquetReferenceFrequency scaling is active) and the BZ
        # offset relative to the unwrapped config vector.
        self.k = np.asarray(k_wrapped, float)
        self.omega_ref = float(omega_ref)
        k_cfg = np.zeros(3)
        kv = iodata.boundaries.floquet_wave_vector
        if kv is not None:
            k_cfg[: len(kv)] = np.asarray(kv, float) * mls
        k_at_ref = self.k * (self.omega_ref if self.omega_ref > 0 else 1.0)
        dk = k_cfg - k_at_ref
        self.bz_m = int(round(float(dk @ self.b1) / float(self.b1 @ self.b1)))
        self.bz_n = int(round(float(dk @ self.b2) / float(self.b2 @ self.b2)))

        # Port geometry + adjacent material.
        tr = boundary_trace(mesh, self.attributes, bdr_qorder)
        self._tb = nd_trace_basis(space, tr)
        self.area = float(tr.wdetJ.sum())
        nrm = (tr.normal * tr.wdetJ[..., None]).sum(axis=(0, 1))
        self.normal = nrm / np.linalg.norm(nrm)
        attrs = np.empty(len(tr.elem), np.int32)
        for bi, b in enumerate(mesh.buckets):
            s = tr.bucket == bi
            attrs[s] = b.attr[tr.elem[s]]
        a0 = int(attrs[0])
        eps = materials.permittivity[a0]
        mi = materials.inv_permeability[a0]
        n_h = self.normal
        self.mu_r = 1.0 / float(n_h @ mi @ n_h) if mi.ndim == 2 else 1.0 / float(mi)
        eps_s = float(n_h @ np.real(eps) @ n_h) if np.ndim(eps) == 2 else float(eps)
        self.mu_eps = self.mu_r * eps_s

        # Physical quadrature points on the trace.
        from palace_torch.fem import reference as refmod

        pts = np.zeros(tr.wdetJ.shape + (3,))
        for bi, b in enumerate(mesh.buckets):
            s = np.where(tr.bucket == bi)[0]
            if len(s) == 0:
                continue
            gb = refmod.gmsh_geometry_basis(b.etype)
            xis = tr.xi[s].reshape(-1, tr.xi.shape[-1])
            N = gb.eval(xis).reshape(len(s), tr.wdetJ.shape[1], -1)
            pts[s] = np.einsum("ens,eqn->eqs", mesh.nodes[b.conn[tr.elem[s]]],
                               N)
        self._pts = pts

        # Diffraction-order cap at the mesh Nyquist limit
        # (floquetportoperator.cpp:283-315).
        if max_order >= 0:
            mo_m = mo_n = max_order
        else:
            mo_m = mo_n = 3
        h_max = float(np.sqrt(tr.wdetJ.sum(axis=1)).max()) * 1.4
        p_ord = space.order
        nyq_m = max(1, int(p_ord * math.pi / (np.linalg.norm(self.b1) * h_max)))
        nyq_n = max(1, int(p_ord * math.pi / (np.linalg.norm(self.b2) * h_max)))
        mo_m = min(mo_m, max(1, nyq_m))
        mo_n = min(mo_n, max(1, nyq_n))
        self.max_m, self.max_n = mo_m, mo_n

        self.orders: List[FloquetOrder] = []
        m_lo = min(-mo_m, -mo_m + self.bz_m)
        m_hi = max(mo_m, mo_m + self.bz_m)
        n_lo = min(-mo_n, -mo_n + self.bz_n)
        n_hi = max(mo_n, mo_n + self.bz_n)
        num_dofs = space.num_dofs
        for m in range(m_lo, m_hi + 1):
            for n in range(n_lo, n_hi + 1):
                B = (m - self.bz_m) * self.b1 + (n - self.bz_n) * self.b2
                kt = B + self.k
                e_te, e_tm = _polarization(kt, self.normal)
                out = abs(m) <= mo_m and abs(n) <= mo_n
                dtn = (abs(m - self.bz_m) <= mo_m
                       and abs(n - self.bz_n) <= mo_n)
                o = FloquetOrder(m, n, out, dtn, B, e_te, e_tm)
                # Cartesian Fourier projections v_comp[d] =
                # int N_j . e_d exp(-i B.r) dS; polarization combinations
                # are frequency-dependent under k scaling.
                from palace_torch.fem.nd_boundary import boundary_rhs

                phase = np.exp(-1j * np.einsum("eqs,s->eq", pts, B))
                vc = []
                for d in range(3):
                    e_d = np.zeros(3)
                    e_d[d] = 1.0
                    vc.append(boundary_rhs(
                        self._tb, phase[..., None] * e_d[None, None, :],
                        num_dofs))
                o.v_comp = np.stack(vc)
                o.v_te = o.e_te @ o.v_comp
                o.v_tm = o.e_tm @ o.v_comp
                self.orders.append(o)
        self._omega0 = None
        self.gamma0 = 0.0

    # -- frequency state ----------------------------------------------------

    def initialize(self, omega: float):
        if self._omega0 == omega:
            return
        self._omega0 = omega
        scale = omega if self.omega_ref > 0 else 1.0
        for o in self.orders:
            kt = o.B + scale * self.k
            o.gamma_sq = omega * omega * self.mu_eps - float(kt @ kt)
            if self.omega_ref > 0:
                o.e_te, o.e_tm = _polarization(kt, self.normal)
                o.v_te = o.e_te @ o.v_comp
                o.v_tm = o.e_tm @ o.v_comp
            if o.m == 0 and o.n == 0:
                self.gamma0 = math.sqrt(max(o.gamma_sq, 0.0))

    def _g_full(self, o: FloquetOrder, te: bool, omega: float) -> complex:
        if o.gamma_sq > 0:
            g = math.sqrt(o.gamma_sq)
            return (1j * g / (self.mu_r * self.area) if te
                    else 1j * omega * omega * self.mu_eps
                    / (g * self.mu_r * self.area))
        if o.gamma_sq < 0:
            ga = math.sqrt(-o.gamma_sq)
            return (ga / (self.mu_r * self.area) if te
                    else -omega * omega * self.mu_eps
                    / (ga * self.mu_r * self.area))
        return 0.0

    def lowrank_terms(self, omega: float):
        """[(g_correction, v)] for F(omega) = sum g v v^H (Woodbury form
        U diag(g) U^H with U columns v)."""
        self.initialize(omega)
        g_uni = 1j * self.gamma0 / (self.mu_r * self.area)
        out = []
        for o in self.orders:
            if not o.dtn:
                continue
            for te, v in ((True, o.v_te), (False, o.v_tm)):
                g_full = self._g_full(o, te, omega)
                if g_full == 0.0:
                    continue
                g = g_full - g_uni
                if abs(g) < 1e-14 * abs(g_full):
                    continue
                out.append((g, v))
        return out

    def _incident_norm(self, omega: float):
        self.initialize(omega)
        if not self.gamma0 > 0:
            raise ValueError("incident Floquet mode is evanescent")
        l_te = self.gamma0
        l_tm = omega * omega * self.mu_eps / self.gamma0
        l_eff = (abs(self.alpha_te) ** 2 * l_te
                 + abs(self.alpha_tm) ** 2 * l_tm)
        c_inc = 1.0 / math.sqrt(l_eff * self.area / (2.0 * omega * self.mu_r))
        return l_te, l_tm, l_eff, c_inc

    def excitation_rhs(self, omega: float, num_dofs: int) -> np.ndarray:
        """Incident-wave RHS2 (floquetportoperator.cpp:876-915)."""
        o00 = next(o for o in self.orders if o.m == 0 and o.n == 0)
        l_te, l_tm, _, c_inc = self._incident_norm(omega)
        rhs = np.zeros(num_dofs, complex)
        for alpha, lam, v in ((self.alpha_te, l_te, o00.v_te),
                              (self.alpha_tm, l_tm, o00.v_tm)):
            if abs(alpha) < 1e-14:
                continue
            s = c_inc * 2.0j * alpha * lam / self.mu_r
            rhs += s * np.conj(v)
        return rhs

    def s_parameters(self, E: np.ndarray, omega: float,
                     subtract_incident: bool
                     ) -> Dict[Tuple[int, int, bool], complex]:
        """Power-normalized per-order S (floquetportoperator.cpp:787-874)."""
        self.initialize(omega)
        l_te00, l_tm00, l_eff, c_inc = self._incident_norm(omega)
        out: Dict[Tuple[int, int, bool], complex] = {}
        for o in self.orders:
            if not o.out or o.gamma_sq <= 0:
                continue
            g = math.sqrt(o.gamma_sq)
            for te, v in ((True, o.v_te), (False, o.v_tm)):
                c = complex(np.vdot(v, E))  # v^H E
                lam = g if te else omega * omega * self.mu_eps / g
                S = math.sqrt(lam / l_eff) * c / (c_inc * self.area)
                if subtract_incident and o.m == 0 and o.n == 0:
                    alpha = self.alpha_te if te else self.alpha_tm
                    if abs(alpha) > 1e-14:
                        lam_p = l_te00 if te else l_tm00
                        S -= math.sqrt(lam_p / l_eff) * alpha
                out[(o.m, o.n, te)] = S
        return out
