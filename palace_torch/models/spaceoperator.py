"""Frequency-domain Maxwell system assembly on the ND space (counterpart of
palace_tpu/models/spaceoperator.py for the driven sweep).

Builds the K (curl-curl + inductive boundary), C (resistive/absorbing
boundary) and M (permittivity + capacitive boundary) operators, PEC essential
dofs, the lumped-port / wave-port / surface-current / current-dipole
excitation, and the driven system A(omega) = K + i omega C - omega^2 M +
A2(omega), both as host scipy CSRs (sparse-direct path) and as constant real
terms with complex coefficients (device solver).  A2(omega) holds the
frequency-dependent boundary terms: wave ports (i Re kn(omega) times a
mu^-1 boundary mass), finite-conductivity surfaces (i omega / Z_s(omega)
times a boundary mass) and the second-order absorbing surface-curl term
(i / (2 omega) times its curl bucket) and the Floquet ports' Robin term
(i gamma_00(omega) times a mu^-1 boundary mass; their low-rank
diffraction-order correction is `floquet_lowrank`, solved by Woodbury).
A FloquetWaveVector adds the Bloch volume terms Fm = ((kx)^T mu^-1 kx u,
v) and the antisymmetric Fc, as Fm + i Fc in K or, with
FloquetReferenceFrequency, as omega^2 Fm + i omega Fc.  Domain operators
are `PAOperator`s on the run's device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from palace_torch.config import IoData, ValueType
from palace_torch.fem.evaluation import boundary_trace
from palace_torch.fem.nd import NDSpace
from palace_torch.fem.nd_boundary import (
    NDTraceBasis, boundary_curl_bucket, boundary_mass_bucket, boundary_rhs,
    nd_trace_basis,
)
from palace_torch.fem.nd_operators import nd_operator
from palace_torch.fem.operators import default_qorder
from palace_torch.fem.reference import Geom
from palace_torch.mesh.mesh import Mesh, canonicalize_simplices
from palace_torch.models.lumpedport import build_lumped_ports
from palace_torch.models.materials import MaterialOperator
from palace_torch.ops.partial import (
    BucketTables, PAOperator, signed_tables, tables_csr,
)


def _matsqrt(A: np.ndarray) -> np.ndarray:
    """Principal square root of a symmetric positive(-semi)definite tensor."""
    w, V = np.linalg.eigh(0.5 * (A + A.T))
    return (V * np.sqrt(np.maximum(w, 0.0))) @ V.T


def _conductivity_coef(omega: float, sigma: float, mu: float, h: float
                       ) -> complex:
    """i omega / Z_s(omega) of a finite-conductivity surface: Z_s =
    (1 + i) / (sigma delta), delta = sqrt(2 / (mu sigma omega)), with the
    finite-thickness factors (sinh v +/- sin v) / (cosh v - cos v),
    v = h / delta (reference: surfaceconductivityoperator.cpp:148-175, after
    the Ansys HFSS finite-thickness surface impedance model)."""
    delta = math.sqrt(2.0 / (mu * sigma * omega))
    zre = zim = 1.0 / (sigma * delta)
    if h > 0.0:
        nu = h / delta
        den = math.cosh(nu) - math.cos(nu)
        zre *= (math.sinh(nu) + math.sin(nu)) / den
        zim *= (math.sinh(nu) - math.sin(nu)) / den
    return 1.0j * omega / complex(zre, zim)


class SpaceOperator:
    """System operators for the driven sweep, domain tables on `device`."""

    def __init__(self, iodata: IoData, mesh: Mesh,
                 device: torch.device = torch.device("cpu")):
        b = iodata.boundaries
        canonicalize_simplices(mesh)
        self.iodata = iodata
        self.mesh = mesh
        self.device = torch.device(device)
        self.materials = MaterialOperator.build(iodata)
        self.space = NDSpace(mesh, iodata.solver.order)
        p = iodata.solver.order
        self.bdr_qorder = default_qorder(
            p, mesh.bdr_buckets[0].geo_order if mesh.bdr_buckets else 1, Geom.TRI
        )
        self.ports = build_lumped_ports(iodata, mesh, self.bdr_qorder)

        # PEC essential dofs (reference: spaceoperator.hpp:56-57).
        pec = list(iodata.boundaries.pec)
        self.ess_mask = np.zeros(self.space.num_dofs, bool)
        if pec:
            self.ess_mask[self.space.boundary_dofs(pec)] = True

        self._build_domain()
        self._build_boundary()
        self._port_trace_bases: Dict[int, List[NDTraceBasis]] = {
            idx: [nd_trace_basis(self.space, tr) for tr in port.traces]
            for idx, port in self.ports.items()
        }

        # Surface current sources (reference: surfacecurrentoperator.cpp).
        self._surface_currents = []
        for sc in iodata.boundaries.surface_currents:
            from palace_torch.models.lumpedport import (
                CoaxialElement, UniformElement)

            elems, tbs = [], []
            el_list = sc.elements if sc.elements else [
                dict(attributes=sc.attributes, direction=sc.direction)]
            for el in el_list:
                attrs = el["attributes"] if isinstance(el, dict) else el.attributes
                d = el["direction"] if isinstance(el, dict) else el.direction
                if isinstance(d, str) and d.strip().upper().endswith("R"):
                    e = CoaxialElement.build(mesh, attrs, d)
                else:
                    if isinstance(d, str):
                        s = d.strip().upper()
                        vec = np.zeros(mesh.nodes.shape[1])
                        vec[{"X": 0, "Y": 1, "Z": 2}[s[-1]]] = (
                            -1.0 if s.startswith("-") else 1.0)
                    else:
                        vec = np.asarray(d, float)
                    e = UniformElement.build(mesh, attrs, vec)
                elems.append(e)
                tbs.append(nd_trace_basis(self.space, boundary_trace(
                    mesh, attrs, self.bdr_qorder)))
            self._surface_currents.append((sc, elems, tbs))

        # Floquet diffraction-order ports (reference:
        # palace/models/floquetportoperator.cpp).
        self.floquet_ports: Dict[int, object] = {}
        if b.floquet_ports:
            from palace_torch.config import ProblemType
            from palace_torch.models.floquetport import FloquetPortData

            if iodata.problem.type is not ProblemType.DRIVEN:
                raise ValueError(
                    "Floquet ports are only available for driven solves "
                    "(reference: floquetportoperator.cpp:931-933)")
            k = self.floquet_k if self.floquet_k is not None else np.zeros(3)
            for cfg in b.floquet_ports:
                fp = FloquetPortData(iodata, mesh, self.space, cfg,
                                     self.materials, k,
                                     self.floquet_omega_ref, self.bdr_qorder)
                self.floquet_ports[fp.index] = fp

        # Wave ports (reference: palace/models/waveportoperator.cpp).  Other
        # wave ports' surfaces are Dirichlet for this port's mode problem
        # (their shared edges carry E_t = 0; waveportoperator.cpp:1083-1131).
        self.wave_ports: Dict[int, object] = {}
        self._wp_trace_bases: Dict[int, NDTraceBasis] = {}
        if b.wave_ports:
            from palace_torch.models.waveport import WavePortData

            dbc = pec + list(b.wave_port_pec)
            for wcfg in b.wave_ports:
                other = [a for o in b.wave_ports if o.index != wcfg.index
                         for a in o.attributes if a not in wcfg.attributes]
                wp = WavePortData(iodata, mesh, wcfg, self.materials,
                                  dbc + other)
                self.wave_ports[wcfg.index] = wp
                self._wp_trace_bases[wcfg.index] = nd_trace_basis(
                    self.space, wp.trace)

    # -- assembly -----------------------------------------------------------

    def _build_domain(self):
        m = self.materials
        dev = self.device
        # London superconductors add a lambda_L^-2 mu^-1 value term to K.
        mls = self.iodata.units.mesh_length_scale
        london = None
        if any(abs(l) > 0 for l in m.london_depth.values()):
            london = {
                a: (m.inv_permeability[a] / (l / mls) ** 2 if abs(l) > 0
                    else 0.0 * m.inv_permeability[a])
                for a, l in m.london_depth.items()
            }
        self.K_dom = nd_operator(self.space, curl_coef=m.inv_permeability,
                                 mass_coef=london, device=dev)
        lossy = any(np.any(t != 0.0) for t in m.loss_tan.values())
        eps = m.complex_permittivity() if lossy else {
            a: t.astype(complex) for a, t in m.permittivity.items()
        }
        self.M_re = nd_operator(
            self.space, mass_coef={a: np.real(t) for a, t in eps.items()},
            device=dev)
        self.M_im = (
            nd_operator(self.space,
                        mass_coef={a: np.imag(t) for a, t in eps.items()},
                        device=dev)
            if lossy else None
        )
        has_sigma = any(np.any(t != 0.0) for t in m.conductivity.values())
        self.C_dom = (nd_operator(self.space, mass_coef=m.conductivity,
                                  device=dev) if has_sigma else None)
        self._build_floquet()

    def _build_floquet(self):
        """Quasi-periodic (Bloch/Floquet) volume terms.  The substitution
        E_phys = E_per exp(-i k.x) turns curl-curl into
        (mu^-1 curl u, curl v) + ((kx)^T mu^-1 kx u, v)
        + i [(mu^-1 kx u, curl v) - (mu^-1 kx curl u, v)]
        (reference: spaceoperator.cpp:1038-1056, materialoperator.cpp:
        351-358, 371-446).  Without FloquetReferenceFrequency k is wrapped
        into the first Brillouin zone of the mesh's bounding box; with it,
        k = k0 omega with k0 = k_F / omega_ref and the two terms scale with
        omega^2 and omega (driven only; materialoperator.cpp:394-427)."""
        self.K_flo_mass = self.K_flo_cross = None
        self.floquet_k: Optional[np.ndarray] = None
        self.floquet_omega_ref = 0.0
        kF_cfg = self.iodata.boundaries.floquet_wave_vector
        if kF_cfg is None or not np.linalg.norm(kF_cfg) > 0:
            return
        if self.mesh.nodes.shape[1] != 3:
            raise NotImplementedError(
                "Floquet wave vector requires a 3D mesh (reference: "
                "materialoperator.cpp:390-392)")
        from palace_torch.config import ProblemType
        from palace_torch.fem.nd_operators import nd_cross_operator

        ptype = self.iodata.problem.type
        if ptype not in (ProblemType.DRIVEN, ProblemType.EIGENMODE):
            raise ValueError(
                "Floquet quasi-periodicity is only available for driven or "
                "eigenmode solves (reference: materialoperator.cpp:386-389)")
        units = self.iodata.units
        k = np.asarray(kF_cfg, float)[:3] * units.mesh_length_scale
        fref = self.iodata.boundaries.floquet_reference_frequency
        wref = (2.0 * math.pi * fref / units.scale_factor(ValueType.FREQUENCY)
                if fref > 0.0 else 0.0)
        if wref > 0.0 and ptype is not ProblemType.DRIVEN:
            raise ValueError("FloquetReferenceFrequency requires Driven")
        if wref == 0.0:
            # Wrap to [-pi/L, pi/L] per axis (materialoperator.cpp:406-420).
            bb = self.mesh.nodes.max(axis=0) - self.mesh.nodes.min(axis=0)
            for i in range(3):
                half = math.pi / bb[i] if bb[i] > 0 else math.inf
                if abs(k[i]) > half:
                    k[i] = math.remainder(k[i], 2.0 * half)
        else:
            k = k / wref  # k0 = k_F / omega_ref
        self.floquet_omega_ref = wref
        self.floquet_k = k
        kx = np.array([[0.0, -k[2], k[1]],
                       [k[2], 0.0, -k[0]],
                       [-k[1], k[0], 0.0]])
        m = self.materials
        self.K_flo_mass = nd_operator(
            self.space, mass_coef={a: kx.T @ mi @ kx
                                   for a, mi in m.inv_permeability.items()},
            device=self.device)
        self.K_flo_cross = nd_cross_operator(
            self.space, {a: mi @ kx for a, mi in m.inv_permeability.items()},
            device=self.device)
        self._flo_csrs = None

    def floquet_csrs(self) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
        """(mass CSR, cross CSR) of the Floquet volume terms (cached)."""
        if self._flo_csrs is None:
            self._flo_csrs = (self._csr(self._combine(self.K_flo_mass, [])),
                              self._csr(self._combine(self.K_flo_cross, [])))
        return self._flo_csrs

    def floquet_mag_quad(self, x, omega: float, attrs=None) -> float:
        """The Floquet part Re x^H (s^2 Fm + i s Fc) x of the magnetic-energy
        quadratic form, from B = (curl E - i k x E) / (i omega) (reference:
        linalg/floquetcorrection.hpp:28-33), on the elements with an
        attribute in `attrs` (all by default); s = omega with
        FloquetReferenceFrequency (k = k0 omega), else 1."""
        if self.K_flo_mass is None:
            return 0.0
        s = omega if self.floquet_omega_ref > 0.0 else 1.0
        x = np.ascontiguousarray(x, complex)
        tot = 0.0
        for b, e1, e2 in zip(self.mesh.buckets,
                             self.K_flo_mass.element_energy(x),
                             self.K_flo_cross.element_energy(x)):
            v = 2.0 * (s * s * e1.real - s * e2.imag)
            if attrs is not None:
                v = v * torch.as_tensor(np.isin(b.attr, attrs),
                                        device=v.device)
            tot += float(torch.sum(v))
        return tot

    def _build_boundary(self):
        """Robin boundary buckets for K (1/Ls), C (1/Rs + first-order
        absorbing invz0), M (Cs)."""
        iod, mesh = self.iodata, self.mesh
        self.K_bdr: List[BucketTables] = []
        self.C_bdr: List[BucketTables] = []
        self.M_bdr: List[BucketTables] = []

        def add(target, attrs, coef):
            tr = boundary_trace(mesh, attrs, self.bdr_qorder)
            tb = nd_trace_basis(self.space, tr)
            c = np.full(len(tr.elem), float(coef)) if np.ndim(coef) == 0 \
                else coef
            target.append(boundary_mass_bucket(tb, c))

        for port in self.ports.values():
            if not port.active:
                continue
            for elem in port.elems:
                sq = port.to_square(elem)
                if abs(port.R) > 0:
                    add(self.C_bdr, elem.attrs, 1.0 / (port.R * sq))
                if abs(port.L) > 0:
                    add(self.K_bdr, elem.attrs, 1.0 / (port.L * sq))
                if abs(port.C) > 0:
                    add(self.M_bdr, elem.attrs, port.C / sq)

        units = self.iodata.units
        for imp in iod.boundaries.impedances:
            Rs = imp.Rs / units.scale_factor(ValueType.IMPEDANCE)
            Ls = imp.Ls / units.scale_factor(ValueType.INDUCTANCE)
            Cs = imp.Cs / units.scale_factor(ValueType.CAPACITANCE)
            if abs(Rs) > 0:
                add(self.C_bdr, imp.attributes, 1.0 / Rs)
            if abs(Ls) > 0:
                add(self.K_bdr, imp.attributes, 1.0 / Ls)
            if abs(Cs) > 0:
                add(self.M_bdr, imp.attributes, Cs)

        # Finite-conductivity (skin-depth) surfaces: a unit boundary mass
        # each, scaled per frequency by i omega / Z_s(omega) (reference:
        # surfaceconductivityoperator.cpp:148-175).
        self._conductivity: List[tuple] = []
        for cd in iod.boundaries.conductivities:
            sigma = cd.sigma / units.scale_factor(ValueType.CONDUCTIVITY)
            h = cd.h / units.mesh_length_scale
            if cd.external:
                # External surfaces see twice the effective thickness (the
                # BC is applied on one side only).
                h *= 2.0
            tr = boundary_trace(mesh, cd.attributes, self.bdr_qorder)
            bk = boundary_mass_bucket(nd_trace_basis(self.space, tr),
                                      np.ones(len(tr.elem)))
            self._conductivity.append((bk, sigma, cd.mu_r, h))

        ab = iod.boundaries.absorbing
        self._abc2_tb = None
        if ab is not None and ab.attributes:
            if ab.order > 1 and mesh.nodes.shape[1] != 3:
                # palace_tpu fails here in a matmul of its 3D curl trace.
                raise NotImplementedError(
                    "second-order Absorbing boundaries require a 3D mesh "
                    "(the boundary curl term has no 2D form)")
            tr = boundary_trace(mesh, ab.attributes, self.bdr_qorder)
            tb = nd_trace_basis(self.space, tr, with_curl=ab.order > 1)
            if ab.order > 1:
                self._abc2_tb = tb
            # invz0 = sqrt(mu^-1 eps) of the adjacent material, its
            # in-plane block on a 2D mesh.
            sdim = mesh.nodes.shape[1]
            invz = {a: _matsqrt(self.materials.inv_permeability[a]
                                @ self.materials.permittivity[a])[:sdim, :sdim]
                    for a in self.materials.permittivity}
            coef = self.materials.attr_tensor(invz, self._trace_attrs(tr))
            self.C_bdr.append(boundary_mass_bucket(tb, coef))

    def _trace_attrs(self, tr) -> np.ndarray:
        attrs = np.empty(len(tr.elem), np.int32)
        for bi, b in enumerate(self.mesh.buckets):
            s = tr.bucket == bi
            attrs[s] = b.attr[tr.elem[s]]
        return attrs

    # -- operators ----------------------------------------------------------

    def _combine(self, dom: Optional[PAOperator], bdr: List[BucketTables]):
        """(gidx, A) table pairs of dom + bdr contributions, orientation
        signs folded into the element matrices."""
        return signed_tables((dom.buckets if dom is not None else []) + bdr)

    def _csr(self, tables) -> sp.csr_matrix:
        return tables_csr(tables, self.space.num_dofs)

    def aux_bdr_attrs(self) -> list:
        """Boundary attributes whose H1 dofs are held Dirichlet in the
        divergence-free projection's auxiliary space (reference:
        spaceoperator.cpp:193-204, aux_bdr_marker = dbc | farfield |
        surf_sigma | surf_Z Rs/Ls | lumped-port R/L | wave | floquet).

        Gradients of H1 functions constrained on every lossy/port surface
        have zero tangential trace there, so g^H C x = 0 for any damped
        eigenvector x and the projection leaves the quadratic pencil's
        physical spectrum untouched; with the unconstrained H1 space the
        projection corrupts every damped eigenvalue."""
        iod = self.iodata
        attrs = set(iod.boundaries.pec)
        if iod.boundaries.absorbing is not None:
            attrs.update(iod.boundaries.absorbing.attributes)
        for cd in iod.boundaries.conductivities:
            attrs.update(cd.attributes)
        for imp in iod.boundaries.impedances:
            if imp.Rs != 0.0 or imp.Ls != 0.0:
                attrs.update(imp.attributes)
        for lp in iod.boundaries.lumped_ports:
            if any(abs(v) > 0 for v in (lp.R, lp.L, lp.Rs, lp.Ls)):
                for el in lp.elements:
                    attrs.update(el.attributes)
        for wp in iod.boundaries.wave_ports:
            attrs.update(wp.attributes)
        for fp in iod.boundaries.floquet_ports:
            attrs.update(fp.get("Attributes", []))
        return sorted(attrs)

    def stiffness_csr(self) -> sp.csr_matrix:
        """K, with the Floquet terms Fm + i Fc when they do not scale with
        omega (no FloquetReferenceFrequency)."""
        K = self._csr(self._combine(self.K_dom, self.K_bdr))
        if self.K_flo_mass is not None and self.floquet_omega_ref == 0.0:
            Fm, Fc = self.floquet_csrs()
            K = (K + Fm + 1j * Fc).tocsr()
        return K

    def damping_csr(self) -> Optional[sp.csr_matrix]:
        t = self._combine(self.C_dom, self.C_bdr)
        return self._csr(t) if t else None

    def mass_csr(self) -> sp.csr_matrix:
        M = self._csr(self._combine(self.M_re, self.M_bdr))
        if self.M_im is not None:
            M = (M + 1j * self._csr(self._combine(self.M_im, []))).tocsr()
        return M

    def system_csr(self, omega: float, K=None, C=None, M=None) -> sp.csr_matrix:
        """A(omega) = K + i omega C - omega^2 M (+ omega^2 Fm + i omega Fc,
        the Floquet terms under FloquetReferenceFrequency; reference:
        spaceoperator.cpp:425-427, 459-461) with PEC rows/cols set to
        identity (DIAG_ONE policy)."""
        K = self.stiffness_csr() if K is None else K
        C = self.damping_csr() if C is None else C
        M = self.mass_csr() if M is None else M
        A = K.astype(complex) - (omega * omega) * M
        if C is not None:
            A = A + 1j * omega * C
        if self.K_flo_mass is not None and self.floquet_omega_ref > 0.0:
            Fm, Fc = self.floquet_csrs()
            A = A + (omega * omega) * Fm + 1j * omega * Fc
        free = sp.diags((~self.ess_mask).astype(float))
        one = sp.diags(self.ess_mask.astype(float))
        return (free @ A @ free + one).tocsr()

    # -- excitation & measurement -------------------------------------------

    def excitations(self) -> Dict[int, List[int]]:
        """excitation index -> list of driven port indices (surface currents
        and dipoles are always excited and create excitation 1 if none
        exists)."""
        out: Dict[int, List[int]] = {}
        for idx, port in self.ports.items():
            if port.excitation:
                out.setdefault(port.excitation, []).append(idx)
        for idx, wp in self.wave_ports.items():
            if wp.excitation:
                out.setdefault(wp.excitation, []).append(idx)
        for idx, fp in self.floquet_ports.items():
            if fp.excitation:
                out.setdefault(fp.excitation, []).append(idx)
        if not out and (self.iodata.domains.current_dipoles
                        or self.iodata.boundaries.surface_currents):
            out[1] = []
        return dict(sorted(out.items()))

    def driven_terms(self, omegas=None) -> list:
        """The driven system as constant real matrices with complex frequency
        coefficients, A(omega) = sum_t c_t(omega) X_t (the input of the
        device FGMRES + p-MG stack)."""
        from palace_torch.linalg.device_ksp import Term

        shifted = self.iodata.solver.linear.pc_mat_shifted
        terms = [Term("K", self._combine(self.K_dom, self.K_bdr),
                      coef=lambda w: 1.0 + 0.0j)]
        Ct = self._combine(self.C_dom, self.C_bdr)
        if Ct:
            terms.append(Term("C", Ct, coef=lambda w: 1.0j * w))
        if self.K_flo_mass is not None:
            scaled = self.floquet_omega_ref > 0.0
            terms.append(Term(
                "floquet_mass", self._combine(self.K_flo_mass, []),
                coef=(lambda w: w * w + 0.0j) if scaled
                else (lambda w: 1.0 + 0.0j)))
            terms.append(Term(
                "floquet_cross", self._combine(self.K_flo_cross, []),
                coef=(lambda w: 1.0j * w) if scaled else (lambda w: 1.0j)))
        terms.append(Term("M", self._combine(self.M_re, self.M_bdr),
                          coef=lambda w: -(w * w) + 0.0j,
                          bcoef=(lambda w: w * w + 0.0j) if shifted else None))
        if self.M_im is not None:
            terms.append(Term("M_im", self._combine(self.M_im, []),
                              coef=lambda w: -1.0j * (w * w)))
        for idx, wp in self.wave_ports.items():
            if wp.active:
                terms.append(Term(
                    f"waveport{idx}",
                    self._combine(None, [self._waveport_mass_bucket(idx)]),
                    coef=lambda w, wp=wp: 1.0j * wp.solve_mode(w).kn.real))
        for si, (bk, sigma, mu, h) in enumerate(self._conductivity):
            terms.append(Term(
                f"conductivity{si}", self._combine(None, [bk]),
                coef=lambda w, c=(sigma, mu, h): _conductivity_coef(w, *c)))
        if self._abc2_tb is not None:
            terms.append(Term("abc2",
                              self._combine(None, [self._abc2_curl_bucket()]),
                              coef=lambda w: 1.0j * 0.5 / w))
        return terms

    # -- frequency-dependent boundary terms A2(omega) ------------------------

    def _free_csr(self, tables) -> sp.csr_matrix:
        """CSR of `tables` with the PEC rows and columns zeroed."""
        free = sp.diags((~self.ess_mask).astype(float))
        return (free @ self._csr(tables) @ free).tocsr()

    def _waveport_mass_bucket(self, idx: int) -> BucketTables:
        """mu^-1 boundary mass on the wave-port surface (frequency
        independent; the i Re kn(omega) scale lives in the coefficient)."""
        tr = self._wp_trace_bases[idx].tr
        muinv = self.materials.attr_tensor(self.materials.inv_permeability,
                                           self._trace_attrs(tr))
        return boundary_mass_bucket(self._wp_trace_bases[idx], muinv)

    def _abc2_curl_bucket(self) -> BucketTables:
        """(mu^-1 c)_nn-weighted surface-curl bucket of the second-order
        absorbing boundary, c = sqrt((mu eps)^-1) (the 1/omega scale lives
        in the coefficient; reference: farfieldboundaryoperator.cpp:109-140,
        divergence term omitted as in the reference)."""
        tr = self._abc2_tb.tr
        coef = np.empty(len(tr.elem))
        cache = {}
        for k, a in enumerate(self._trace_attrs(tr)):
            a = int(a)
            if a not in cache:
                mi = self.materials.inv_permeability[a]
                eps = self.materials.permittivity[a]
                cache[a] = mi @ _matsqrt(np.linalg.inv(np.linalg.inv(mi)
                                                       @ eps))
            nbar = tr.normal[k].mean(axis=0)
            coef[k] = float(nbar @ cache[a] @ nbar)
        return boundary_curl_bucket(self._abc2_tb, coef)

    def waveport_a2_csr(self, omega: float) -> Optional[sp.csr_matrix]:
        """sum over active ports of i Re kn(omega) (mu^-1 u_t, v_t)."""
        tables = [(bk.gidx, 1j * wp.solve_mode(omega).kn.real * bk.A)
                  for bk, wp in ((self._waveport_mass_bucket(idx), wp)
                                 for idx, wp in self.wave_ports.items()
                                 if wp.active)]
        return self._free_csr(tables) if tables else None

    def conductivity_a2_csr(self, omega: float) -> Optional[sp.csr_matrix]:
        """sum over Conductivity surfaces of i omega / Z_s(omega) times
        their boundary mass."""
        if not self._conductivity:
            return None
        return self._free_csr([(bk.gidx, _conductivity_coef(omega, *c) * bk.A)
                               for bk, *c in self._conductivity])

    def abc2_a2_csr(self, omega: float) -> Optional[sp.csr_matrix]:
        """i (0.5 / omega) (mu^-1 c)_nn (n.curl u, n.curl v) on the
        second-order absorbing surfaces."""
        if self._abc2_tb is None:
            return None
        bk = self._abc2_curl_bucket()
        return self._free_csr([(bk.gidx, 1j * (0.5 / omega) * bk.A)])

    def floquet_port_a2_csr(self, omega: float) -> Optional[sp.csr_matrix]:
        """The full-rank Robin part of the Floquet ports' DtN term,
        i gamma_00(omega) (mu^-1 u_t, v_t) on the port faces (reference:
        floquetportoperator.cpp:980-996); the per-order low-rank correction
        is `floquet_lowrank`."""
        if not self.floquet_ports:
            return None
        if not hasattr(self, "_fp_mass_buckets"):
            self._fp_mass_buckets = {}
            for idx, fp in self.floquet_ports.items():
                mi = self.materials.attr_tensor(
                    self.materials.inv_permeability,
                    self._trace_attrs(fp._tb.tr))
                self._fp_mass_buckets[idx] = boundary_mass_bucket(fp._tb, mi)
        tables = []
        for idx, fp in self.floquet_ports.items():
            fp.initialize(omega)
            bk = self._fp_mass_buckets[idx]
            tables.append((bk.gidx, 1j * fp.gamma0 * bk.A))
        return self._free_csr(tables)

    def floquet_lowrank(self, omega: float):
        """(U, g) with F(omega) = U diag(g) U^H, the columns v_k PEC-masked,
        or (None, None).  The rank-1 terms are g v v^H, not g conj(v) v^T,
        as the reference's LowRankComplexOperator::AddMult
        (floquetportoperator.cpp:32-56): the two agree at normal incidence
        (conjugation maps order (m, n) to (-m, -n), with equal g) but differ
        at oblique incidence, where gamma(m, n) != gamma(-m, -n)."""
        cols, gs = [], []
        free = ~self.ess_mask
        for fp in self.floquet_ports.values():
            for g, v in fp.lowrank_terms(omega):
                cols.append(np.where(free, v, 0.0))
                gs.append(g)
        if not cols:
            return None, None
        return np.stack(cols, axis=1), np.asarray(gs)

    def floquet_rhs2(self, excitation_idx: int, omega: float) -> np.ndarray:
        """The incident plane wave of the Floquet ports this excitation
        drives (floquetportoperator.cpp:876-915)."""
        rhs = np.zeros(self.space.num_dofs, complex)
        for fp in self.floquet_ports.values():
            if fp.excitation == excitation_idx:
                rhs += fp.excitation_rhs(omega, self.space.num_dofs)
        return np.where(self.ess_mask, 0.0, rhs)

    def floquet_sparams(self, E: np.ndarray, omega: float,
                        excitation_idx: int):
        """{port: {(m, n, is_te): S}} over the Floquet ports."""
        return {idx: fp.s_parameters(np.asarray(E), omega,
                                     subtract_incident=(
                                         fp.excitation == excitation_idx))
                for idx, fp in self.floquet_ports.items()}

    def a2_csr(self, omega: float) -> Optional[sp.csr_matrix]:
        """A2(omega): the sum of the three terms above and the Floquet
        ports' Robin term, or None."""
        parts = [A for A in (self.waveport_a2_csr(omega),
                             self.abc2_a2_csr(omega),
                             self.conductivity_a2_csr(omega),
                             self.floquet_port_a2_csr(omega))
                 if A is not None]
        return sum(parts[1:], parts[0]).tocsr() if parts else None

    def waveport_rhs2(self, excitation_idx: int, omega: float) -> np.ndarray:
        """RHS2 = -U_inc = 2 (-i omega) n x H_inc from the modal fields of
        the ports this excitation drives."""
        out = np.zeros(self.space.num_dofs, complex)
        for idx, wp in self.wave_ports.items():
            if wp.excitation != excitation_idx:
                continue
            s_field = wp.nxh_field(wp.solve_mode(omega), omega)
            tb = self._wp_trace_bases[idx]
            out += boundary_rhs(tb, 2.0 * omega * np.imag(s_field),
                                self.space.num_dofs)
            out += 1j * boundary_rhs(tb, -2.0 * omega * np.real(s_field),
                                     self.space.num_dofs)
        out[self.ess_mask] = 0.0
        return out

    def waveport_sparam(self, idx: int, E: np.ndarray, omega: float
                        ) -> complex:
        """Modal overlap S = -int conj(s_field) . E dS
        (reference: waveportoperator.cpp:832-850)."""
        wp = self.wave_ports[idx]
        s_field = wp.nxh_field(wp.solve_mode(omega), omega)
        sv = boundary_rhs(self._wp_trace_bases[idx], np.conj(s_field),
                          self.space.num_dofs)
        return complex(-np.dot(sv, E))

    def rhs1(self, excitation_idx: int) -> np.ndarray:
        """Real excitation vector -U_inc = 2 Hinc E_inc; the i omega factor is
        applied by the driven sweep."""
        out = np.zeros(self.space.num_dofs)
        for idx, port in self.ports.items():
            if port.excitation != excitation_idx:
                continue
            for elem, tb in zip(port.elems, self._port_trace_bases[idx]):
                Rs = port.R * port.to_square(elem)
                Hinc = 1.0 / math.sqrt(Rs * elem.w * elem.l * len(port.elems))
                f = elem.mode_field(tb.tr.xq, 2.0 * Hinc)
                out += boundary_rhs(tb, f, self.space.num_dofs)
        # Surface currents: unit current split across elements.
        for sc, elems, tbs in self._surface_currents:
            ne = len(elems)
            for elem, tb in zip(elems, tbs):
                f = elem.mode_field(tb.tr.xq, -1.0 / (elem.w * ne))
                out += boundary_rhs(tb, f, self.space.num_dofs)
        # Point current dipoles: rhs_n = -moment d . v_n(x0).
        for dp in self.iodata.domains.current_dipoles:
            import palace_torch.fem.reference as refmod
            from palace_torch.fem import evaluation

            x0 = np.asarray(dp.center, float) / self.iodata.units.mesh_length_scale
            loc = evaluation.PointLocator(self.mesh).locate(x0[None, :])[0]
            b = self.mesh.buckets[loc.bucket]
            xi = loc.xi[None, :]
            V, _ = self.space.basis_tables(b.geom, xi)
            gb = refmod.gmsh_geometry_basis(b.etype)
            X = self.mesh.nodes[b.conn[loc.elem]]
            J = X.T @ gb.eval_grad(xi)[0]
            vphys = np.linalg.inv(J).T @ V[0].T  # (sdim, nd)
            d = np.asarray(dp.direction, float)
            d = d / np.linalg.norm(d)
            u = self.iodata.units
            moment = dp.moment / (u.scale_factor(ValueType.CURRENT)
                                  * u.scale_factor(ValueType.LENGTH))
            contrib = -moment * (d @ vphys)
            sg = getattr(self.space, "elem_signs", None)
            if sg is not None and sg[loc.bucket] is not None:
                contrib = contrib * sg[loc.bucket][loc.elem]
            np.add.at(out, self.space.elem_dofs[loc.bucket][loc.elem], contrib)
        out[self.ess_mask] = 0.0
        return out

    def lumped_port_primary_et(self, idx: int) -> np.ndarray:
        """Tangential port-mode field E_t with unity-Z_R normalization,
        L2-projected onto the ND trace space by a port-boundary mass solve
        (copied from palace_tpu/models/spaceoperator.py
        lumped_port_primary_et; reference: spaceoperator.cpp:1083-1111
        GetLumpedPortExcitationVectorPrimaryEt).  DOF interpolation instead
        of the mass solve would break the |e_t| normalization the PROM
        circuit synthesis relies on (romoperator.cpp:624-675)."""
        from scipy.sparse.linalg import splu

        port = self.ports[idx]
        b = np.zeros(self.space.num_dofs)
        rows, cols, vals = [], [], []
        for elem, tb in zip(port.elems, self._port_trace_bases[idx]):
            Rs = 1.0 * port.to_square(elem)  # unity reference impedance
            Einc = math.sqrt(Rs / (elem.w * elem.l * len(port.elems)))
            f = elem.mode_field(tb.tr.xq, Einc)
            b += boundary_rhs(tb, f, self.space.num_dofs, tangential=True)
            A = np.einsum("fq,fqns,fqms->fnm", tb.tr.wdetJ, tb.Vt, tb.Vt,
                          optimize=True)
            n = tb.dofs.shape[1]
            rows.append(np.repeat(tb.dofs, n, axis=1).ravel())
            cols.append(np.tile(tb.dofs, (1, n)).ravel())
            vals.append(A.ravel())
        M = sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=(self.space.num_dofs,) * 2).tocsr()
        # Restrict the (otherwise singular) trace mass to dofs with
        # tangential support on the port surface.
        diag = M.diagonal()
        support = np.where(diag > 1e-12 * diag.max())[0]
        et = np.zeros(self.space.num_dofs)
        et[support] = splu(M[support][:, support].tocsc()).solve(b[support])
        et[self.ess_mask] = 0.0  # zero_metal
        return et

    def port_functionals(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(s, v): S-parameter and voltage measurement vectors for port idx."""
        port = self.ports[idx]
        s = np.zeros(self.space.num_dofs)
        v = np.zeros(self.space.num_dofs)
        for elem, tb in zip(port.elems, self._port_trace_bases[idx]):
            Rs = port.R * port.to_square(elem)
            Hinc = (1.0 / math.sqrt(Rs * elem.w * elem.l * len(port.elems))
                    if abs(Rs) > 0 else 0.0)
            s += boundary_rhs(tb, elem.mode_field(tb.tr.xq, Hinc),
                              self.space.num_dofs)
            v += boundary_rhs(
                tb, elem.mode_field(tb.tr.xq, 1.0 / (elem.w * len(port.elems))),
                self.space.num_dofs,
            )
        return s, v

    def port_power(self, idx: int, E: np.ndarray, omega: float) -> complex:
        """P = int (E x conj(H)) . n dS with H = mu^-1 B, B = -curl E/(i w),
        +n the direction of propagation into the domain."""
        return complex(sum(self.port_power_trace(tb, E, omega)
                           for tb in self._port_trace_bases[idx]))

    def port_power_trace(self, tb: NDTraceBasis, E: np.ndarray, omega: float
                         ) -> complex:
        """P = int (E x conj(H)) . n dS over one trace (lumped-port element
        or wave-port surface)."""
        from palace_torch.fem.evaluation import trace_nd

        tr = tb.tr
        muinv = self.materials.attr_tensor(self.materials.inv_permeability,
                                           self._trace_attrs(tr))
        Ev = trace_nd(self.space, E, tr, which="value")  # (n, nq, sdim)
        Bv = trace_nd(self.space, E, tr, which="curl") * (-1.0 / (1j * omega))
        if self.mesh.nodes.shape[1] == 2:
            # 2D: H = (mu^-1)_zz B_z out of plane; E x H = (Ey H, -Ex H).
            H = muinv[:, 2, 2][:, None] * Bv[..., 0]
            ExH = np.stack([Ev[..., 1] * np.conj(H),
                            -Ev[..., 0] * np.conj(H)], axis=-1)
        else:
            H = np.einsum("fst,fqt->fqs", muinv, Bv)
            ExH = np.cross(Ev, np.conj(H))
        # Trace normals point out of the domain; propagation is inward.
        return complex(np.einsum("fq,fqs,fqs->", tr.wdetJ, ExH, -tr.normal))
