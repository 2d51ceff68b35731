"""The plain reference of a driven solve on a box hex mesh, worked out from
the configuration and the mesh alone:

    A(omega) = K - omega^2 eps_c M + sum_p i kn_p / mu M_p,
    b(omega) = i omega b1 + sum_(excited p) 2 i kn_p / mu M_p e_p,

with K the curl-curl and M the mass of the order-p Nedelec space, eps_c =
eps (1 - i tan delta), b1 the current dipoles' point loads, and for each
wave port p its surface mass M_p, its mode e_p (the lowest non-gradient
eigenpair S_p e = lambda_c M_p e of the port's normal-curl form S_p on the
port's free trace dofs; kn = sqrt(omega^2 eps mu - lambda_c)), normalized
to unit power (kn / (omega mu)) e^H M_p e = 1 and signed so that its
integral over the port's upper-right quadrant, summed over components, is
negative (the solver's phase rule makes the quadrant integral of n x H
positive).  PEC rows and columns are replaced by the identity.  S_p =
(kn / (omega mu)) e_p^H M_p x, less 1 at the driven port.

This closed form of the port terms holds for a homogeneous guide, whose
modes are TE with no normal field; the configurations here are such.

Units follow the solver's documented nondimensionalization: lengths over
Lc (the mesh's largest extent), times over Lc / c0, fields over
Hc = 1 / sqrt(Z0 Lc^2), so a dipole moment m (A m) enters as
m sqrt(Z0) / Lc and a frequency f as 2 pi f Lc / c0.

`dtype` gives the precision the reference computes in: float64 is the
reference; float32 is the lower-precision control that the comparison
has to reject.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp

from reference import ndhex

C0 = 299_792_458.0
MU0 = 1.256_637_061_27e-6  # CODATA 2022
Z0 = MU0 * C0


@dataclass
class Port:
    index: int
    excited: bool
    M: sp.csr_matrix  # unit surface mass on the 3D dofs
    e: np.ndarray  # mode on the 3D dofs, unnormalized
    lam_c: float  # cutoff eigenvalue of the port's form


class DrivenReference:
    def __init__(self, config: dict, mesh, dtype=np.float64):
        pal = config["palace"]
        self.dtype = np.dtype(dtype)
        self.cdtype = np.result_type(self.dtype, np.complex64)
        L0 = float(pal["Model"]["L0"])
        extent = float((mesh.nodes.max(0) - mesh.nodes.min(0)).max())
        self.Lc = extent * L0
        nodes = mesh.nodes / extent
        mat = pal["Domains"]["Materials"]
        if len(mat) != 1:
            raise ValueError("the reference takes one homogeneous material")
        m = mat[0]
        self.eps = float(m.get("Permittivity", 1.0))
        self.tand = float(m.get("LossTan", 0.0))
        self.mu = float(m.get("Permeability", 1.0))
        p = int(pal["Solver"]["Order"])
        self.space = ndhex.HexND.build(nodes, mesh.hexes, p)
        n = self.space.num_dofs
        bdr = pal["Boundaries"]
        pec = set(bdr.get("PEC", {}).get("Attributes", []))
        quads = mesh.quads[np.isin(mesh.quad_attr, list(pec))]
        self.ess = np.zeros(n, bool)
        self.ess[self.space.boundary_dofs(quads)] = True
        Ke, Me = ndhex.element_matrices(self.space)
        self.K = ndhex.assemble(self.space, Ke / self.mu).astype(self.dtype)
        self.M = ndhex.assemble(self.space, Me).astype(self.dtype)
        b1 = np.zeros(n)
        for dp in pal["Domains"].get("CurrentDipole", []):
            x0 = np.asarray(dp["Center"], float) / extent
            moment = float(dp["Moment"]) * math.sqrt(Z0) / self.Lc
            b1 += ndhex.point_load(self.space, x0, dp["Direction"], -moment)
        b1[self.ess] = 0.0
        self.b1 = b1.astype(self.dtype)
        self.free = (~self.ess).astype(self.dtype)
        self.ports: List[Port] = [
            self._port(wp, mesh) for wp in bdr.get("WavePort", [])]

    def _port(self, cfg: dict, mesh) -> Port:
        n = self.space.num_dofs
        quads = mesh.quads[np.isin(mesh.quad_attr, cfg["Attributes"])]
        tr = ndhex.face_trace(self.space, quads)
        Mf, Sf = tr.mass(n), tr.curl(n)
        # The port's trace dofs; other dofs' traces are rounding (~1e-16).
        d = Mf.diagonal()
        on = np.flatnonzero((d > 1e-10 * d.max()) & ~self.ess)
        lam, vec = sla.eigh(Sf[on][:, on].toarray(), Mf[on][:, on].toarray())
        mode = int(cfg.get("Mode", 1))
        k = np.flatnonzero(lam > 1e-8 * lam.max())[mode - 1]
        e = np.zeros(n)
        e[on] = vec[:, k]
        # Phase: the quadrant of the two largest port extents.
        pts = mesh.nodes[np.unique(quads)] / (mesh.nodes.max(0)
                                              - mesh.nodes.min(0)).max()
        lo, hi = pts.min(0), pts.max(0)
        da, db = np.argsort(-(hi - lo), kind="stable")[:2]
        c = 0.5 * (lo + hi)
        quad = (tr.x[..., da] >= c[da]) & (tr.x[..., db] >= c[db])
        if np.einsum("fq,fqs->", tr.w * quad, tr.field(e)) > 0:
            e = -e
        return Port(int(cfg["Index"]), bool(cfg.get("Excitation", False)),
                    Mf.astype(self.dtype), e.astype(self.dtype),
                    float(lam[k]))

    def omega(self, f_ghz: float) -> float:
        return 2.0 * math.pi * f_ghz * 1e9 * self.Lc / C0

    def eps_c(self) -> complex:
        return self.eps * (1.0 - 1j * self.tand)

    def kn(self, port: Port, w: float) -> float:
        return math.sqrt(w * w * self.eps * self.mu - port.lam_c)

    def mode(self, port: Port, w: float) -> np.ndarray:
        """e_p at unit power."""
        e = port.e.astype(np.float64)
        power = self.kn(port, w) / (w * self.mu) * (e @ (port.M @ e))
        return (e / math.sqrt(power)).astype(self.dtype)

    def a2(self, w: float):
        """sum_p i kn_p / mu M_p with PEC rows and columns zeroed, or None."""
        if not self.ports:
            return None
        F = sp.diags(self.free)
        A = sum((1j * self.kn(p, w) / self.mu) * p.M for p in self.ports)
        return (F @ A @ F).tocsr().astype(self.cdtype)

    def system(self, w: float) -> sp.csr_matrix:
        """A(omega) with the PEC rows and columns replaced by the identity."""
        A = (self.K - (w * w * self.eps_c()) * self.M).astype(self.cdtype)
        F = sp.diags(self.free)
        A = F @ A @ F + sp.diags(1.0 - self.free)
        a2 = self.a2(w)
        return (A if a2 is None else A + a2).tocsr().astype(self.cdtype)

    def rhs(self, w: float) -> np.ndarray:
        b = (1j * w) * self.b1.astype(self.cdtype)
        for p in self.ports:
            if p.excited:
                b = b + (2j * self.kn(p, w) / self.mu) * (p.M @ self.mode(p, w))
        b[self.ess] = 0.0
        return b.astype(self.cdtype)

    def sparams(self, x: np.ndarray, w: float) -> Dict[int, complex]:
        out = {}
        for p in self.ports:
            e = self.mode(p, w)
            s = self.kn(p, w) / (w * self.mu) * np.vdot(e, p.M @ x)
            out[p.index] = complex(s - (1.0 if p.excited else 0.0))
        return out

    def energies(self, x: np.ndarray, w: float):
        """(E_elec, E_mag) = (1/2 eps Re x^H M x, 1/2 Re x^H K x / omega^2)."""
        e = self.eps * np.real(np.vdot(x, self.M @ x)) / 2
        m = np.real(np.vdot(x, self.K @ x)) / (2 * w * w)
        return float(e), float(m)

    def apply(self, x: np.ndarray, w: float) -> np.ndarray:
        """A(omega) x by products with the constant matrices."""
        fx = self.free * x
        y = self.K @ fx - (w * w * self.eps_c()) * (self.M @ fx)
        for p in self.ports:
            y = y + (1j * self.kn(p, w) / self.mu) * (p.M @ fx)
        return self.free * y + (1.0 - self.free) * x

    def solve(self, w: float) -> np.ndarray:
        """A sparse direct solve in the reference's precision."""
        from scipy.sparse.linalg import splu

        A = self.system(w).tocsc()
        return splu(A, permc_spec="MMD_AT_PLUS_A").solve(self.rhs(w))

    def outputs(self, freqs_ghz) -> dict:
        """What the comparison reads of a program, produced by this
        reference in its own precision (the control): the operators, the
        load and port terms at the first frequency, and per frequency the
        solution, its energies and S-parameters."""
        cols = []
        for f in freqs_ghz:
            w = self.omega(f)
            x = self.solve(w)
            cols.append(dict(f_ghz=f, x=x, energies=self.energies(x, w),
                             S=self.sparams(x, w)))
        w0 = self.omega(freqs_ghz[0])
        M = (self.eps_c() * self.M.astype(np.complex128)).astype(self.cdtype)
        return dict(K=self.K, M=M, f_ghz=freqs_ghz[0], b=self.rhs(w0),
                    A2=self.a2(w0), columns=cols)
