"""Lumped port boundaries (reference: palace/models/lumpedportoperator.cpp,
palace/fem/lumpedelement.cpp).

A lumped port is a Robin impedance surface plus (optionally) an incident-field
excitation.  Geometry of each element (uniform rectangle or coaxial annulus)
gives the length l along the excitation direction and width w = area / l; the
surface impedance is Rs = R * (w/l) * n_elems etc. ("to-square" scaling,
reference: lumpedportoperator.hpp:60-63).

Copied from palace_tpu/models/lumpedport.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from palace_torch.config import IoData, ValueType
from palace_torch.fem.evaluation import BoundaryTrace, boundary_trace
from palace_torch.mesh.mesh import Mesh


def _port_nodes(mesh: Mesh, attrs) -> np.ndarray:
    pts = []
    for bb in mesh.bdr_buckets:
        sel = np.isin(bb.attr, list(attrs))
        if sel.any():
            pts.append(mesh.nodes[np.unique(bb.conn[sel].ravel())])
    if not pts:
        raise ValueError(f"no boundary elements with attributes {list(attrs)}")
    return np.concatenate(pts)


def direction_vector(d, sdim: int) -> np.ndarray:
    """Keyword ("+X"/"-Z"/...) or explicit vector direction -> unit vector
    (reference: utils/configfile.cpp ParseElementData keyword directions)."""
    if isinstance(d, str):
        s = d.strip().upper()
        sign = -1.0 if s.startswith("-") else 1.0
        axis = {"X": 0, "Y": 1, "Z": 2}[s[-1]]
        vec = np.zeros(sdim)
        vec[axis] = sign
        return vec
    vec = np.asarray(d, float)[:sdim]
    return vec / np.linalg.norm(vec)


def _surface_area(mesh: Mesh, attrs, qorder: int = 4) -> float:
    from palace_torch.mesh import geometry

    area = 0.0
    for bb in mesh.bdr_buckets:
        sel = np.isin(bb.attr, list(attrs))
        if sel.any():
            gf = geometry.compute(mesh.nodes, bb, qorder)
            area += float(gf.wdetJ[sel].sum())
    return area


@dataclass
class UniformElement:
    """Rectangular lumped element (reference: lumpedelement.cpp:16-140)."""

    attrs: List[int]
    direction: np.ndarray  # unit vector
    l: float
    w: float

    @staticmethod
    def build(mesh: Mesh, attrs, direction) -> "UniformElement":
        sdim = mesh.nodes.shape[1]
        d = np.asarray(direction, float)[:sdim]
        d = d / np.linalg.norm(d)
        pts = _port_nodes(mesh, attrs)
        if sdim == 2:
            # 2D: length along the direction, unit out-of-plane depth
            # (reference: lumpedelement.cpp:100-128).
            proj = pts @ d
            return UniformElement(list(attrs), d,
                                  float(proj.max() - proj.min()), 1.0)
        c = pts.mean(axis=0)
        X = pts - c
        # Oriented bounding box via principal axes of the node cloud.
        _, _, VT = np.linalg.svd(X, full_matrices=False)
        axes = VT  # rows are principal directions
        # Length = extent along the axis best aligned with `direction`.
        align = np.abs(axes @ d)
        ax = axes[int(np.argmax(align))]
        if align.max() < math.cos(math.radians(1.0)):
            # Direction doesn't match a principal axis (e.g. square port):
            # use the projection onto the given direction directly.
            ax = d
        proj = X @ ax
        l = float(proj.max() - proj.min())
        area = _surface_area(mesh, attrs)
        w = area / l
        return UniformElement(list(attrs), d, l, w)

    def mode_field(self, xq: np.ndarray, coeff: float = 1.0) -> np.ndarray:
        out = np.broadcast_to(self.direction * coeff, xq.shape)
        return np.ascontiguousarray(out)


@dataclass
class CoaxialElement:
    """Coaxial annulus lumped element (reference: lumpedelement.cpp:142-185):
    l = ln(r_out/r_in), w = 2 pi, mode field = sign * r_hat / r."""

    attrs: List[int]
    sign: float
    origin: np.ndarray
    r_outer: float
    r_inner: float

    @staticmethod
    def build(mesh: Mesh, attrs, direction) -> "CoaxialElement":
        if isinstance(direction, str):
            sign = -1.0 if direction.strip().upper().startswith("-") else 1.0
        else:
            sign = 1.0 if float(np.asarray(direction)[0]) > 0 else -1.0
        pts = _port_nodes(mesh, attrs)
        origin = 0.5 * (pts.min(axis=0) + pts.max(axis=0))
        r = np.linalg.norm(pts - origin, axis=1)
        r_outer = float(r.max())
        r_inner = float(r.min())
        if not r_inner > 0:
            raise ValueError("coaxial element annulus has zero inner radius")
        return CoaxialElement(list(attrs), sign, origin, r_outer, r_inner)

    @property
    def l(self) -> float:
        return math.log(self.r_outer / self.r_inner)

    @property
    def w(self) -> float:
        return 2.0 * math.pi

    def mode_field(self, xq: np.ndarray, coeff: float = 1.0) -> np.ndarray:
        rvec = xq - self.origin
        r2 = np.einsum("...s,...s->...", rvec, rvec)
        return self.sign * coeff * rvec / r2[..., None]


@dataclass
class LumpedPort:
    """R/L/C lumped port (possibly multielement)."""

    index: int
    R: float  # nondimensional circuit values
    L: float
    C: float
    excitation: int
    active: bool
    elems: List[object]
    traces: List[BoundaryTrace] = field(default_factory=list)

    def to_square(self, elem) -> float:
        return elem.w / elem.l * len(self.elems)

    def characteristic_impedance(self, omega: float, branch: str = "total"):
        """(reference: lumpedportoperator.cpp:110-133)."""
        Y = 0.0 + 0.0j
        if abs(self.R) > 0 and branch in ("total", "R"):
            Y += 1.0 / self.R
        if abs(self.L) > 0 and branch in ("total", "L"):
            Y += 1.0 / (1j * omega * self.L)
        if abs(self.C) > 0 and branch in ("total", "C"):
            Y += 1j * omega * self.C
        if Y == 0:
            raise ValueError("lumped port with zero admittance")
        return 1.0 / Y

    def excitation_voltage(self) -> float:
        """(reference: lumpedportoperator.cpp:142-160)."""
        if not self.excitation:
            return 0.0
        V_inc = 0.0
        for elem in self.elems:
            Rs = self.R * self.to_square(elem)
            E_inc = math.sqrt(Rs / (elem.w * elem.l * len(self.elems)))
            V_inc += E_inc * elem.l / len(self.elems)
        return V_inc


def build_lumped_ports(iodata: IoData, mesh: Mesh, qorder: int
                       ) -> Dict[int, LumpedPort]:
    """Construct ports with nondimensionalized circuit values and boundary
    traces at the given quadrature order."""
    units = iodata.units
    ports: Dict[int, LumpedPort] = {}
    for cfg in iodata.boundaries.lumped_ports:
        elems = []
        for el in cfg.elements:
            d = el.direction
            is_coax = isinstance(d, str) and d.strip().upper().endswith("R")
            if is_coax:
                elems.append(CoaxialElement.build(mesh, el.attributes, d))
            else:
                if isinstance(d, str):
                    s = d.strip().upper()
                    sign = -1.0 if s.startswith("-") else 1.0
                    axis = {"X": 0, "Y": 1, "Z": 2}[s[-1]]
                    vec = np.zeros(mesh.nodes.shape[1])
                    vec[axis] = sign
                else:
                    vec = np.asarray(d, float)
                elems.append(UniformElement.build(mesh, el.attributes, vec))
        # Circuit values: nondimensionalize; surface values convert via
        # to-square (reference: lumpedportoperator.cpp:70-107).
        R = cfg.R / units.scale_factor(ValueType.IMPEDANCE)
        L = cfg.L / units.scale_factor(ValueType.INDUCTANCE)
        C = cfg.C / units.scale_factor(ValueType.CAPACITANCE)
        if abs(cfg.Rs) + abs(cfg.Ls) + abs(cfg.Cs) > 0:
            Rs = cfg.Rs / units.scale_factor(ValueType.IMPEDANCE)
            Ls = cfg.Ls / units.scale_factor(ValueType.INDUCTANCE)
            Cs = cfg.Cs / units.scale_factor(ValueType.CAPACITANCE)
            ooR = ooL = 0.0
            C = 0.0
            for elem in elems:
                sq = elem.w / elem.l
                if abs(Rs) > 0:
                    ooR += sq / Rs
                if abs(Ls) > 0:
                    ooL += sq / Ls
                if abs(Cs) > 0:
                    C += sq * Cs
            R = 1.0 / ooR if abs(ooR) > 0 else 0.0
            L = 1.0 / ooL if abs(ooL) > 0 else 0.0
        port = LumpedPort(cfg.index, R, L, C, cfg.excitation, cfg.active, elems)
        port.traces = [boundary_trace(mesh, e.attrs, qorder) for e in elems]
        ports[cfg.index] = port
    return ports
