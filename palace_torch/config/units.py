"""Nondimensionalization of the EM problem.

All interior computation is dimensionless.  Lengths are scaled by a
characteristic length Lc [m], times by tc = Lc/c0, and fields by a
characteristic magnetic field Hc with Hc^2 * Z0 * Lc^2 = 1 W so that the
characteristic power is 1 W.  Matches the reference solver's conventions
(reference: palace/utils/units.hpp:17-160) so outputs agree numerically.

Copied from palace_tpu/config/units.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import enum
import math

from palace_torch.utils import constants as em


class ValueType(enum.Enum):
    TIME = "time"  # [ns]
    FREQUENCY = "frequency"  # [GHz]
    LENGTH = "length"  # [m]
    IMPEDANCE = "impedance"  # [Ohm]
    INDUCTANCE = "inductance"  # [H]
    CAPACITANCE = "capacitance"  # [F]
    CONDUCTIVITY = "conductivity"  # [S/m]
    VOLTAGE = "voltage"  # [V]
    CURRENT = "current"  # [A]
    POWER = "power"  # [W]
    ENERGY = "energy"  # [J]
    FIELD_E = "field_e"  # [V/m]
    FIELD_D = "field_d"  # [C/m^2]
    FIELD_H = "field_h"  # [A/m]
    FIELD_B = "field_b"  # [Wb/m^2]


class Units:
    """Dimensionalization scale factors.

    Args:
      L0_m: mesh unit length [m] (config["Model"]["L0"]).
      Lc_m: characteristic reference length [m] (L0 * config["Model"]["Lc"],
        defaulting to the largest bounding-box dimension of the mesh).
    """

    def __init__(self, L0_m: float, Lc_m: float):
        self.L0_m = L0_m
        self.Lc_m = Lc_m
        self.tc_ns = 1.0e9 * Lc_m / em.C0
        self.Hc = 1.0 / math.sqrt(em.Z0 * Lc_m * Lc_m)

    @property
    def mesh_length_scale(self) -> float:
        """Scale factor converting mesh coordinates (in L0 units) to the
        dimensionless computational frame: x_nondim = x_mesh / mesh_length_scale."""
        return self.Lc_m / self.L0_m

    def scale_factor(self, vt: ValueType) -> float:
        Z0, Lc, Hc, tc = em.Z0, self.Lc_m, self.Hc, self.tc_ns
        if vt is ValueType.TIME:
            return tc  # [ns]
        if vt is ValueType.FREQUENCY:
            return 1.0 / tc  # [GHz]
        if vt is ValueType.LENGTH:
            return Lc
        if vt is ValueType.IMPEDANCE:
            return Z0
        if vt is ValueType.INDUCTANCE:
            return em.MU0 * Lc
        if vt is ValueType.CAPACITANCE:
            return em.EPSILON0 * Lc
        if vt is ValueType.CONDUCTIVITY:
            return 1.0 / (Z0 * Lc)
        if vt is ValueType.VOLTAGE:
            return Hc * Z0 * Lc
        if vt is ValueType.CURRENT:
            return Hc * Lc
        if vt is ValueType.POWER:
            return Hc * Hc * Z0 * Lc * Lc
        if vt is ValueType.ENERGY:
            return 1.0e-9 * Hc * Hc * Z0 * Lc * Lc * tc
        if vt is ValueType.FIELD_E:
            return Hc * Z0
        if vt is ValueType.FIELD_D:
            return em.EPSILON0 * Hc * Z0
        if vt is ValueType.FIELD_H:
            return Hc
        if vt is ValueType.FIELD_B:
            return em.MU0 * Hc
        raise ValueError(f"unknown value type {vt}")

    def dimensionalize(self, vt: ValueType, value):
        return value * self.scale_factor(vt)

    def nondimensionalize(self, vt: ValueType, value):
        return value / self.scale_factor(vt)
