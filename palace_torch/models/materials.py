"""Material property handling (reference: palace/models/materialoperator.hpp:17-19).

Maps mesh domain attributes to (possibly anisotropic) material tensors in
nondimensionalized units: relative permittivity, inverse relative
permeability, loss tangent, conductivity, London penetration depth.

Copied from palace_tpu/models/materials.py, imports pointed at palace_torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from palace_torch.config import IoData
from palace_torch.config.units import ValueType


def _tensor(diag, axes) -> np.ndarray:
    t = np.diag(np.asarray(diag, float))
    if axes is not None:
        R = np.asarray(axes, float).T  # columns are material axes
        t = R @ t @ R.T
    return t


@dataclass
class MaterialOperator:
    """Per-attribute material tensors (3x3, symmetric)."""

    permittivity: Dict[int, np.ndarray]
    inv_permeability: Dict[int, np.ndarray]
    loss_tan: Dict[int, np.ndarray]
    conductivity: Dict[int, np.ndarray]
    london_depth: Dict[int, float]

    @staticmethod
    def build(iodata: IoData) -> "MaterialOperator":
        eps, muinv, tand, sigma, london = {}, {}, {}, {}, {}
        sigma_scale = iodata.units.scale_factor(ValueType.CONDUCTIVITY)
        for m in iodata.domains.materials:
            te = _tensor(m.permittivity, m.material_axes)
            tm = _tensor(m.permeability, m.material_axes)
            tl = _tensor(m.loss_tan, m.material_axes)
            ts = _tensor(m.conductivity, m.material_axes) / sigma_scale
            for a in m.attributes:
                eps[a] = te
                muinv[a] = np.linalg.inv(tm)
                tand[a] = tl
                sigma[a] = ts
                london[a] = m.london_depth
        return MaterialOperator(eps, muinv, tand, sigma, london)

    def has_loss(self) -> bool:
        return any(np.any(t != 0.0) for t in self.loss_tan.values()) or any(
            np.any(t != 0.0) for t in self.conductivity.values()
        )

    def complex_permittivity(self) -> Dict[int, np.ndarray]:
        """eps * (1 - i tan(delta)) per attribute."""
        out = {}
        for a, e in self.permittivity.items():
            out[a] = e.astype(complex) - 1j * (e @ self.loss_tan[a])
        return out

    def attr_tensor(self, table: Dict[int, np.ndarray], attrs: np.ndarray
                    ) -> np.ndarray:
        """(E, 3, 3) per-element tensor for an attribute array."""
        uniq = np.unique(attrs)
        missing = [a for a in uniq if int(a) not in table]
        if missing:
            raise ValueError(f"no material defined for attribute(s) {missing}")
        amax = int(uniq.max())
        shape = table[int(uniq[0])].shape
        lut = np.zeros((amax + 1,) + shape, table[int(uniq[0])].dtype)
        for a in uniq:
            lut[int(a)] = table[int(a)]
        return lut[attrs]
