"""Configuration parsing, validation, and nondimensionalization.

Copied from palace_tpu/config/__init__.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import os

from palace_torch.config import jsonio
from palace_torch.config.schema import Config, ConfigError, ProblemType  # noqa: F401
from palace_torch.config.units import Units, ValueType  # noqa: F401


class IoData:
    """Parsed configuration plus units, mirroring the reference solver's
    IoData (reference: palace/utils/iodata.hpp:26-78).

    The units object is populated once the mesh is loaded (the default
    characteristic length Lc is the largest mesh bounding-box dimension,
    reference: palace/utils/geodata.cpp:411-423).
    """

    def __init__(self, config_path: str | None = None, config_dict: dict | None = None):
        if config_dict is None:
            config_dict = jsonio.load(config_path)
        self.path = config_path
        self.config = Config.parse(config_dict)
        self.units: Units | None = None

    @property
    def problem(self):
        return self.config.problem

    @property
    def model(self):
        return self.config.model

    @property
    def domains(self):
        return self.config.domains

    @property
    def boundaries(self):
        return self.config.boundaries

    @property
    def solver(self):
        return self.config.solver

    def mesh_path(self) -> str:
        p = self.config.model.mesh
        if self.path is not None and not os.path.isabs(p):
            return os.path.join(os.path.dirname(os.path.abspath(self.path)), p)
        return p

    def set_units_from_mesh(self, bbox_max_extent_l0: float):
        """Set units given the mesh bounding-box extent in L0 units."""
        L0 = self.config.model.L0
        Lc = self.config.model.Lc
        if Lc <= 0.0:
            Lc = bbox_max_extent_l0
        self.units = Units(L0, Lc * L0)
        return self.units
