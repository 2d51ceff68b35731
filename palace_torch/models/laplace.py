"""Electrostatics: Laplace operator with terminal boundary conditions
(counterpart of palace_tpu/models/laplace.py).

Reference: palace/models/laplaceoperator.hpp:36-38 — H1 stiffness
(eps grad V, grad v), per-terminal unit-voltage excitations, E = -grad V.
The operator's element tables live on `device`; the excitation is built
there too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from palace_torch.config import IoData
from palace_torch.fem.h1 import H1Space
from palace_torch.fem.operators import h1_operator
from palace_torch.mesh.mesh import Mesh
from palace_torch.models.materials import MaterialOperator
from palace_torch.ops.partial import (EliminatedOperator, PAOperator,
                                      make_ess_mask)


@dataclass
class LaplaceOperator:
    space: H1Space
    materials: MaterialOperator
    K: PAOperator  # (eps grad u, grad v)
    Keli: EliminatedOperator
    ess_mask: np.ndarray
    terminals: Dict[int, np.ndarray]  # terminal index -> dof ids

    @staticmethod
    def build(iodata: IoData, mesh: Mesh,
              device: torch.device = torch.device("cpu")) -> "LaplaceOperator":
        space = H1Space(mesh, iodata.solver.order)
        materials = MaterialOperator.build(iodata)
        K = h1_operator(space, diffusion_coef=materials.permittivity,
                        device=device)

        terminals = {}
        for t in sorted(iodata.boundaries.terminals, key=lambda t: t.index):
            terminals[t.index] = space.boundary_dofs(t.attributes)
        ground = space.boundary_dofs(iodata.boundaries.ground)

        ess = [ground] + list(terminals.values())
        ess_dofs = np.unique(np.concatenate([e for e in ess if len(e)]))
        mask = make_ess_mask(space.num_dofs, ess_dofs)
        return LaplaceOperator(
            space, materials, K, EliminatedOperator(K, mask), mask, terminals)

    def excitation(self, idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x_bc, rhs) for unit voltage on terminal idx, 0 elsewhere."""
        dev = self.K.device
        xbc = torch.zeros(self.space.num_dofs, dtype=torch.float64,
                          device=dev)
        xbc[torch.as_tensor(np.asarray(self.terminals[idx], np.int64),
                            device=dev)] = 1.0
        b = self.Keli.eliminate_rhs(torch.zeros_like(xbc), xbc)
        return xbc, b
