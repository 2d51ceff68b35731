"""Solve-estimate loop of the adaptive drivers (counterpart of
palace_tpu/drivers/amr.py `combine_indicators` and `adapt_loop`).

Only the loop's single pass is ported: the solve on the given mesh and its
combined error indicators.  Refinement (Model/Refinement/MaxIts > 0: Dörfler
marking and conforming or nonconforming local refinement) is not.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from palace_torch.config import IoData
from palace_torch.mesh.mesh import Mesh
from palace_torch.utils import unported


def combine_indicators(eta2_steps: Sequence[np.ndarray],
                       energies: Sequence[float]) -> Tuple[np.ndarray, float]:
    """Mean of the energy-normalized indicators over solve steps and its
    l2 norm (the global relative error, the "Norm" column of
    error-indicators.csv; reference: palace/fem/errorindicator.cpp)."""
    combined = None
    for eta2, Et in zip(eta2_steps, energies):
        eta = np.sqrt(eta2 * (0.5 / Et if Et and Et > 0 else 1.0))
        if combined is None:
            combined, n = eta, 1
        else:
            combined = np.sqrt((combined**2 * n + eta**2) / (n + 1))
            n += 1
    if combined is None:
        return np.zeros(0), 0.0
    return combined, float(np.linalg.norm(combined))


def adapt_loop(iodata: IoData, mesh: Mesh, solve_and_estimate):
    """`solve_and_estimate(mesh)` returns (result, eta2_steps, energies,
    num_dofs); runs it once on `mesh` (the JAX loop's first pass, where it
    stops when Refinement.MaxIts is 0).  Returns (result, eta_elem,
    eta_norm, mesh, n_iterations = 0)."""
    if iodata.model.refinement.max_it > 0:
        unported("AMR (Model/Refinement/MaxIts > 0)",
                 "electrostatic/magnetostatic/AMR")
    result, eta2_steps, energies, _ = solve_and_estimate(mesh)
    eta_elem, eta_norm = combine_indicators(eta2_steps, energies)
    return result, eta_elem, eta_norm, mesh, 0
