"""Flux-recovery error estimators (palace_torch/fem/estimators.py) against
palace_tpu's on the same field: grad-flux and curl-flux indicators on the
PEC cube of the eigenmode case (2^3 cells, Order 3), meshed as hexes and
as tets, real and complex fields.  The port contracts each element with batched
matrix products where palace_tpu uses einsum, so the two agree to the
mass solves' tolerance (Jacobi-CG to 1e-10 on both sides): 1e-8 relative.
"""

import json
import os

import numpy as np
import pytest

from palace_torch.cases import write_eigen_case
from palace_torch.config import IoData as TorchIoData
from palace_torch.drivers.common import prepare_mesh as torch_prepare_mesh
from palace_torch.fem import estimators as port_est
from palace_torch.mesh import gmsh_write
from palace_torch.mesh.generate import box_tet
from palace_torch.models.spaceoperator import SpaceOperator
from palace_tpu.config import IoData
from palace_tpu.drivers.common import prepare_mesh
from palace_tpu.fem import estimators as jest
from palace_tpu.models.spaceoperator import SpaceOperator as JaxSpaceOperator

_OPS = {}


def _operators(tmp_path_factory, mesh):
    """(port SpaceOperator, palace_tpu SpaceOperator) of the cube, Order 3
    (the order of both smoke-run cases)."""
    key = mesh
    if key not in _OPS:
        d = str(tmp_path_factory.mktemp(f"est_{mesh}"))
        path = write_eigen_case(d, 2, 3, device="CPU", verbose=0)
        if mesh == "tet":
            gmsh_write.write(box_tet(2, 2, 2, lx=24.0, ly=24.0, lz=24.0),
                             os.path.join(d, "box.msh"))
        with open(path) as f:
            assert json.load(f)["Model"]["Mesh"] == "box.msh"
        io_t, io_j = TorchIoData(path), IoData(path)
        _OPS[key] = (SpaceOperator(io_t, torch_prepare_mesh(io_t)),
                     JaxSpaceOperator(io_j, prepare_mesh(io_j)))
    return _OPS[key]


def _field(sop, cplx):
    rng = np.random.default_rng(11)
    n = sop.space.num_dofs
    E = rng.standard_normal(n) + (1j * rng.standard_normal(n) if cplx else 0)
    E[sop.ess_mask] = 0.0
    return E


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("mesh", ["hex", "tet"])
def test_curl_flux_indicators_match_jax(tmp_path_factory, mesh, cplx):
    t, j = _operators(tmp_path_factory, mesh)
    assert t.space.num_dofs == j.space.num_dofs
    E = _field(t, cplx)
    eta_t = port_est.curl_flux_indicators(t.space, t.materials, E)
    eta_j = jest.curl_flux_indicators(j.space, j.materials, E)
    assert eta_t.shape == eta_j.shape and np.isfinite(eta_t).all()
    assert _rel(eta_t, eta_j) < 1e-8


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("mesh", ["hex", "tet"])
def test_grad_flux_indicators_match_jax(tmp_path_factory, mesh, cplx):
    t, j = _operators(tmp_path_factory, mesh)
    E = _field(t, cplx)
    eta_t = port_est.grad_flux_indicators(t.space, t.materials, E)
    eta_j = jest.grad_flux_indicators(j.space, j.materials, E)
    assert eta_t.shape == eta_j.shape and np.isfinite(eta_t).all()
    assert _rel(eta_t, eta_j) < 1e-8
