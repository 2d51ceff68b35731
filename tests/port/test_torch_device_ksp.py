"""Blocked FGMRES + p-MG: palace_torch's BlockedDeviceSolver (CPU) against
palace_tpu's BlockedDeviceSolver and sparse-direct sweep, on operators
carried over bit-identically through palace_torch.interop and the port's own
mesh and Nedelec space (same dof numbering).  Tolerance 1e-8
relative per column (the solvers stop at Tol 1e-10; both take the same
iteration counts).  And the port's one-level (Order 1) hierarchy, where it
departs from palace_tpu, against its own sparse-direct sweep."""

import json
import math
import os

import numpy as np
import pytest

from palace_tpu.config import IoData, ValueType
from palace_tpu.drivers.common import prepare_mesh
from palace_tpu.drivers.driven import driven_samples_ghz, sweep_uniform_direct
from palace_tpu.linalg.device_ksp import (
    BlockedDeviceSolver as JaxBlockedDeviceSolver)
from palace_tpu.mesh import gmsh_write
from palace_tpu.mesh.generate import box_tet
from palace_tpu.models.spaceoperator import SpaceOperator
from palace_torch.cases import write_slice_case
from palace_torch.config import IoData as TorchIoData
from palace_torch.drivers.common import prepare_mesh as torch_prepare_mesh
from palace_torch.mesh.mesh import canonicalize_simplices
from palace_torch.interop import terms_from_numpy
from palace_torch.fem.nd import NDSpace as TorchNDSpace
from palace_torch.linalg.device_ksp import BlockedDeviceSolver

ETA0 = 376.730313412
KW = dict(tol=1e-10, max_its=200, restart=30)


def _tem_case(tmp_path):
    """tests/test_device_ksp.py:_tem_case: box_tet 4^3, Order 2, two lumped
    ports, 8-10 GHz (the element fine-level path)."""
    mesh = box_tet(4, 4, 4, lx=10.0, ly=10.0, lz=10.0)
    gmsh_write.write(mesh, os.path.join(str(tmp_path), "box.msh"))
    cfg = {
        "Problem": {"Type": "Driven", "Verbose": 0, "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1], "Permeability": 1.0,
                                   "Permittivity": 2.0}]},
        "Boundaries": {
            "PEC": {"Attributes": [5, 6]},
            "LumpedPort": [
                {"Index": 1, "Attributes": [1], "R": ETA0, "Direction": "+Z",
                 "Excitation": True},
                {"Index": 2, "Attributes": [2], "R": ETA0, "Direction": "+Z"},
            ],
        },
        "Solver": {"Order": 2, "Device": "CPU",
                   "Driven": {"MinFreq": 8.0, "MaxFreq": 10.0,
                              "FreqStep": 1.0},
                   "Linear": {"Type": "GMG", "Tol": 1e-10, "MaxIts": 200}},
    }
    path = os.path.join(str(tmp_path), "case.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _setup(path):
    iodata = IoData(path)
    sop = SpaceOperator(iodata, prepare_mesh(iodata))
    fscale = iodata.units.scale_factor(ValueType.FREQUENCY)
    omegas = [2 * math.pi * f / fscale for f in driven_samples_ghz(iodata)]
    ex = sop.excitations()
    rhs = np.stack([1j * w * sop.rhs1(next(iter(ex))) for w in omegas], 1)
    return iodata, sop, omegas, ex, rhs


def _col_rel(a, b):
    return max(np.linalg.norm(a[:, j] - b[:, j]) / np.linalg.norm(b[:, j])
               for j in range(b.shape[1]))


@pytest.mark.parametrize("case", ["structured", "element"])
def test_blocked_solver_matches_jax(tmp_path, case):
    path = (write_slice_case(str(tmp_path), 4, 2, tol=1e-10, verbose=0,
                             device="CPU")
            if case == "structured" else _tem_case(tmp_path))
    iodata, sop, omegas, ex, rhs = _setup(path)
    pec = iodata.boundaries.pec
    terms = sop.driven_terms(omegas)
    jsolver = JaxBlockedDeviceSolver(sop.space, pec, terms, omegas,
                                     sop.ess_mask, **KW)
    t_iodata = TorchIoData(path)
    t_mesh = torch_prepare_mesh(t_iodata)
    canonicalize_simplices(t_mesh)
    tspace = TorchNDSpace(t_mesh, t_iodata.solver.order)
    assert tspace.num_dofs == sop.space.num_dofs
    tsolver = BlockedDeviceSolver(tspace, pec, terms_from_numpy(terms),
                                  omegas, sop.ess_mask, **KW)
    assert (tsolver.structured is not None) == (case == "structured")
    assert (jsolver._fine_perm is not None) == (case == "structured")
    X_j, info_j = jsolver.solve(rhs)
    X_t, info_t = tsolver.solve(rhs)
    assert np.array_equal(info_t["iterations"], info_j["iterations"])
    assert info_t["relres"].max() <= 1e-10
    assert _col_rel(X_t, X_j) < 1e-8
    direct = sweep_uniform_direct(iodata, sop, omegas, ex)
    X_d = np.stack([direct[(next(iter(ex)), i)] for i in range(len(omegas))],
                   1)
    assert _col_rel(X_t, X_d) < 1e-8
    # The fine-level operator apply itself (lattice permutation included).
    c = np.array([t.coef(omegas[0]) for t in terms])
    Y_j = np.asarray(jsolver.apply_fine(c, X_d))
    assert _col_rel(tsolver.apply_fine(c, X_d), Y_j) < 1e-12


def test_one_level_hierarchy_converges(tmp_path):
    """Order 1 gives a one-level hierarchy, whose coarse factorization is
    the fine operator with its PEC rows and columns eliminated (a
    deliberate divergence: palace_tpu factors them uneliminated; built that
    way, the port's FGMRES stalled, 420 iterations to relres 1e-7 on the
    4 x 2 x 2 guide).
    On the WR-90 guide's device sweep every column converges in one cycle
    and matches the sparse-direct sweep of the same SpaceOperator."""
    from palace_torch.cases import write_waveguide_case
    from palace_torch.config import ValueType as TorchValueType
    from palace_torch.drivers import driven
    from palace_torch.models.spaceoperator import (
        SpaceOperator as TorchSpaceOperator)

    iodata = TorchIoData(write_waveguide_case(str(tmp_path), 6, 3, 2, 1,
                                              tol=1e-12, device="CPU",
                                              verbose=0))
    sop = TorchSpaceOperator(iodata, torch_prepare_mesh(iodata))
    fs = iodata.units.scale_factor(TorchValueType.FREQUENCY)
    omegas = [2 * math.pi * f / fs for f in driven.driven_samples_ghz(iodata)]
    ex = sop.excitations()
    X = driven.sweep_uniform_device(iodata, sop, omegas, ex)
    info = driven.sweep_uniform_device._last_info
    assert max(info["col_relres"].values()) <= 1e-12
    assert info["total_its"] == 30 * len(omegas)
    Y = driven.sweep_uniform_direct(iodata, sop, omegas, ex)
    for key, ref in Y.items():
        assert np.linalg.norm(X[key] - ref) <= 1e-8 * np.linalg.norm(ref)
