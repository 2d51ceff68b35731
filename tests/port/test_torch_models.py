"""The driven system and its postprocessing against palace_tpu on a config
that exercises every boundary and source the port carries: two lumped
ports (R, L, C), an impedance boundary (Rs, Ls, Cs), a first-order
absorbing boundary, a surface current, a current dipole, a lossy
dielectric, probes and a domain energy.  Covers models/spaceoperator.py,
fem/{operators,nd_boundary}.py, linalg/{iterative,smoothers}.py,
drivers/{common,driven}.py and, through the error-indicator table of the
whole run, fem/estimators.py.  Tolerances: the assembled operators and
vectors are built by the same float64 arithmetic and must agree to 1e-14
relative; the CG solve to 1e-9 (stopped at 1e-10); the direct-solver
sweep's CSVs to 1e-10 relative per column."""

import json
import os

import numpy as np
import pytest
import torch

import palace_torch
from palace_tpu import api as jax_api
from palace_tpu.config import IoData
from palace_tpu.drivers.common import prepare_mesh
from palace_tpu.drivers.common import (
    write_error_indicators as jax_write_error_indicators)
from palace_tpu.drivers.driven import driven_samples_ghz as jax_samples
from palace_tpu.fem import nd_boundary as jbdr
from palace_tpu.fem import operators as jops
from palace_tpu.fem.evaluation import boundary_trace
from palace_tpu.fem.nd import NDSpace
from palace_tpu.fem.reference import Geom
from palace_tpu.mesh import gmsh_write
from palace_tpu.mesh.generate import box_tet
from palace_tpu.mesh.mesh import canonicalize_simplices
from palace_tpu.models.spaceoperator import SpaceOperator as JaxSpaceOperator
from palace_torch.config import IoData as TorchIoData
from palace_torch.drivers.common import prepare_mesh as torch_prepare_mesh
from palace_torch.drivers.common import write_error_indicators
from palace_torch.drivers.driven import driven_samples_ghz
from palace_torch.fem import nd_boundary as tbdr
from palace_torch.fem import operators as tops
from palace_torch.fem.evaluation import boundary_trace as t_boundary_trace
from palace_torch.fem.nd import NDSpace as TorchNDSpace
from palace_torch.fem.nd_operators import nd_operator
from palace_torch.fem.reference import Geom as TorchGeom
from palace_torch.linalg.iterative import cg
from palace_torch.linalg.smoothers import jacobi
from palace_torch.mesh.generate import box_tet as t_box_tet
from palace_torch.mesh.mesh import canonicalize_simplices as t_canonicalize
from palace_torch.models.spaceoperator import SpaceOperator

TABLES = ("domain-E.csv", "error-indicators.csv", "port-I.csv", "port-S.csv",
          "port-V.csv", "probe-B.csv", "probe-E.csv")


def _rel(a, b):
    a = a.toarray() if hasattr(a, "toarray") else np.asarray(a)
    b = b.toarray() if hasattr(b, "toarray") else np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _rich_case(directory, order, linear="GMG"):
    os.makedirs(directory, exist_ok=True)
    gmsh_write.write(box_tet(3, 3, 3, lx=10.0, ly=10.0, lz=10.0),
                     os.path.join(directory, "box.msh"))
    cfg = {
        "Problem": {"Type": "Driven", "Verbose": 0, "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
        "Domains": {
            "Materials": [{"Attributes": [1], "Permeability": 1.0,
                           "Permittivity": 2.0, "LossTan": 0.02}],
            "CurrentDipole": [{"Index": 1, "Moment": 1.0,
                               "Center": [4.0, 5.0, 6.0],
                               "Direction": [0.0, 1.0, 0.0]}],
            "Postprocessing": {
                "Probe": [{"Index": 1, "Center": [5.0, 5.0, 5.0]}],
                "Energy": [{"Index": 1, "Attributes": [1]}]},
        },
        "Boundaries": {
            "PEC": {"Attributes": [5]},
            "LumpedPort": [
                {"Index": 1, "Attributes": [1], "R": 50.0, "L": 1e-9,
                 "C": 1e-13, "Direction": "+Z", "Excitation": True},
                {"Index": 2, "Attributes": [2], "R": 50.0, "Direction": "+Z"},
            ],
            "Impedance": [{"Attributes": [3], "Rs": 10.0, "Ls": 1e-9,
                           "Cs": 1e-12}],
            "Absorbing": {"Attributes": [4], "Order": 1},
            "SurfaceCurrent": [{"Index": 1, "Attributes": [6],
                                "Direction": "+X"}],
        },
        "Solver": {"Order": order, "Device": "CPU",
                   "Driven": {"MinFreq": 2.0, "MaxFreq": 4.0,
                              "FreqStep": 1.0},
                   "Linear": {"Type": linear, "Tol": 1e-10, "MaxIts": 200}},
    }
    path = os.path.join(directory, "case.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


_OPS = {}


def _operators(tmp_path_factory, order):
    """(port SpaceOperator, palace_tpu SpaceOperator) of the rich case."""
    if order not in _OPS:
        path = _rich_case(str(tmp_path_factory.mktemp(f"rich{order}")), order)
        io_t, io_j = TorchIoData(path), IoData(path)
        _OPS[order] = (SpaceOperator(io_t, torch_prepare_mesh(io_t)),
                       JaxSpaceOperator(io_j, prepare_mesh(io_j)))
    return _OPS[order]


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("what", ["K", "C", "M", "rhs1", "ports", "terms",
                                  "ess"])
def test_space_operator_matches_jax(tmp_path_factory, order, what):
    t, j = _operators(tmp_path_factory, order)
    if what == "K":
        assert _rel(t.stiffness_csr(), j.stiffness_csr()) < 1e-14
    elif what == "C":
        assert _rel(t.damping_csr(), j.damping_csr()) < 1e-14
    elif what == "M":
        assert _rel(t.mass_csr(), j.mass_csr()) < 1e-14
    elif what == "rhs1":
        assert t.excitations() == j.excitations()
        assert _rel(t.rhs1(1), j.rhs1(1)) < 1e-14
    elif what == "ports":
        for idx in (1, 2):
            for a, b in zip(t.port_functionals(idx), j.port_functionals(idx)):
                assert _rel(a, b) < 1e-14
    elif what == "terms":
        w = 0.7  # nondimensional angular frequency
        tt, jt = t.driven_terms([w]), j.driven_terms([w])
        assert [x.name for x in tt] == [x.name for x in jt]
        n = t.space.num_dofs
        for a, b in zip(tt, jt):
            assert a.coef(w) == b.coef(w)
            assert a.smoothing_coef(w) == b.smoothing_coef(w)
            assert _rel(a.csr(n), b.csr(n)) < 1e-14
    else:
        assert np.array_equal(t.ess_mask, j.ess_mask)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_boundary_forms_match_jax(order):
    """Trace basis, facet mass matrices and facet right-hand sides (each
    package on its own mesh, space and trace)."""
    mesh, mesh_j = t_box_tet(2, 2, 2), box_tet(2, 2, 2)
    t_canonicalize(mesh)
    canonicalize_simplices(mesh_j)
    space, space_j = TorchNDSpace(mesh, order), NDSpace(mesh_j, order)
    tr = t_boundary_trace(mesh, [1, 3], 2 * order)
    tb = tbdr.nd_trace_basis(space, tr)
    tb_j = jbdr.nd_trace_basis(space_j,
                               boundary_trace(mesh_j, [1, 3], 2 * order))
    assert np.array_equal(tb.dofs, tb_j.dofs)
    assert _rel(tb.V, tb_j.V) < 1e-14 and _rel(tb.Vt, tb_j.Vt) < 1e-14
    rng = np.random.default_rng(order)
    coef = 1.0 + rng.random(len(tr.elem))
    A, A_j = (tbdr.boundary_mass_bucket(tb, coef).A,
              jbdr.boundary_mass_bucket(tb_j, coef).A)
    assert _rel(A, A_j) < 1e-14
    f = rng.standard_normal(tr.normal.shape)
    assert _rel(tbdr.boundary_rhs(tb, f, space.num_dofs),
                jbdr.boundary_rhs(tb_j, f, space.num_dofs)) < 1e-14


@pytest.mark.parametrize("jac", [False, True])
@pytest.mark.parametrize("geom", [Geom.TRI, Geom.QUAD, Geom.TET, Geom.HEX,
                                  Geom.PRISM])
def test_default_qorder_matches_jax(jac, geom):
    saved = [(c, c.jac, c.extra) for c in (tops.QuadraturePolicy,
                                           jops.QuadraturePolicy)]
    try:
        for c in (tops.QuadraturePolicy, jops.QuadraturePolicy):
            c.set(jac, 1 if jac else 0)
        for p in (1, 2, 3):
            for g in (1, 2, 3):
                assert tops.default_qorder(p, g, TorchGeom[geom.name]) == \
                    jops.default_qorder(p, g, geom)
    finally:
        for c, j, e in saved:
            c.set(j, e)


@pytest.mark.parametrize("driven", [
    {"MinFreq": 2.0, "MaxFreq": 5.5, "FreqStep": 0.5},
    {"Samples": [{"Type": "Linear", "MinFreq": 1.0, "MaxFreq": 2.0,
                  "NSample": 5}, {"Type": "Point", "Freq": [1.5, 7.0]}]},
    {"Samples": [{"Type": "Log", "MinFreq": 0.1, "MaxFreq": 10.0,
                  "NSample": 7}, {"Freq": 3.3}],
     "MinFreq": 2.0, "MaxFreq": 4.0, "FreqStep": 1.0},
])
def test_driven_samples_match_jax(tmp_path, driven):
    path = _rich_case(str(tmp_path), 1)
    with open(path) as f:
        cfg = json.load(f)
    cfg["Solver"]["Driven"] = driven
    with open(path, "w") as f:
        json.dump(cfg, f)
    assert driven_samples_ghz(TorchIoData(path)) == jax_samples(IoData(path))


@pytest.mark.parametrize("with_energies", [False, True])
def test_error_indicator_table_matches_jax(tmp_path, with_energies):
    rng = np.random.default_rng(int(with_energies))
    eta2 = [rng.random(20) for _ in range(3)]
    energies = [1.0, 0.5, 2.0] if with_energies else None
    for d, fn in (("t", write_error_indicators),
                  ("j", jax_write_error_indicators)):
        os.makedirs(tmp_path / d)
        fn(str(tmp_path / d), eta2, energies)
    with open(tmp_path / "t" / "error-indicators.csv") as a, \
            open(tmp_path / "j" / "error-indicators.csv") as b:
        assert a.read() == b.read()


def test_jacobi_cg_solves_mass_system():
    mesh = t_box_tet(2, 2, 2)
    t_canonicalize(mesh)
    space = TorchNDSpace(mesh, 2)
    M = nd_operator(space, mass_coef={1: np.eye(3)})
    b = np.random.default_rng(0).standard_normal(space.num_dofs)
    res = cg(M, torch.as_tensor(b), M=jacobi(M.diagonal()), tol=1e-10)
    assert res.converged and 0 < res.iterations < 200
    assert res.relres <= 1e-10
    x_direct = np.linalg.solve(M.assemble_csr().toarray(), b)
    assert _rel(res.x.numpy(), x_direct) < 1e-9


def test_direct_sweep_tables_match_jax(tmp_path):
    """The whole driven run on the sparse-direct path (SuperLU): every CSV
    the run writes (port S/V/I, domain energies, probes, indicators)."""
    posts = {}
    for tag, run in (("torch", palace_torch.run), ("jax", jax_api.run)):
        path = _rich_case(str(tmp_path / tag), 1, linear="SuperLU")
        run(path)
        posts[tag] = os.path.join(os.path.dirname(path), "postpro")
    for name in TABLES:
        with open(os.path.join(posts["torch"], name)) as a, \
                open(os.path.join(posts["jax"], name)) as b:
            assert a.readline() == b.readline(), name
        t = np.atleast_2d(np.loadtxt(os.path.join(posts["torch"], name),
                                     delimiter=",", skiprows=1))
        j = np.atleast_2d(np.loadtxt(os.path.join(posts["jax"], name),
                                     delimiter=",", skiprows=1))
        assert t.shape == j.shape and np.isfinite(t).all(), name
        for c in range(j.shape[1]):
            scale = np.abs(j[:, c]).max()
            assert np.abs(t[:, c] - j[:, c]).max() <= 1e-10 * scale, name
