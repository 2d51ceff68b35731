"""The damped (quadratic) eigenmode branch of palace_torch against
palace_tpu on the CPU.

- `SpaceOperator.aux_bdr_attrs` equal, and `damping_csr` within 1e-13
  relative, for each damping source: domain conductivity, a lumped port's
  R, an impedance Rs and a first-order absorbing boundary.
- The two cases of tests/test_eigen_quadratic.py through both packages
  (the conductive box_tet 4^3, Order 2 cavity; the near-PEC impedance box
  at 3^3, Order 1): eig.csv Re f within 1e-8 and Im f within 1e-6
  relative, the conductive cavity's damping within 2e-3 of the analytic
  one; the route (JD, the strong-damping seed) in the provenance.
- The companion ARPACK route, forced by a JD that returns None or by a
  seed whose ARPACK does not converge, against palace_tpu's result on the
  same route.
- Any other exception inside the JD path propagates (palace_tpu falls
  back quietly; ROADMAP §3)."""

import json
import math
import os

import numpy as np
import pytest
from scipy.sparse.linalg import ArpackNoConvergence

import palace_torch
from palace_torch.config import IoData
from palace_torch.drivers import eigenmode as teigen
from palace_torch.drivers.common import prepare_mesh
from palace_torch.mesh import gmsh_write
from palace_torch.mesh.generate import box_tet
from palace_torch.models.spaceoperator import SpaceOperator
from palace_tpu import api as jax_api
from palace_tpu.config import IoData as JaxIoData
from palace_tpu.drivers.common import prepare_mesh as jax_prepare_mesh
from palace_tpu.linalg import eig as jeig
from palace_tpu.models.spaceoperator import SpaceOperator as JaxSpaceOperator

C0, EPS0 = 299792458.0, 8.8541878188e-12


def _write(tmp_path, mesh, boundaries, material=None, order=1, n=2,
           target=19.0, tol=1e-9):
    gmsh_write.write(mesh, str(tmp_path / "box.msh"))
    cfg = {
        "Problem": {"Type": "Eigenmode", "Verbose": 0, "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [dict({"Attributes": [1],
                                        "Permeability": 1.0,
                                        "Permittivity": 1.0},
                                       **(material or {}))]},
        "Boundaries": boundaries,
        "Solver": {"Order": order, "Device": "CPU",
                   "Eigenmode": {"N": n, "Target": target, "Tol": tol},
                   "Linear": {"Tol": 1e-10}},
    }
    path = tmp_path / "case.json"
    path.write_text(json.dumps(cfg))
    return str(path)


_SOURCES = {
    "conductivity": ({"PEC": {"Attributes": [1, 2, 3, 4, 5, 6]}},
                     {"Conductivity": 0.05}),
    "lumped_R": ({"PEC": {"Attributes": [3, 4, 5, 6]},
                  "LumpedPort": [{"Index": 1, "Attributes": [1], "R": 50.0,
                                  "Direction": "+Y"}]}, None),
    "impedance": ({"PEC": {"Attributes": [2, 3, 4, 5, 6]},
                   "Impedance": [{"Attributes": [1], "Rs": 0.02,
                                  "Ls": 1e-9}]}, None),
    "absorbing": ({"PEC": {"Attributes": [2, 3, 4, 5, 6]},
                   "Absorbing": {"Attributes": [1], "Order": 1}}, None),
}


@pytest.mark.parametrize("source", sorted(_SOURCES))
def test_aux_attrs_and_damping_match_jax(tmp_path, source):
    bdr, material = _SOURCES[source]
    path = _write(tmp_path, box_tet(2, 2, 2, lx=10.0, ly=10.0, lz=10.0),
                  bdr, material)
    io_t, io_j = IoData(path), JaxIoData(path)
    sop_t = SpaceOperator(io_t, prepare_mesh(io_t))
    sop_j = JaxSpaceOperator(io_j, jax_prepare_mesh(io_j))
    assert sop_t.aux_bdr_attrs() == sop_j.aux_bdr_attrs()
    assert 1 in sop_t.aux_bdr_attrs() or source == "conductivity"
    Ct, Cj = sop_t.damping_csr(), sop_j.damping_csr()
    assert Ct is not None and Ct.shape == Cj.shape
    scale = abs(Cj).max()
    assert scale > 0 and abs(Ct - Cj).max() <= 1e-13 * scale


def _eig(post):
    return np.atleast_2d(np.loadtxt(os.path.join(post, "eig.csv"),
                                    delimiter=",", skiprows=1))


def _same_eig(post_t, post_j):
    et, ej = _eig(post_t), _eig(post_j)
    assert et.shape == ej.shape and np.isfinite(et).all()
    assert (np.abs(et[:, 1] - ej[:, 1]) / np.abs(ej[:, 1])).max() <= 1e-8
    assert (np.abs(et[:, 2] - ej[:, 2]) / np.abs(ej[:, 2])).max() <= 1e-6
    return et


def _run_both(tmp_path, path):
    res = palace_torch.run(path, str(tmp_path / "torch"))
    jax_api.run(path, output_dir=str(tmp_path / "jax"))
    return res, _same_eig(str(tmp_path / "torch"), str(tmp_path / "jax"))


def _conductive_cavity(tmp_path, n=4, order=2):
    """tests/test_eigen_quadratic.py:18 (eps_r 2, sigma 0.05 S/m, a 10 mm
    PEC cube)."""
    return _write(tmp_path, box_tet(n, n, n, lx=10.0, ly=10.0, lz=10.0),
                  {"PEC": {"Attributes": [1, 2, 3, 4, 5, 6]}},
                  {"Permittivity": 2.0, "Conductivity": 0.05}, order=order,
                  n=3, target=14.0, tol=1e-10)


def test_conductive_cavity_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PALACE_TPU_MULTICHIP", "0")
    res, eig = _run_both(tmp_path, _conductive_cavity(tmp_path))
    prov = res["provenance"]
    assert prov["eigen_path"] == "quadratic-jd"
    assert prov["jd_attempts"] == 1 and prov["divfree"].startswith("built")
    # lam^2 eps + lam sigma + eps omega0^2 = 0 for each lossless mode.
    omega0 = math.pi * math.sqrt(2) * C0 / 10e-3 / math.sqrt(2.0)
    s = 0.05 / (EPS0 * 2.0)
    f = complex(math.sqrt(omega0 ** 2 - 0.25 * s ** 2), 0.5 * s) / (
        2 * math.pi) / 1e9
    assert eig[0, 1] == pytest.approx(f.real, rel=2e-3)
    assert eig[0, 2] == pytest.approx(f.imag, rel=2e-3)


def test_impedance_nearpec_box_matches_jax(tmp_path, monkeypatch):
    """tests/test_eigen_quadratic.py:54: near-PEC resistive walls (Rs 0.02
    Ohm on all six faces), where the PEC-seeded second seed engages."""
    monkeypatch.setenv("PALACE_TPU_MULTICHIP", "0")
    path = _write(tmp_path, box_tet(3, 3, 3, lx=10.0, ly=10.0, lz=10.0),
                  {"Impedance": [{"Attributes": [1, 2, 3, 4, 5, 6],
                                  "Rs": 0.02}]})
    res, _ = _run_both(tmp_path, path)
    prov = res["provenance"]
    assert prov["eigen_path"] == "quadratic-jd" and prov["jd_strong_seed"]
    assert np.asarray(res["backward_errors"]).max() <= 1e-9


def _no_jd(*args, **kwargs):
    return None


def _seed_fails(*args, **kwargs):
    raise ArpackNoConvergence("no convergence (test)", np.zeros(0),
                              np.zeros((0, 0)))


@pytest.mark.parametrize("route", ["jd_none", "seed_no_convergence"])
def test_forced_arpack_route_matches_jax(tmp_path, monkeypatch, route):
    """With the JD fast path unavailable both packages take the companion
    ARPACK iteration `quadratic_eigs` (deterministic start vector)."""
    monkeypatch.setenv("PALACE_TPU_MULTICHIP", "0")
    monkeypatch.setattr(jeig, "quadratic_eigs_jd", _no_jd)
    if route == "jd_none":
        monkeypatch.setattr(teigen, "quadratic_eigs_jd", _no_jd)
    else:
        monkeypatch.setattr(teigen, "shift_invert_eigs", _seed_fails)
    res, _ = _run_both(tmp_path, _conductive_cavity(tmp_path, 3, 1))
    prov = res["provenance"]
    assert prov["eigen_path"] == "quadratic-arpack"
    assert prov["jd_attempts"] == 1


def test_jd_exception_propagates(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise ValueError("injected JD fault")

    monkeypatch.setattr(teigen, "quadratic_eigs_jd", boom)
    with pytest.raises(ValueError, match="injected JD fault"):
        palace_torch.run(_conductive_cavity(tmp_path, 3, 1),
                         str(tmp_path / "torch"))
