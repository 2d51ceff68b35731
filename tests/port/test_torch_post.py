"""The surface, far-field and ParaView outputs of palace_torch against
palace_tpu on the CPU.

- On seeded complex fields over the same TEM-line mesh (box_tet 3 x 2 x 2
  over 10 mm, Order 2), vacuum and eps_r 2: `surface_flux` (Electric,
  Magnetic, Power; one- and two-sided), `interface_energy` (MA, MS, SA,
  Default), `stratton_chu` (real and complex omega) and
  `nodal_average_nd` (value and curl) within 1e-12 of palace_tpu's, and
  `write_vtu` / `write_pvd` byte for byte on the same arrays.
- End to end against `palace_tpu.run`: the driven TEM line (box_tet 4 x 3
  x 3, Order 2, 15 GHz) with SurfaceFlux, Dielectric and ParaView output
  at its frequency; the short dipole in its ABC2 box (box_tet 4^3, Order
  2, the sparse-direct path) with its FarField; the copper-walled cavity
  (4 x 2 x 5 hexes, Order 2, the damped branch) with SurfaceFlux,
  Dielectric, FarField at the complex omega and ParaView mode output.
  Tables within 1e-12 of each column's maximum; the VTU files' arrays to
  the 10 digits they are written with (5e-10 of each array's maximum).
- The adaptive PROM sweep writes its online fields at `Save`."""

import json
import os
import re

import numpy as np
import pytest

import palace_torch
from palace_torch.cases import (write_cavity_case, write_dipole_case,
                                write_tem_line_case)
from palace_torch.config import IoData
from palace_torch.drivers import driven as tdriven
from palace_torch.drivers.common import prepare_mesh
from palace_torch.models.spaceoperator import SpaceOperator
from palace_torch.post import farfield as tff
from palace_torch.post import paraview as tpv
from palace_torch.post import surfaces as tsurf
from palace_tpu.config import IoData as JaxIoData
from palace_tpu.drivers import driven as jdriven
from palace_tpu.drivers.common import prepare_mesh as jax_prepare_mesh
from palace_tpu.models.spaceoperator import SpaceOperator as JaxSpaceOperator
from palace_tpu.post import farfield as jff
from palace_tpu.post import paraview as jpv
from palace_tpu.post import surfaces as jsurf

POST = {
    "SurfaceFlux": [
        {"Index": 1, "Attributes": [1], "Type": "Electric"},
        {"Index": 2, "Attributes": [2], "Type": "Magnetic",
         "Center": [20.0, 5.0, 5.0]},
        {"Index": 3, "Attributes": [2], "Type": "Power"},
        {"Index": 4, "Attributes": [3], "Type": "Electric", "TwoSided": True}],
    "Dielectric": [
        {"Index": i + 1, "Attributes": [3, 4], "Type": t, "Thickness": 0.01,
         "Permittivity": 10.0, "LossTan": 0.01}
        for i, t in enumerate(("MA", "MS", "SA", "Default"))],
    "FarField": {"Attributes": [1, 2, 3, 4], "NSample": 6,
                 "ThetaPhis": [[30.0, 45.0]]},
}


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module", params=[1.0, 2.0], ids=["vacuum", "eps2"])
def pair(request, tmp_path_factory):
    """Both packages' SpaceOperator of the 3 x 2 x 2 line filled with eps_r
    = param, and a seeded complex ND field."""
    d = str(tmp_path_factory.mktemp("post"))
    cfg = write_tem_line_case(d, 10.0, 3, 2, 2, problem="Driven",
                              postprocessing=POST, device="CPU", verbose=0)
    with open(cfg) as f:
        data = json.load(f)
    data["Domains"]["Materials"][0]["Permittivity"] = request.param
    with open(cfg, "w") as f:
        json.dump(data, f)
    tio, jio = IoData(cfg), JaxIoData(cfg)
    tsop = SpaceOperator(tio, prepare_mesh(tio))
    jsop = JaxSpaceOperator(jio, jax_prepare_mesh(jio))
    n = tsop.space.num_dofs
    assert jsop.space.num_dofs == n
    rng = np.random.default_rng(11)
    E = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return tio, tsop, jio, jsop, E


def test_surface_flux_matches_jax(pair):
    tio, tsop, jio, jsop, E = pair
    ttr = tdriven.build_surface_traces(tio, tsop)
    jtr = jdriven.build_surface_traces(jio, jsop)
    for tf, jf in zip(tio.boundaries.surface_fluxes,
                      jio.boundaries.surface_fluxes):
        for kw in (dict(omega=2.3), dict(aB=np.real(E).copy())):
            x = np.real(E).copy() if "aB" in kw else E
            got = tsurf.surface_flux(tsop, tf, ttr["flux"][tf.index], x,
                                     **kw)
            want = jsurf.surface_flux(jsop, jf, jtr["flux"][jf.index], x,
                                      **kw)
            assert abs(want) > 0
            assert abs(got - want) <= 1e-12 * abs(want), (tf.type, kw)


def test_interface_energy_matches_jax(pair):
    tio, tsop, jio, jsop, E = pair
    ttr = tdriven.build_surface_traces(tio, tsop)
    jtr = jdriven.build_surface_traces(jio, jsop)
    nonzero = 0
    for d in tio.boundaries.dielectrics:
        class D:
            type = d.type
            thickness = d.thickness / tio.units.mesh_length_scale
            permittivity = d.permittivity

        got = tsurf.interface_energy(tsop, D, ttr["eps"][d.index], E)
        want = jsurf.interface_energy(jsop, D, jtr["eps"][d.index], E)
        assert abs(got - want) <= 1e-12 * max(abs(want), 1e-300), d.type
        nonzero += want > 0
    # Vacuum: MA, SA, Default; eps_r 2: MS, Default.
    assert nonzero >= 2


@pytest.mark.parametrize("omega", [2.3, 2.3 + 0.04j], ids=["real", "complex"])
def test_stratton_chu_matches_jax(pair, omega):
    tio, tsop, jio, jsop, E = pair
    ttb, tgrid = tdriven.build_farfield(tio, tsop)
    jtb, jgrid = jdriven.build_farfield(jio, jsop)
    np.testing.assert_array_equal(tgrid, jgrid)
    assert len(tgrid) == 7
    got = tff.stratton_chu(tsop, ttb, E, omega, tgrid)
    want = jff.stratton_chu(jsop, jtb, E, omega, jgrid)
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("which", ["value", "curl"])
def test_nodal_average_matches_jax(pair, which):
    _, tsop, _, jsop, E = pair
    got = tpv.nodal_average_nd(tsop.space, np.real(E).copy(), which)
    want = jpv.nodal_average_nd(jsop.space, np.real(E).copy(), which)
    assert got.shape == (tsop.mesh.num_nodes, 3)
    assert _rel(got, want) <= 1e-12


def test_vtu_bytes_match_jax(pair, tmp_path):
    _, tsop, _, jsop, E = pair
    fields = {"E_real": tpv.nodal_average_nd(tsop.space, np.real(E).copy()),
              "B_real": tpv.nodal_average_nd(tsop.space, np.real(E).copy(),
                                             "curl"),
              "scalar": np.linalg.norm(np.imag(E)[:tsop.mesh.num_nodes, None],
                                       axis=1)}
    for mod, sop, tag in ((tpv, tsop, "t"), (jpv, jsop, "j")):
        saver = mod.ParaviewSaver(str(tmp_path / tag), "driven", sop.mesh)
        saver.save(15.0, fields)
        saver.save(16.0, fields)
        saver.finalize()
    for name in ("driven_0000.vtu", "driven_0001.vtu", "driven.pvd"):
        a = (tmp_path / "t" / "paraview" / "driven" / name).read_bytes()
        b = (tmp_path / "j" / "paraview" / "driven" / name).read_bytes()
        assert len(a) > 0 and a == b, name


# ---------------------------------------------------------------------------
# End to end


def _table(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def _col_rel(a, b) -> float:
    scale = np.abs(b).max(axis=0)
    return float((np.abs(a - b).max(axis=0)
                  / np.where(scale > 0, scale, 1.0)).max())


def vtu_arrays(path):
    """{Name: array} of a VTU file's point-data arrays (and "Points")."""
    with open(path) as f:
        text = f.read()
    out = {}
    for m in re.finditer(r'<DataArray type="Float64" (?:Name="([^"]+)" )?'
                         r'NumberOfComponents="(\d)" format="ascii">\n'
                         r'(.*?)</DataArray>', text, re.S):
        vals = np.array(m.group(3).split(), float)
        out[m.group(1) or "Points"] = vals.reshape(-1, int(m.group(2)))
    return out


def _jax_run(cfg, out_dir):
    from threadpoolctl import threadpool_limits

    from palace_tpu import api as jax_api

    old = os.environ.get("PALACE_TPU_MULTICHIP")
    os.environ["PALACE_TPU_MULTICHIP"] = "0"
    try:
        with threadpool_limits(limits=1, user_api="blas"):
            return jax_api.run(cfg, output_dir=out_dir)
    finally:
        if old is None:
            os.environ.pop("PALACE_TPU_MULTICHIP", None)
        else:
            os.environ["PALACE_TPU_MULTICHIP"] = old


def _compare(tmp_path, cfg, tables, vtus):
    res = palace_torch.run(cfg, output_dir=str(tmp_path / "t"))
    _jax_run(cfg, str(tmp_path / "j"))
    for name in tables:
        a, b = _table(tmp_path / "t" / name), _table(tmp_path / "j" / name)
        assert a.shape == b.shape and np.abs(b).max() > 0, name
        assert _col_rel(a, b) <= 1e-12, name
    for name in vtus:
        a = vtu_arrays(tmp_path / "t" / "paraview" / name)
        b = vtu_arrays(tmp_path / "j" / "paraview" / name)
        assert sorted(a) == sorted(b) and "Points" in a
        for key in b:
            assert a[key].shape == b[key].shape, (name, key)
            assert _rel(a[key], b[key]) <= 5e-10, (name, key)
    return res


def test_driven_outputs_match_jax(tmp_path):
    post = {"SurfaceFlux": [{"Index": 1, "Attributes": [2],
                             "Type": "Power"},
                            {"Index": 2, "Attributes": [1],
                             "Type": "Electric"}],
            "Dielectric": [{"Index": 1, "Attributes": [2],
                            "Type": "Default", "Thickness": 0.01,
                            "Permittivity": 10.0, "LossTan": 0.01}]}
    cfg = write_tem_line_case(str(tmp_path), 10.0, 4, 3, 2, problem="Driven",
                              postprocessing=post, save_freqs=[15.0],
                              device="CPU", verbose=0)
    res = _compare(tmp_path, cfg, ["surface-F.csv", "surface-Q.csv"],
                   ["driven/driven_0000.vtu"])
    m = res["measurements"][(1, 0)]
    p, Q = m.surf_q[1]
    assert Q == pytest.approx(1.0 / (0.01 * p), rel=1e-9)
    arrays = vtu_arrays(tmp_path / "t" / "paraview" / "driven" /
                        "driven_0000.vtu")
    assert sorted(arrays) == ["B_imag", "B_real", "E_imag", "E_real",
                              "Points"]
    assert all(v.shape == (res["sop"].mesh.num_nodes, 3)
               for v in arrays.values())


def test_dipole_farfield_matches_jax(tmp_path):
    cfg = write_dipole_case(str(tmp_path), 4, 2, device="CPU", verbose=0)
    res = _compare(tmp_path, cfg, ["farfield-rE.csv"], [])
    assert res["provenance"]["solver_path"] == "direct"
    assert res["measurements"][(1, 0)].farfield.shape == (3, 3)


def test_eigen_outputs_match_jax(tmp_path):
    cfg = write_cavity_case(str(tmp_path), 4, 2, 5, 2, device="CPU",
                            verbose=0)
    with open(cfg) as f:
        data = json.load(f)
    data["Boundaries"]["Postprocessing"] = {
        "SurfaceFlux": [{"Index": 1, "Attributes": [5], "Type": "Electric"},
                        {"Index": 2, "Attributes": [6], "Type": "Power"}],
        "Dielectric": [{"Index": 1, "Attributes": [1, 2, 3, 4],
                        "Type": "MA", "Thickness": 0.002,
                        "Permittivity": 10.0, "LossTan": 0.001}],
        "FarField": {"Attributes": [5], "NSample": 4}}
    data["Solver"]["Eigenmode"]["Save"] = 1
    with open(cfg, "w") as f:
        json.dump(data, f)
    res = _compare(tmp_path, cfg, ["eig.csv", "surface-F.csv",
                                   "surface-Q.csv", "farfield-rE.csv"],
                   ["eigenmode/eigenmode_0000.vtu"])
    assert res["provenance"]["eigen_path"] == "quadratic-jd"
    assert not os.path.exists(tmp_path / "t" / "paraview" / "eigenmode" /
                              "eigenmode_0001.vtu")


def test_adaptive_sweep_writes_paraview(tmp_path):
    """ParaView output at `Save` frequencies on the adaptive PROM path: the
    VTU fields are the PROM's online fields averaged at the nodes."""
    from palace_torch.cases import write_adaptive_case

    cfg = write_adaptive_case(str(tmp_path), 2, 1, device="CPU", verbose=0)
    with open(cfg) as f:
        data = json.load(f)
    data["Solver"]["Driven"]["Save"] = [3.0, 6.2]
    with open(cfg, "w") as f:
        json.dump(data, f)
    res = palace_torch.run(cfg)
    assert res["provenance"]["solver_path"] == "prom-adaptive"
    pv = os.path.join(res["post_dir"], "paraview", "driven")
    assert sorted(os.listdir(pv)) == ["driven.pvd", "driven_0000.vtu",
                                      "driven_0001.vtu"]
    i = int(np.argmin(np.abs(np.asarray(res["freqs_ghz"]) - 6.2)))
    E = res["solutions"][(1, i)]
    want = tpv.nodal_average_nd(res["sop"].space, np.real(E).copy())
    got = vtu_arrays(os.path.join(pv, "driven_0001.vtu"))["E_real"]
    assert np.abs(want).max() > 0 and _rel(got, want) <= 5e-10
