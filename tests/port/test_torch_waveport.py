"""Wave ports of the port (palace_torch/models/waveport.py and the wave-port
parts of SpaceOperator and the driven drivers) against palace_tpu's, on the
CPU.

Two port geometries, both with ports on attributes 1 and 2 and EigenTol
1e-12: "te10", the box_hex(5, 4, 3) guide of tests/test_prom_waveport.py
(quad port facets, TE10 above its 15 GHz cutoff), and "tem", the box_tet
parallel-plate line of tests/test_driven_transient.py:185 (triangle
facets, kn = omega).

- The 2D forms of the port cross-section (`nd_operator` mass and scalar
  curl, `h1_operator` diffusion and mass, the mixed gradient form and
  `nd_h1_gradient`), also with anisotropic tensors: 1e-12 of the largest
  entry.
- The mode: kn and the normalized fields (et, en, n x H at the trace
  points) at 1e-8; ARPACK starts from a random vector, so raw
  eigenvectors are not compared; en, round-off for these TE and TEM
  modes, is held on the scale of et.  The phase reference is the quadrant
  functional (not its degenerate fallback) and the gradient deflation ran.
- The coupling: `waveport_a2_csr`, `waveport_rhs2` and `waveport_sparam`
  at 1e-12.
- The uniform sweep's port-S.csv (sparse direct, "te10") at 1e-8, the
  port's device solver (GMG, element fine level) against its direct path
  at 1e-8, the adaptive sweep against the uniform one at 5e-6 (the tolerance of
  tests/test_prom_waveport.py), and the "tem" line ended by wave port 2
  with a VoltagePath: port-S.csv, port-V.csv and port-Z.csv at 1e-8 and
  the matched line's physics.
"""

import json
import math
import os

import numpy as np
import pytest

import palace_torch
from palace_tpu.config import IoData as JaxIoData
from palace_tpu.config import ValueType as JaxValueType
from palace_tpu.drivers import driven as jdriven
from palace_tpu.drivers.common import prepare_mesh as jax_prepare_mesh
from palace_tpu.fem.h1 import H1Space as JaxH1Space
from palace_tpu.fem.nd import NDSpace as JaxNDSpace
from palace_tpu.fem.nd_operators import nd_operator as jax_nd_operator
from palace_tpu.fem.operators import h1_operator as jax_h1_operator
from palace_tpu.models.spaceoperator import SpaceOperator as JaxSpaceOperator
from palace_torch.config import IoData, ValueType
from palace_torch.drivers import driven
from palace_torch.drivers.common import prepare_mesh
from palace_torch.fem.h1 import H1Space
from palace_torch.fem.nd import NDSpace
from palace_torch.fem.nd_operators import nd_operator
from palace_torch.fem.operators import h1_operator
from palace_torch.mesh import gmsh_write
from palace_torch.mesh.generate import box_hex, box_tet
from palace_torch.models.spaceoperator import SpaceOperator
from palace_torch.utils import provenance

ETA0 = 376.730313412


def _rel(a, b) -> float:
    """max |a - b| / max |b| for arrays or sparse matrices."""
    if hasattr(a, "tocsr"):  # sparse: no dense copy
        return float(abs(a - b).max() / max(abs(b).max(), 1e-300))
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def write_case(directory, case: str, **solver) -> str:
    """case.json of the "te10" guide or the "tem" line in `directory`."""
    os.makedirs(directory, exist_ok=True)
    if case == "te10":
        mesh = box_hex(5, 4, 3, lx=20.0, ly=10.0, lz=6.0)
        pec = [3, 4, 5, 6]
        driven_cfg = {"Samples": [{"Type": "Linear", "MinFreq": 17.0,
                                   "MaxFreq": 28.0, "NSample": 12}]}
    else:
        mesh = box_tet(6, 6, 6, lx=10.0, ly=10.0, lz=10.0)
        pec = [5, 6]
        driven_cfg = {"Samples": [{"Type": "Point", "Freq": [15.0]}]}
    gmsh_write.write(mesh, os.path.join(directory, "m.msh"))
    cfg = {
        "Problem": {"Type": "Driven", "Verbose": 0, "Output": "postpro"},
        "Model": {"Mesh": "m.msh", "L0": 1e-3},
        "Domains": {"Materials": [{"Attributes": [1], "Permittivity": 1.0,
                                   "Permeability": 1.0}]},
        "Boundaries": {
            "PEC": {"Attributes": pec},
            "WavePort": [
                {"Index": 1, "Attributes": [1], "Excitation": True,
                 "EigenTol": 1e-12},
                {"Index": 2, "Attributes": [2], "EigenTol": 1e-12}]},
        "Solver": dict({"Order": 2, "Device": "CPU", "Driven": driven_cfg,
                        "Linear": {"Type": "SuperLU", "Tol": 1e-10,
                                   "MaxIts": 300}}, **solver),
    }
    path = os.path.join(directory, "case.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _omegas(iodata):
    fs = iodata.units.scale_factor(ValueType.FREQUENCY)
    return [2 * math.pi * f / fs for f in driven.driven_samples_ghz(iodata)]


def _operators(path):
    """(port SpaceOperator, palace_tpu SpaceOperator, omegas)."""
    io = IoData(path)
    sop = SpaceOperator(io, prepare_mesh(io))
    jio = JaxIoData(path)
    jsop = JaxSpaceOperator(jio, jax_prepare_mesh(jio))
    return sop, jsop, _omegas(io)


@pytest.fixture(scope="module", params=["te10", "tem"])
def pair(request, tmp_path_factory):
    provenance.reset()
    path = write_case(str(tmp_path_factory.mktemp(request.param)),
                      request.param)
    sop, jsop, omegas = _operators(path)
    return request.param, sop, jsop, omegas, provenance.snapshot()


def test_port_cross_section_forms_match_jax(pair):
    _, sop, jsop, _, _ = pair
    for idx in (1, 2):
        wp, jwp = sop.wave_ports[idx], jsop.wave_ports[idx]
        assert wp.nd.num_dofs == jwp.nd.num_dofs
        assert wp.h1.num_dofs == jwp.h1.num_dofs
        np.testing.assert_array_equal(wp.ess_nd, jwp.ess_nd)
        np.testing.assert_array_equal(wp.ess_h1, jwp.ess_h1)
        for name in ("_Btt", "_Ktt", "_Mtt", "_Atn", "_Knn", "_Mnn",
                     "_Gnd"):
            assert _rel(getattr(wp, name), getattr(jwp, name)) <= 1e-12, name


def test_2d_forms_with_anisotropic_tensors_match_jax(pair):
    """`nd_operator` (mass, scalar curl) and `h1_operator` (diffusion,
    mass) on the port submesh, with a full tensor per attribute."""
    _, sop, jsop, _, _ = pair
    mesh2, jmesh2 = sop.wave_ports[1].mesh2, jsop.wave_ports[1].mesh2
    T = np.array([[2.0, 0.3, 0.1], [0.3, 1.5, -0.2], [0.1, -0.2, 0.7]])
    coef = {int(a): T for a in np.unique(mesh2.buckets[0].attr)}
    for p in (1, 3):
        nd, jnd = NDSpace(mesh2, p), JaxNDSpace(jmesh2, p)
        h1, jh1 = H1Space(mesh2, p), JaxH1Space(jmesh2, p)
        pairs = [
            (nd_operator(nd, curl_coef=coef, mass_coef=coef),
             jax_nd_operator(jnd, curl_coef=coef, mass_coef=coef)),
            (h1_operator(h1, diffusion_coef=coef, mass_coef=coef),
             jax_h1_operator(jh1, diffusion_coef=coef, mass_coef=coef))]
        for op, jop in pairs:
            assert _rel(op.assemble_csr(), jop.assemble_csr()) <= 1e-12


def test_mode_matches_jax(pair):
    case, sop, jsop, omegas, prov = pair
    assert prov["waveport1_deflation"] and prov["waveport2_deflation"]
    for idx in (1, 2):
        wp, jwp = sop.wave_ports[idx], jsop.wave_ports[idx]
        for om in omegas[:3]:
            sol, jsol = wp.solve_mode(om), jwp.solve_mode(om)
            assert sol.phase == "quadrant"
            assert abs(sol.kn - jsol.kn) <= 1e-8 * abs(jsol.kn)
            if case == "tem":
                assert abs(sol.kn - om) <= 1e-8 * om
            assert _rel(sol.et, jsol.et) <= 1e-8
            # TE and TEM modes have no normal field: en is round-off, held
            # on the scale of et.
            assert np.abs(sol.en - jsol.en).max() <= 1e-8 * max(
                np.abs(jsol.en).max(), np.abs(jsol.et).max())
            assert _rel(wp.nxh_field(sol, om), jwp.nxh_field(jsol, om)) \
                <= 1e-8
            assert wp.solve_mode(om) is sol  # the per-omega cache


def test_waveport_coupling_matches_jax(pair):
    _, sop, jsop, omegas, _ = pair
    rng = np.random.default_rng(5)
    n = sop.space.num_dofs
    E = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    for om in omegas[:2]:
        assert _rel(sop.waveport_a2_csr(om), jsop.waveport_a2_csr(om)) \
            <= 1e-12
        assert _rel(sop.waveport_rhs2(1, om), jsop.waveport_rhs2(1, om)) \
            <= 1e-12
        for idx in (1, 2):
            s, js = (sop.waveport_sparam(idx, E, om),
                     jsop.waveport_sparam(idx, E, om))
            assert abs(s - js) <= 1e-12 * abs(js)
    assert sop.excitations() == jsop.excitations() == {1: [1]}


def _jax_tables(path, out_dir):
    """palace_tpu's sparse-direct sweep, measurements and driven tables for
    the config at `path` (module functions; its `run` adds minutes of JIT
    to the CPU tests for the estimators)."""
    jio = JaxIoData(path)
    jsop = JaxSpaceOperator(jio, jax_prepare_mesh(jio))
    freqs = jdriven.driven_samples_ghz(jio)
    fs = jio.units.scale_factor(JaxValueType.FREQUENCY)
    omegas = [2 * math.pi * f / fs for f in freqs]
    exc = jsop.excitations()
    sols = jdriven.sweep_uniform_direct(jio, jsop, omegas, exc)
    meas = {k: jdriven.measure_step(jsop, E, omegas[k[1]], k[0],
                                    jsop.port_functionals)
            for k, E in sols.items()}
    os.makedirs(out_dir, exist_ok=True)
    jdriven.write_driven_tables(jio, jsop, out_dir, freqs, exc, meas)
    return meas


def _csv(path):
    with open(path) as f:
        header = f.readline()
    return header, np.atleast_2d(np.loadtxt(path, delimiter=",",
                                            skiprows=1))


def _same_table(a, b, tol):
    """Equal headers and every entry within `tol`, relative where its
    magnitude exceeds 1 (dB near 0 of |S21| ~ 1 amplifies round-off)."""
    ha, da = _csv(a)
    hb, db = _csv(b)
    assert ha == hb and da.shape == db.shape
    err = np.abs(da - db) / np.maximum(np.abs(db), 1.0)
    assert err.max() <= tol, (a, np.unravel_index(err.argmax(), err.shape))


def test_uniform_port_s_matches_jax(tmp_path):
    path = write_case(str(tmp_path), "te10")
    res = palace_torch.run(path, output_dir=str(tmp_path / "t"))
    assert res["provenance"]["solver_path"] == "direct"
    jmeas = _jax_tables(path, str(tmp_path / "j"))
    _same_table(str(tmp_path / "t" / "port-S.csv"),
                str(tmp_path / "j" / "port-S.csv"), 1e-8)
    for key, m in res["measurements"].items():
        for idx in (1, 2):
            assert abs(m.ports[idx].S - jmeas[key].ports[idx].S) <= 1e-8
    m = res["measurements"][(1, 0)]
    assert abs(abs(m.ports[2].S) - 1.0) <= 0.02 and abs(m.ports[1].S) < 0.05


def test_device_solver_matches_direct(tmp_path):
    """The port's FGMRES + p-MG on the CPU (element fine level, the wave
    port terms on every level) against its own sparse-direct sweep."""
    out = {}
    for lin in ("GMG", "SuperLU"):
        path = write_case(str(tmp_path / lin), "te10",
                          Linear={"Type": lin, "Tol": 1e-12, "MaxIts": 300},
                          Driven={"Samples": [{"Type": "Linear",
                                               "MinFreq": 17.0,
                                               "MaxFreq": 28.0,
                                               "NSample": 4}]})
        out[lin] = palace_torch.run(path)
    prov = out["GMG"]["provenance"]
    assert prov["solver_path"] == "device" and prov["fine_level"] == "element"
    assert max(out["GMG"]["ksp"]["col_relres"].values()) <= 1e-12
    _same_table(os.path.join(out["GMG"]["post_dir"], "port-S.csv"),
                os.path.join(out["SuperLU"]["post_dir"], "port-S.csv"), 1e-8)
    for key, m in out["GMG"]["measurements"].items():
        for idx in (1, 2):
            assert abs(m.ports[idx].S - out["SuperLU"]["measurements"][key]
                       .ports[idx].S) <= 1e-8


def test_adaptive_waveport_matches_uniform(tmp_path):
    """tests/test_prom_waveport.py through the port: the factored wave-port
    PROM (Mwp, Wr, Re kn per omega, projected RHS2) against the uniform
    sweep, S within 5e-6."""
    res = {}
    for tag, extra in (("u", {}), ("a", {"AdaptiveTol": 1e-8})):
        path = write_case(str(tmp_path / tag), "te10")
        with open(path) as f:
            cfg = json.load(f)
        cfg["Solver"]["Driven"].update(extra)
        cfg["Solver"]["Linear"]["Type"] = "Default"
        with open(path, "w") as f:
            json.dump(cfg, f)
        res[tag] = palace_torch.run(path)
    assert res["a"]["provenance"]["prom_hdm_path"] == "direct"
    for key, mu in res["u"]["measurements"].items():
        ma = res["a"]["measurements"][key]
        for idx in mu.ports:
            assert abs(ma.ports[idx].S - mu.ports[idx].S) <= 5e-6, (key, idx)
    m0 = res["a"]["measurements"][min(res["a"]["measurements"])]
    assert abs(m0.ports[2].S) == pytest.approx(1.0, abs=0.05)


def test_voltage_path_tables_match_jax(tmp_path):
    """The TEM line driven by lumped port 1 and ended by wave port 2 with a
    VoltagePath across the plates: port-V.csv (V_wp[2] columns), port-Z.csv
    and port-S.csv against palace_tpu's at 1e-8."""
    path = write_case(str(tmp_path), "tem")
    with open(path) as f:
        cfg = json.load(f)
    cfg["Boundaries"]["LumpedPort"] = [{"Index": 1, "Attributes": [1],
                                        "R": ETA0, "Direction": "+Z",
                                        "Excitation": True}]
    cfg["Boundaries"]["WavePort"] = [{"Index": 2, "Attributes": [2],
                                      "EigenTol": 1e-12,
                                      "VoltagePath": [[10.0, 5.0, 0.0],
                                                      [10.0, 5.0, 10.0]]}]
    with open(path, "w") as f:
        json.dump(cfg, f)
    res = palace_torch.run(path, output_dir=str(tmp_path / "t"))
    _jax_tables(path, str(tmp_path / "j"))
    for name in ("port-S.csv", "port-V.csv", "port-Z.csv"):
        _same_table(str(tmp_path / "t" / name), str(tmp_path / "j" / name),
                    1e-8)
    # The matched line (tests/test_driven_transient.py:185): |S21| ~ 1,
    # arg S21 = -k L, and V_wp at the far end has the magnitude of V_1.
    m = res["measurements"][(1, 0)]
    S21 = m.ports[2].S
    assert abs(abs(S21) - 1.0) <= 0.02 and abs(m.ports[1].S) < 0.05
    kL = 2 * math.pi * 15e9 / 299792458.0 * 10e-3
    phase = -math.atan2(S21.imag, S21.real) % (2 * math.pi)
    assert phase == pytest.approx(kL % (2 * math.pi), abs=0.05)
    assert abs(m.ports[2].V) == pytest.approx(abs(m.ports[1].V), rel=0.05)
