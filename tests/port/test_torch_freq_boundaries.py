"""The frequency-dependent boundaries of the port (finite-conductivity
surfaces and the second-order absorbing boundary: SpaceOperator's
`conductivity_a2_csr`, `abc2_a2_csr` and their device-solver terms, the
driven sweeps' A2 extras and the PROM's slow path) against palace_tpu's, on
the CPU.

- "slow_a2": the TEM line of tests/test_driven_transient.py:120 with
  copper plates (Conductivity on 5 and 6) and a second-order Absorbing end
  (attribute 2), driven by lumped port 1, meshed 4^3 (that test's 6^3
  takes 1.7 s a SuperLU factorization on one thread here, 50 s for its
  adaptive sweep).  Its A2 CSRs at 1e-12 of the
  largest entry; the sum of its device-solver terms c_t(omega) X_t equals
  system_csr + A2(omega) (1e-12) and palace_tpu's sum (1e-12); its uniform
  port-S.csv at 1e-8; its adaptive sweep (every HDM solve sparse direct,
  provenance "direct-slow-a2") against the uniform one at 5e-6, the
  tolerance of tests/test_driven_transient.py:120.
- "wall": the conductive wall of tests/test_conductivity.py:24; port-S.csv
  at 1e-8 and that test's analytic reflection checks.
- The WR-90 guide of `write_waveguide_case`, shorted by copper or ended by
  the second-order absorbing boundary: the device solver (GMG, element
  fine level, the `conductivity0` / `abc2` term) against the direct path
  at 1e-8; and the copper short against the analytic TE10 reflection,
  1 - |S11| within 1% of 1 - |Gamma|, through both packages.
"""

import cmath
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
from palace_tpu.models.spaceoperator import SpaceOperator as JaxSpaceOperator
from palace_torch.cases import COPPER_SIGMA, WR90_A, write_waveguide_case
from palace_torch.config import IoData
from palace_torch.drivers.common import prepare_mesh
from palace_torch.mesh import gmsh_write
from palace_torch.mesh.generate import box_tet
from palace_torch.models.spaceoperator import SpaceOperator

ETA0 = 376.730313412
MU0 = 1.25663706127e-6
C0 = 299792458.0


def _rel(a, b) -> float:
    if hasattr(a, "tocsr"):  # sparse: no dense copy
        return float(abs(a - b).max() / max(abs(b).max(), 1e-300))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def write_case(directory, case: str, **driven_extra) -> str:
    """case.json of the "slow_a2" line or the conductive "wall"."""
    os.makedirs(directory, exist_ok=True)
    n = 4 if case == "slow_a2" else 6
    gmsh_write.write(box_tet(n, n, n, lx=10.0, ly=10.0, lz=10.0),
                     os.path.join(directory, "box.msh"))
    port = {"Index": 1, "Attributes": [1], "R": ETA0, "Direction": "+Z",
            "Excitation": True}
    if case == "slow_a2":
        bdr = {"PEC": {"Attributes": []}, "LumpedPort": [port],
               "Conductivity": [{"Attributes": [5, 6],
                                 "Conductivity": COPPER_SIGMA}],
               "Absorbing": {"Attributes": [2], "Order": 2}}
        samples = {"Type": "Linear", "MinFreq": 10.0, "MaxFreq": 30.0,
                   "NSample": 7}
    else:
        bdr = {"PEC": {"Attributes": [5, 6]}, "LumpedPort": [port],
               "Conductivity": [{"Attributes": [2],
                                 "Conductivity": WALL_SIGMA}]}
        samples = {"Type": "Point", "Freq": [WALL_F_GHZ]}
    cfg = {
        "Problem": {"Type": "Driven", "Verbose": 0, "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1], "Permeability": 1.0,
                                   "Permittivity": 1.0}]},
        "Boundaries": bdr,
        "Solver": {"Order": 2, "Device": "CPU",
                   "Driven": dict({"Samples": [samples]}, **driven_extra),
                   "Linear": {"Tol": 1e-10, "MaxIts": 300}},
    }
    path = os.path.join(directory, "case.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


#: tests/test_conductivity.py:24: sqrt(omega mu0 / (2 sigma)) = eta0.
WALL_F_GHZ = 15.0
WALL_SIGMA = 2 * math.pi * WALL_F_GHZ * 1e9 * MU0 / (2.0 * ETA0 ** 2)


def _jax_sweep(path, out_dir=None):
    """palace_tpu's sparse-direct sweep and measurements, and its driven
    tables in `out_dir` if given (module functions; its `run` spends its
    time in JIT for the estimators)."""
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
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        jdriven.write_driven_tables(jio, jsop, out_dir, freqs, exc, meas)
    return meas


def _same_tables(a, b, names, tol=1e-8):
    """Equal headers and entries within `tol`, relative where the entry's
    magnitude exceeds 1."""
    for name in names:
        with open(os.path.join(a, name)) as fa, \
                open(os.path.join(b, name)) as fb:
            assert fa.readline() == fb.readline(), name
        da = np.loadtxt(os.path.join(a, name), delimiter=",", skiprows=1)
        db = np.loadtxt(os.path.join(b, name), delimiter=",", skiprows=1)
        err = np.abs(da - db) / np.maximum(np.abs(db), 1.0)
        assert err.max() <= tol, name


@pytest.fixture(scope="module")
def slow_a2(tmp_path_factory):
    path = write_case(str(tmp_path_factory.mktemp("slow_a2")), "slow_a2")
    io, jio = IoData(path), JaxIoData(path)
    return (SpaceOperator(io, prepare_mesh(io)),
            JaxSpaceOperator(jio, jax_prepare_mesh(jio)))


@pytest.mark.parametrize("omega", [0.25, 0.6])
def test_a2_csrs_match_jax(slow_a2, omega):
    sop, jsop = slow_a2
    assert len(sop._conductivity) == 1 and sop._abc2_tb is not None
    assert _rel(sop.conductivity_a2_csr(omega),
                jsop.conductivity_a2_csr(omega)) <= 1e-12
    assert _rel(sop.abc2_a2_csr(omega), jsop.abc2_a2_csr(omega)) <= 1e-12
    assert sop.waveport_a2_csr(omega) is None


@pytest.mark.parametrize("omega", [0.25, 0.6])
def test_driven_terms_sum_to_the_system(slow_a2, omega):
    """sum_t c_t(omega) X_t (free-restricted) = system_csr + A2 on the
    free dofs, and equals palace_tpu's sum."""
    sop, jsop = slow_a2
    terms, jterms = sop.driven_terms(), jsop.driven_terms()
    assert [t.name for t in terms] == [t.name for t in jterms] == [
        "K", "C", "M", "conductivity0", "abc2"]
    n = sop.space.num_dofs
    A = sum(t.coef(omega) * t.csr(n) for t in terms)
    jA = sum(t.coef(omega) * t.csr(n) for t in jterms)
    assert _rel(A, jA) <= 1e-12
    free = ~sop.ess_mask
    ref = sop.system_csr(omega) + sop.a2_csr(omega)
    assert _rel(A[free][:, free], ref[free][:, free]) <= 1e-12


def test_slow_a2_uniform_matches_jax(tmp_path):
    path = write_case(str(tmp_path), "slow_a2")
    res = palace_torch.run(path, output_dir=str(tmp_path / "t"))
    jmeas = _jax_sweep(path, str(tmp_path / "j"))
    _same_tables(str(tmp_path / "t"), str(tmp_path / "j"),
                 ("port-S.csv", "port-V.csv", "port-I.csv"))
    for key, m in res["measurements"].items():
        assert abs(m.ports[1].S - jmeas[key].ports[1].S) <= 1e-8


def test_slow_a2_adaptive_matches_uniform(tmp_path):
    """tests/test_driven_transient.py:120 through the port: the PROM's slow
    path re-projects A2 at every frequency and solves every HDM sample
    sparse direct."""
    res = {tag: palace_torch.run(write_case(str(tmp_path / tag), "slow_a2",
                                            **extra))
           for tag, extra in (("u", {}), ("a", {"AdaptiveTol": 1e-9}))}
    prov = res["a"]["provenance"]
    assert prov["solver_path"] == "prom-adaptive"
    assert prov["prom_hdm_path"] == "direct-slow-a2"
    assert res["a"]["prom"].solver is None
    for key, mu in res["u"]["measurements"].items():
        ma = res["a"]["measurements"][key]
        assert abs(ma.ports[1].S - mu.ports[1].S) <= 5e-6, key


def test_conductive_wall_matches_jax_and_analytic(tmp_path):
    path = write_case(str(tmp_path), "wall")
    res = palace_torch.run(path, output_dir=str(tmp_path / "t"))
    jmeas = _jax_sweep(path, str(tmp_path / "j"))
    _same_tables(str(tmp_path / "t"), str(tmp_path / "j"),
                 ("port-S.csv", "port-V.csv", "port-I.csv"))
    S11 = res["measurements"][(1, 0)].ports[1].S
    assert abs(S11 - jmeas[(1, 0)].ports[1].S) <= 1e-8
    omega = 2 * math.pi * WALL_F_GHZ * 1e9
    delta = math.sqrt(2.0 / (MU0 * WALL_SIGMA * omega))
    Zs = complex(1.0, 1.0) / (WALL_SIGMA * delta)
    gamma = (Zs - ETA0) / (Zs + ETA0)
    expect = gamma * cmath.exp(-1j * 2 * omega / C0 * 10e-3)
    assert abs(S11) == pytest.approx(abs(gamma), abs=0.02)
    assert abs(S11 - expect) < 0.05


@pytest.mark.parametrize("termination", ["conductivity", "absorbing"])
def test_device_solver_matches_direct(tmp_path, termination):
    out = {}
    for lin in ("GMG", "SuperLU"):
        out[lin] = palace_torch.run(write_waveguide_case(
            str(tmp_path / lin), 6, 3, 2, 2, termination=termination,
            linear=lin, tol=1e-12, device="CPU", verbose=0))
    prov = out["GMG"]["provenance"]
    assert prov["solver_path"] == "device" and prov["fine_level"] == "element"
    assert max(out["GMG"]["ksp"]["col_relres"].values()) <= 1e-12
    name = {"conductivity": "conductivity0", "absorbing": "abc2"}
    assert name[termination] in [t.name for t in
                                 out["GMG"]["sop"].driven_terms()]
    for key, m in out["GMG"]["measurements"].items():
        for idx in m.ports:
            assert abs(m.ports[idx].S - out["SuperLU"]["measurements"][key]
                       .ports[idx].S) <= 1e-8


def test_copper_short_matches_analytic(tmp_path):
    """The WR-90 guide shorted by copper at 9 x 4 x 3, Order 2, through
    both packages: the same S11 (1e-8), and 1 - |S11| within 1% of
    1 - |Gamma|, Gamma = (Z_s - Z_TE) / (Z_s + Z_TE), Z_s = (1 + i)
    sqrt(omega mu0 / (2 sigma)), Z_TE = eta0 k / beta."""
    path = write_waveguide_case(str(tmp_path), 9, 4, 3, 2,
                                termination="conductivity", linear="SuperLU",
                                freq_step=1.4, device="CPU", verbose=0)
    res = palace_torch.run(path)
    jmeas = _jax_sweep(path)
    for key, m in res["measurements"].items():
        S11 = m.ports[1].S
        assert abs(S11 - jmeas[key].ports[1].S) <= 1e-8
        omega = 2 * math.pi * res["freqs_ghz"][key[1]] * 1e9
        k = omega / C0
        beta = math.sqrt(k * k - (math.pi / (WR90_A * 1e-3)) ** 2)
        Zs = (1 + 1j) * math.sqrt(omega * MU0 / (2 * COPPER_SIGMA))
        gamma = (Zs - ETA0 * k / beta) / (Zs + ETA0 * k / beta)
        for S in (S11, jmeas[key].ports[1].S):
            assert abs((1 - abs(S)) / (1 - abs(gamma)) - 1) <= 1e-2, key
