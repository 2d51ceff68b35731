"""The adaptive PROM sweep (palace_torch/drivers/driven_adaptive.py) against
palace_tpu's, on the CPU.

- (a) `_orthonormalize` and `MinimalRationalInterpolation` on seeded numpy
  inputs, a repeated sample (the rank-deficient branch) included: the same
  float64 arithmetic, so 1e-13.
- (b) The dipole cavity at 3^3, Order 2, GMG, through both packages'
  `sweep_adaptive` (each on its own device FGMRES + p-MG solver, Tol 1e-10):
  the same sample count, each omega* within one MRI grid step, the same
  basis size, and the online solutions within 1e-7 relative (2-norm).
- (c) The lumped-port circuit-synthesis case of tests/test_prom_synthesis.py
  (box_tet 5^3, Order 1, two ports, sparse-direct HDM solves) through the
  port's `run` and palace_tpu's `sweep_adaptive`: the same rom-*.csv files
  and headers, each matrix within 1e-7 of its largest entry, and that
  test's physics checks on the port.
- (d) The port's adaptive sweep against its own uniform sweep on the
  matched TEM line of tests/test_driven_transient.py:96, at that test's
  tolerances (S abs 2e-6, V rel 2e-6 / abs 1e-9).
- The device solver built with no frequency and `max_block=1`, every
  frequency added by `add_omega` (as the greedy loop builds it), against
  the same solver built with its frequencies up front, bit for bit (the
  greedy solves of (b) hold it against palace_tpu's built the same way).
"""

import json
import math
import os

import numpy as np
import pytest

import palace_torch
from palace_tpu.config import IoData as JaxIoData
from palace_tpu.config import ValueType as JaxValueType
from palace_tpu.drivers import driven_adaptive as jda
from palace_tpu.drivers.common import prepare_mesh as jax_prepare_mesh
from palace_tpu.models.spaceoperator import SpaceOperator as JaxSpaceOperator
from palace_torch.cases import write_adaptive_case
from palace_torch.config import IoData, ValueType
from palace_torch.drivers import driven_adaptive as tda
from palace_torch.drivers.common import prepare_mesh
from palace_torch.drivers.driven import driven_samples_ghz
from palace_torch.mesh import gmsh_write
from palace_torch.mesh.generate import box_tet
from palace_torch.models.spaceoperator import SpaceOperator

ETA0 = 376.730313412


# -- (a) CGS2 and the MRI ----------------------------------------------------


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-300))


@pytest.mark.parametrize("seed", [0, 1])
def test_orthonormalize_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    ws = [rng.standard_normal(n) + 1j * rng.standard_normal(n)
          for _ in range(5)]
    ws.append(ws[1] * (0.5 - 2.0j) + 3.0 * ws[3])  # in the span: dropped
    ws.append(rng.standard_normal(n).astype(complex))
    Vt, Rt, Vj, Rj = [], [], [], []
    for w in ws:
        tda._orthonormalize(Vt, w.copy(), Rt)
        jda._orthonormalize(Vj, w.copy(), Rj)
    assert len(Vt) == len(Vj) == 6 and len(Rt) == len(Rj) == 6
    for a, b in zip(Vt + Rt, Vj + Rj):
        assert a.shape == b.shape and _rel(a, b) <= 1e-13
    Vm = np.stack(Vt, axis=1)
    assert np.abs(Vm.conj().T @ Vm - np.eye(6)).max() <= 1e-13


def test_mri_matches_jax_with_repeated_sample():
    rng = np.random.default_rng(7)
    n = 30
    base = [rng.standard_normal(n) + 1j * rng.standard_normal(n)
            for _ in range(4)]

    def field(w):  # a rational response: poles near 2.2 and 3.7
        return (base[0] / (w - 2.2 - 0.05j) + base[1] / (w - 3.7 - 0.02j)
                + base[2] + w * base[3])

    mt, mj = tda.MinimalRationalInterpolation(), jda.MinimalRationalInterpolation()
    zs = [1.0, 5.0, 2.9, 2.9, 4.1]  # 2.9 twice: rank-deficient R
    for z in zs:
        u = field(z)
        mt.add_sample(z, u)
        mj.add_sample(z, u)
        assert _rel(mt.R, mj.R) <= 1e-13
        assert _rel(mt.q, mj.q) <= 1e-13
        assert mt.find_max_error() == mj.find_max_error()
    s = np.linalg.svd(mt.R, compute_uv=False)
    assert s[-1] < 1e-12 * s[0]  # the repeated sample took the fallback
    assert mt.z == mj.z == zs


# -- (b) the dipole cavity through both packages' sweep_adaptive -------------


def _sweep(pkg, path):
    """(online solutions, samples, basis size) of one package's
    sweep_adaptive on the config at `path`."""
    if pkg == "torch":
        iodata = IoData(path)
        sop = SpaceOperator(iodata, prepare_mesh(iodata))
        scale = iodata.units.scale_factor(ValueType.FREQUENCY)
        omegas = [2 * math.pi * f / scale for f in driven_samples_ghz(iodata)]
        report = tda.PromReport()
        sols = tda.sweep_adaptive(iodata, sop, omegas, sop.excitations(),
                                  report=report)
        return (sols, [om for _, om, _ in report.samples], report.basis_size,
                omegas)
    from palace_tpu.drivers.driven import driven_samples_ghz as jax_samples

    iodata = JaxIoData(path)
    sop = JaxSpaceOperator(iodata, jax_prepare_mesh(iodata))
    scale = iodata.units.scale_factor(JaxValueType.FREQUENCY)
    omegas = [2 * math.pi * f / scale for f in jax_samples(iodata)]
    samples, basis = [], []
    mri_add, orth = jda.MinimalRationalInterpolation.add_sample, \
        jda._orthonormalize

    def add_sample(self, omega, u):
        samples.append(float(omega))
        return mri_add(self, omega, u)

    def orthonormalize(V, w, R=None):
        out = orth(V, w, R)
        basis.append(len(V))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jda.MinimalRationalInterpolation, "add_sample", add_sample)
    mp.setattr(jda, "_orthonormalize", orthonormalize)
    try:
        sols = jda.sweep_adaptive(iodata, sop, omegas, sop.excitations())
    finally:
        mp.undo()
    return sols, samples, max(basis), omegas


def test_dipole_cavity_matches_jax(tmp_path):
    path = write_adaptive_case(str(tmp_path), 3, 2, tol=1e-10, device="CPU",
                               verbose=0)
    st, zt, mt, omegas = _sweep("torch", path)
    sj, zj, mj, _ = _sweep("jax", path)
    step = (max(omegas) - min(omegas)) / 200000
    assert len(zt) == len(zj) >= 4
    assert np.abs(np.array(zt) - np.array(zj)).max() <= step
    assert mt == mj
    assert sorted(st) == sorted(sj) and len(st) == 51
    worst = max(np.linalg.norm(st[k] - sj[k]) / np.linalg.norm(sj[k])
                for k in sj)
    assert worst <= 1e-7


# -- (c) circuit synthesis ----------------------------------------------------


def _synthesis_case(directory, device_key):
    os.makedirs(directory, exist_ok=True)
    gmsh_write.write(box_tet(5, 5, 5, lx=10.0, ly=10.0, lz=10.0),
                     os.path.join(directory, "box.msh"))
    cfg = {
        "Problem": {"Type": "Driven", "Verbose": 0, "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [
            {"Attributes": [1], "Permeability": 1.0, "Permittivity": 1.0}]},
        "Boundaries": {
            "PEC": {"Attributes": [5, 6]},
            "LumpedPort": [
                {"Index": 1, "Attributes": [1], "R": ETA0,
                 "Direction": "+Z", "Excitation": True},
                {"Index": 2, "Attributes": [2], "R": ETA0, "Direction": "+Z"},
            ],
        },
        "Solver": {"Order": 1, "Device": device_key,
                   "Driven": {"Samples": [{"Type": "Linear", "MinFreq": 5.0,
                                           "MaxFreq": 20.0, "NSample": 6}],
                              "AdaptiveTol": 1e-6,
                              "AdaptiveCircuitSynthesis": True},
                   "Linear": {"Tol": 1e-10, "MaxIts": 300}},
    }
    path = os.path.join(directory, "case.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


ROM_TABLES = ("rom-Linv-re.csv", "rom-C-re.csv", "rom-Rinv-re.csv",
              "rom-orthogonalization-matrix-R.csv")


def _rom(directory, name):
    """(header, rows) of a CSV table."""
    with open(os.path.join(directory, name)) as fh:
        header = [h.strip() for h in fh.readline().split(",")]
    return header, np.loadtxt(os.path.join(directory, name), skiprows=1,
                              delimiter=",", ndmin=2)


def test_circuit_synthesis_matches_jax(tmp_path):
    """The port's whole run against palace_tpu's sweep_adaptive, which
    writes the same tables (its run's postprocessing adds nothing to
    them)."""
    out_t, out_j = str(tmp_path / "out_t"), str(tmp_path / "out_j")
    res = palace_torch.run(_synthesis_case(str(tmp_path / "t"), "CPU"),
                           output_dir=out_t)
    jio = JaxIoData(_synthesis_case(str(tmp_path / "j"), "CPU"))
    jsop = JaxSpaceOperator(jio, jax_prepare_mesh(jio))
    os.makedirs(out_j)
    jda.sweep_adaptive(jio, jsop, res["omegas"], jsop.excitations(),
                       post_dir=out_j)
    assert res["provenance"]["prom_hdm_path"] == "direct"
    assert sorted(n for n in os.listdir(out_t) if n.startswith("rom-")) \
        == sorted(os.listdir(out_j))
    for name in ROM_TABLES:
        ht, mt = _rom(out_t, name)
        hj, mj = _rom(out_j, name)
        assert ht == hj and mt.shape == mj.shape, name
        assert np.abs(mt - mj).max() <= 1e-7 * np.abs(mj).max(), name

    # tests/test_prom_synthesis.py's physics checks, on the port's tables.
    header, rinv = _rom(out_t, "rom-Rinv-re.csv")
    assert header[:2] == ["port_1", "port_2"]
    assert rinv.shape == (len(header), len(header))
    assert rinv[0, 0] == pytest.approx(1.0 / ETA0, rel=1e-6)
    assert rinv[1, 1] == pytest.approx(1.0 / ETA0, rel=1e-6)
    assert abs(rinv[0, 1]) < 1e-10 / ETA0
    _, cmat = _rom(out_t, "rom-C-re.csv")
    assert cmat[0, 1] == pytest.approx(cmat[1, 0], abs=1e-18)


# -- (d) adaptive against uniform on the matched TEM line ---------------------


def _tem_line(directory):
    """tests/test_driven_transient.py:make_case with the adaptive driven
    sweep of test_driven_adaptive_matches_uniform (11 samples, 5-30 GHz,
    AdaptiveTol 1e-9)."""
    os.makedirs(directory, exist_ok=True)
    gmsh_write.write(box_tet(6, 6, 6, lx=10.0, ly=10.0, lz=10.0),
                     os.path.join(directory, "box.msh"))
    driven = {"Samples": [{"Type": "Linear", "MinFreq": 5.0, "MaxFreq": 30.0,
                           "NSample": 11}], "AdaptiveTol": 1e-9}
    cfg = {
        "Problem": {"Type": "Driven", "Verbose": 0, "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [
            {"Attributes": [1], "Permeability": 1.0, "Permittivity": 1.0}]},
        "Boundaries": {
            "PEC": {"Attributes": [5, 6]},
            "LumpedPort": [
                {"Index": 1, "Attributes": [1], "R": ETA0,
                 "Direction": "+Z", "Excitation": True},
                {"Index": 2, "Attributes": [2], "R": ETA0, "Direction": "+Z"},
            ],
        },
        "Solver": {"Order": 2, "Device": "CPU", "Driven": driven,
                   "Linear": {"Tol": 1e-10, "MaxIts": 300}},
    }
    path = os.path.join(directory, "case.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def test_adaptive_matches_uniform(tmp_path):
    """Both sweeps on one SpaceOperator (the case's 9,324 dofs take the
    sparse-direct path: 11 uniform and 16 greedy factorizations), measured
    by drivers/driven.py's measure_step."""
    from palace_torch.drivers.driven import measure_step, sweep_uniform

    iodata = IoData(_tem_line(str(tmp_path)))
    sop = SpaceOperator(iodata, prepare_mesh(iodata))
    scale = iodata.units.scale_factor(ValueType.FREQUENCY)
    omegas = [2 * math.pi * f / scale for f in driven_samples_ghz(iodata)]
    ex = sop.excitations()
    report = tda.PromReport()
    sols_a = tda.sweep_adaptive(iodata, sop, omegas, ex, report=report)
    sols_u = sweep_uniform(iodata, sop, omegas, ex)
    assert report.stopped_by == {1: "memory"} and not report.hdm_relres
    assert sorted(sols_u) == sorted(sols_a) and len(sols_u) == 11
    fns = {idx: sop.port_functionals(idx) for idx in sop.ports}
    for (e, i), Eu in sols_u.items():
        mu = measure_step(sop, Eu, omegas[i], e, fns.get)
        ma = measure_step(sop, sols_a[(e, i)], omegas[i], e, fns.get)
        for idx in mu.ports:
            assert ma.ports[idx].S == pytest.approx(mu.ports[idx].S, abs=2e-6)
            assert ma.ports[idx].V == pytest.approx(mu.ports[idx].V, rel=2e-6,
                                                    abs=1e-9)


def test_lazily_built_device_solver(tmp_path):
    from palace_torch.linalg.device_ksp import BlockedDeviceSolver

    iodata = IoData(write_adaptive_case(str(tmp_path), 3, 2, tol=1e-10,
                                        device="CPU", verbose=0))
    sop = SpaceOperator(iodata, prepare_mesh(iodata))
    omegas = [0.9, 2.4, 3.3]
    kw = dict(tol=1e-10, max_its=200, restart=30, max_block=1)
    lazy = BlockedDeviceSolver(sop.space, [1, 2, 3, 4, 5, 6],
                               sop.driven_terms([]), [], sop.ess_mask, **kw)
    eager = BlockedDeviceSolver(sop.space, [1, 2, 3, 4, 5, 6],
                                sop.driven_terms(omegas), omegas,
                                sop.ess_mask, **kw)
    assert lazy.structured is not None and lazy.omegas == []
    order = (2, 0, 1)  # added out of order
    assert [lazy.add_omega(omegas[k]) for k in order] == [0, 1, 2]
    b1 = sop.rhs1(1)
    for j, k in enumerate(order):
        b = (1j * omegas[k] * b1)[:, None]
        X, info = lazy.solve(b, omega_idx=[j])
        Xe, info_e = eager.solve(b, omega_idx=[k])
        assert np.array_equal(X, Xe)
        assert info["iterations"].tolist() == info_e["iterations"].tolist()
        assert info["relres"][0] <= 1e-10


def test_restart_refused_with_adaptive(tmp_path):
    iodata = IoData(write_adaptive_case(str(tmp_path), 2, 1, device="CPU",
                                        verbose=0))
    iodata.solver.driven.restart = 2
    from palace_torch.drivers import driven

    with pytest.raises(ValueError, match="Restart"):
        driven.solve(iodata, output_dir=str(tmp_path / "out"))
