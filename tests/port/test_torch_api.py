"""palace_torch entry points and guards: CLI dry run, device selection,
solver routing, the errors that name the ROADMAP item for features not
ported yet, and the static-analysis gate over the port's sources."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import palace_torch
from palace_torch.__main__ import main as cli_main
from palace_torch.cases import (write_adaptive_case, write_amr_driven_case,
                                 write_amr_eigen_case, write_cavity_case,
                                 write_eigen_case, write_guide_eigen_case,
                                 write_rings_case, write_slice_case,
                                 write_tem_line_case, write_tem_section_case,
                                 write_waveguide_case)
from palace_torch.config import IoData
from palace_torch.device import resolve_device
from palace_torch.drivers import driven

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_cli_dry_run(tmp_path, capsys):
    cfg = write_slice_case(str(tmp_path), 2, 1, device="CPU")
    assert cli_main(["--dry-run", cfg]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["problem"]["type"] == "Driven"
    assert out["solver"]["order"] == 1


def test_resolve_device():
    assert resolve_device("CPU") == torch.device("cpu")
    assert resolve_device("debug") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("TPU")
    if torch.cuda.is_available():
        assert resolve_device("GPU") == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError):
            resolve_device("GPU")


def _rings_es(directory, h, order, **kw):
    return write_rings_case(directory, 4.0 * h, order,
                            problem="Electrostatic", **kw)


def _rings_ms(directory, h, order, **kw):
    return write_rings_case(directory, 4.0 * h, order, **kw)


def _guide(directory, n, order, **kw):
    return write_waveguide_case(directory, 2 * n, n, n, order, **kw)


def _cavity(directory, n, order, **kw):
    return write_cavity_case(directory, n, n, n, order, **kw)


def _guide_eigen(directory, n, order, **kw):
    return write_guide_eigen_case(directory, 2 * n, n, n, order, **kw)


@pytest.mark.parametrize("writer", [write_slice_case, write_eigen_case,
                                    write_adaptive_case, _rings_es,
                                    _rings_ms, _guide, _cavity, _guide_eigen,
                                    write_amr_eigen_case,
                                    write_amr_driven_case],
                         ids=["driven", "eigen", "adaptive", "electrostatic",
                              "magnetostatic", "waveguide", "eigen_damped",
                              "eigen_nonlinear", "eigen_amr", "driven_amr"])
def test_entry_points_default_to_the_gpu(tmp_path, writer):
    """The case writers and the port's schema pick the GPU unless asked for
    the CPU; without CUDA a run then refuses to start."""
    path = writer(str(tmp_path), 2, 1, verbose=0)
    with open(path) as f:
        cfg = json.load(f)
    assert cfg["Solver"]["Device"] == "GPU"
    del cfg["Solver"]["Device"]
    with open(path, "w") as f:
        json.dump(cfg, f)
    assert IoData(path).solver.device == "GPU"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            palace_torch.run(path)


@pytest.mark.parametrize("problem,table", [
    ("Electrostatic", "terminal-C.csv"), ("Magnetostatic", "terminal-M.csv")])
def test_cli_runs_static_drivers(tmp_path, problem, table):
    """`python -m palace_torch` (its main) on a coarse rings case on the
    CPU; the run writes its tables and the solve provenance."""
    cfg = write_rings_case(str(tmp_path), 4.0, 1, problem=problem,
                           tol=1e-8, device="CPU", verbose=0)
    assert cli_main([cfg, "-o", str(tmp_path / "out")]) == 0
    data = np.loadtxt(tmp_path / "out" / table, delimiter=",", skiprows=1)
    assert data.shape == (2, 3) and np.isfinite(data).all()
    assert data[0, 1] > 0 and data[1, 2] > 0
    with open(tmp_path / "out" / "palace.json") as f:
        meta = json.load(f)
    assert meta["Problem"]["Type"] == problem
    assert "Linearsolve" in meta["ElapsedTime"]["Durations"]


def test_solver_routing(tmp_path):
    iodata = IoData(write_slice_case(str(tmp_path), 2, 1, device="CPU"))
    assert driven.use_device_ksp(iodata, 100)  # explicit GMG
    iodata.solver.linear.type = "SuperLU"
    assert not driven.use_device_ksp(iodata, 10 ** 7)
    iodata.solver.linear.type = "Default"
    assert not driven.use_device_ksp(iodata, 100)
    assert driven.use_device_ksp(iodata, driven.DEVICE_KSP_MIN_DOFS)


@pytest.mark.parametrize("feature,item", [
    ("amr", "nonconforming ND AMR"),
    ("paraview", None),  # ported: the driven sweep writes its VTU files
    ("floquet", None),  # ported: the Bloch terms join the device sweep
])
def test_unported_features_name_roadmap_item(tmp_path, feature, item):
    iodata = IoData(write_slice_case(str(tmp_path), 2, 1, device="CPU",
                                     verbose=0))
    if feature == "amr":
        iodata.model.refinement.max_it = 1
    elif feature == "floquet":
        iodata.boundaries.floquet_wave_vector = [0.1, 0.0, 0.0]
    else:
        iodata.problem.output_formats.paraview = True
        iodata.solver.driven.save_freqs = [2.0, 5.5]
    if item is None:
        res = driven.solve(iodata, output_dir=str(tmp_path / "out"))
        if feature == "floquet":
            names = [t.name for t in res["sop"].driven_terms()]
            assert {"floquet_mass", "floquet_cross"} <= set(names)
            assert res["provenance"]["solver_path"] == "device"
            dom = np.loadtxt(tmp_path / "out" / "domain-E.csv",
                             delimiter=",", skiprows=1)
            assert dom.shape == (8, 5) and np.isfinite(dom).all()
            return
        pv = tmp_path / "out" / "paraview" / "driven"
        assert sorted(os.listdir(pv)) == ["driven.pvd", "driven_0000.vtu",
                                          "driven_0001.vtu"]
        return
    with pytest.raises(NotImplementedError, match=item):
        driven.solve(iodata, output_dir=str(tmp_path / "out"))


@pytest.mark.parametrize("termination,term", [
    ("waveport", "waveport2"), ("conductivity", "conductivity0"),
    ("absorbing", "abc2")])
def test_frequency_dependent_boundaries_are_ported(tmp_path, termination,
                                                   term):
    """Wave ports, Conductivity and second-order Absorbing boundaries no
    longer raise: their driven configs build and carry their device-solver
    terms (wave port 1 drives every case)."""
    from palace_torch.drivers.common import prepare_mesh
    from palace_torch.models.spaceoperator import SpaceOperator

    iodata = IoData(write_waveguide_case(str(tmp_path), 2, 1, 1, 1,
                                         termination=termination,
                                         device="CPU", verbose=0))
    names = [t.name for t in SpaceOperator(
        iodata, prepare_mesh(iodata)).driven_terms()]
    assert "waveport1" in names and term in names


@pytest.mark.parametrize("ptype,item", [
    ("TRANSIENT", None),  # ported: routes to drivers/transient.py
    ("BOUNDARY_MODE", None),  # ported: routes to drivers/boundarymode.py
])
def test_unported_drivers_name_roadmap_item(tmp_path, ptype, item):
    """Every problem type routes to its driver (no driver is refused whole
    any more), and `python -m palace_torch` runs a deck of each of the
    last two ported."""
    from palace_torch.config import ProblemType
    from palace_torch.drivers import _QUEUE, boundarymode, get_driver, \
        transient

    assert item is None and not _QUEUE
    if ptype == "TRANSIENT":
        assert get_driver(ProblemType.TRANSIENT) is transient.solve
        cfg = write_tem_line_case(str(tmp_path), 10.0, 2, 2, 1,
                                  max_time=0.004, device="CPU", verbose=0)
        assert cli_main([cfg, "-o", str(tmp_path / "out")]) == 0
        v = np.loadtxt(tmp_path / "out" / "port-V.csv", delimiter=",",
                       skiprows=1)
        assert v.shape == (3, 4) and np.isfinite(v).all()
        return
    assert get_driver(ProblemType.BOUNDARY_MODE) is boundarymode.solve
    cfg = write_tem_section_case(str(tmp_path), 3, 1, 1, device="CPU",
                                 verbose=0)
    assert cli_main([cfg, "-o", str(tmp_path / "out")]) == 0
    kn = np.loadtxt(tmp_path / "out" / "mode-kn.csv", delimiter=",",
                    skiprows=1, ndmin=2)
    assert kn.shape == (1, 7)
    assert kn[0, 3] == pytest.approx(1.5, rel=1e-8)  # sqrt(eps_r 2.25)


def test_lint_clean():
    paths = [os.path.join(REPO, p) for p in
             ("palace_torch", "chip_smoke.py", "tests/port",
              "scripts/profile_torch_slice.py",
              "scripts/rehearse_smoke_cpu.py")]
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                        "lint.py"), *paths],
                          capture_output=True, text=True)
    assert proc.returncode == 0, "lint findings:\n" + proc.stdout
