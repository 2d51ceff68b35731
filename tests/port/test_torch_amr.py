"""The AMR loop of palace_torch against palace_tpu: Dörfler marking, tet
bisection and nonconforming hex 1->8 refinement (drivers/amr.py,
mesh/refine_hex.py), the hanging-node prolongation (fem/hanging.py) and the
electrostatic solve-estimate-mark-refine loop on tets and on hexes, the
magnetostatic loop on tets (refused on hexes), plus the archive of
superseded iterations and the adapted meshes.

Each package builds its own meshes from the same parameters; marking and
refinement are host numpy in both and must agree exactly (element counts,
node coordinates, connectivity), the prolongation to 1e-14, the loops'
capacitances to 1e-9 at the same element counts per iteration.  The
parallel plate of tests/test_amr.py:42 is exact on every mesh, so its
indicators are round-off (relative error about 6e-11) and which elements
they mark is not reproducible across packages: its loop is held by its
capacitance, its pass count and the size of its indicators; the element
counts are held on the same tet box with terminal and ground on adjacent
faces (a singular edge), and on the hex loop of tests/test_amr_hex.py:83."""

import json
import os

import numpy as np
import pytest

import palace_torch
from palace_torch.drivers import amr as tamr
from palace_torch.fem.h1 import H1Space as TorchH1Space
from palace_torch.fem.hanging import h1_hanging_matrix
from palace_torch.mesh import generate as tgen
from palace_torch.mesh.refine_hex import refine_hexes
from palace_tpu import api as jax_api
from palace_tpu.drivers import amr as jamr
from palace_tpu.fem.h1 import H1Space
from palace_tpu.fem.hanging import h1_hanging_matrix as jax_hanging
from palace_tpu.mesh import gmsh_write
from palace_tpu.mesh.generate import box_hex, box_tet
from palace_tpu.mesh.refine_hex import refine_hexes as jax_refine_hexes


def _same_mesh(tm, jm):
    assert tm.num_elements == jm.num_elements
    assert np.array_equal(tm.nodes, jm.nodes)
    for tb, jb in zip(tm.buckets, jm.buckets):
        assert np.array_equal(tb.conn, jb.conn)
        assert np.array_equal(tb.attr, jb.attr)
    for tb, jb in zip(tm.bdr_buckets, jm.bdr_buckets):
        assert np.array_equal(tb.conn, jb.conn)
        assert np.array_equal(tb.attr, jb.attr)


@pytest.mark.parametrize("fraction", [0.3, 0.7, 1.0])
def test_dorfler_mark_matches_jax(fraction):
    eta2 = np.random.default_rng(4).exponential(size=200)
    assert np.array_equal(tamr.dorfler_mark(eta2, fraction),
                          jamr.dorfler_mark(eta2, fraction))


@pytest.mark.parametrize("kind", ["tet", "hex"])
def test_refine_marked_matches_jax(kind):
    """Two rounds: tet longest-edge bisection, or hex 1->8 with its
    persistent node registry (the second round refines next to the first)."""
    if kind == "tet":
        tm, jm = tgen.box_tet(3, 3, 3), box_tet(3, 3, 3)
        marks = (np.array([0, 5, 17]), np.array([1, 2, 40, 41]))
    else:
        tm, jm = tgen.box_hex(2, 2, 2), box_hex(2, 2, 2)
        marks = (np.array([0, 3]), np.array([0, 1, 9]))
    for marked in marks:
        tm, jm = tamr.refine_marked(tm, marked), jamr.refine_marked(jm, marked)
        _same_mesh(tm, jm)
    assert tm.num_elements > (81 * 2 if kind == "tet" else 8)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_hanging_matrix_matches_jax(p):
    tm = refine_hexes(tgen.box_hex(2, 2, 2), np.array([0, 3]))
    jm = jax_refine_hexes(box_hex(2, 2, 2), np.array([0, 3]))
    P, true_idx = h1_hanging_matrix(TorchH1Space(tm, p), tm)
    Pj, true_j = jax_hanging(H1Space(jm, p), jm)
    assert np.array_equal(true_idx, true_j)
    assert P.shape == Pj.shape
    assert abs(P - Pj).max() <= 1e-14


def _amr_config(kind):
    """tests/test_amr.py:42 (tets, parallel plate), the same tets with
    terminal and ground on adjacent faces (a singular edge), and
    tests/test_amr_hex.py:83 (hexes, a singular edge)."""
    if kind in ("tet_plate", "tet_edge"):
        mesh = box_tet(3, 3, 3, lx=2.0, ly=3.0, lz=0.5)
        bdr = {"Terminal": [{"Index": 1, "Attributes": [
            5 if kind == "tet_plate" else 1]}],
               "Ground": {"Attributes": [6]}}
        eps, frac = 4.0, 0.5
    else:
        mesh = box_hex(3, 3, 3)
        bdr = {"Terminal": [{"Index": 1, "Attributes": [1]}],
               "Ground": {"Attributes": [5]}}
        eps, frac = 1.0, 0.5
    cfg = {
        "Problem": {"Type": "Electrostatic", "Verbose": 0, "Output": "out"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3,
                  "Refinement": {"Tol": 1e-12, "MaxIts": 2,
                                 "UpdateFraction": frac,
                                 "SaveAdaptIterations": True,
                                 "SaveAdaptMesh": True}},
        "Domains": {"Materials": [{"Attributes": [1], "Permittivity": eps}]},
        "Boundaries": bdr,
        "Solver": {"Order": 2, "Device": "CPU", "Electrostatic": {"Save": 0},
                   "Linear": {"Tol": 1e-12, "MaxIts": 2000}},
    }
    return mesh, cfg


def _spy(monkeypatch, module, log):
    """Record the element count of every solve and the indicator norm of
    every pass of `module.adapt_loop`."""
    refine, combine = module.refine_marked, module.combine_indicators

    def refine_spy(mesh, marked):
        out = refine(mesh, marked)
        log["elements"].append(out.num_elements)
        return out

    def combine_spy(eta2_steps, energies):
        eta, norm = combine(eta2_steps, energies)
        log["norms"].append(norm)
        return eta, norm

    monkeypatch.setattr(module, "refine_marked", refine_spy)
    monkeypatch.setattr(module, "combine_indicators", combine_spy)


@pytest.mark.parametrize("kind", ["tet_plate", "tet_edge", "hex"])
def test_electrostatic_amr_loop_matches_jax(tmp_path, monkeypatch, kind):
    monkeypatch.setenv("PALACE_TPU_MULTICHIP", "0")
    mesh, cfg = _amr_config(kind)
    gmsh_write.write(mesh, str(tmp_path / "box.msh"))
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    logs = {}
    for name, module, run in (("jax", jamr, jax_api.run),
                              ("torch", tamr, palace_torch.run)):
        logs[name] = {"elements": [mesh.num_elements], "norms": []}
        _spy(monkeypatch, module, logs[name])
        logs[name]["result"] = run(str(path), str(tmp_path / name))
    rj, rt = logs["jax"]["result"], logs["torch"]["result"]
    assert len(logs["torch"]["elements"]) == 3  # two refinements
    assert logs["torch"]["elements"][-1] > mesh.num_elements
    assert abs(rt["C"][0, 0] - rj["C"][0, 0]) <= 1e-9 * abs(rj["C"][0, 0])
    assert rt["amr_iterations"] == 2
    if kind == "tet_plate":  # exact on every mesh: round-off indicators
        eps0 = 8.8541878188e-12
        assert rt["C"][0, 0] == pytest.approx(
            4.0 * eps0 * (2e-3 * 3e-3) / 0.5e-3, rel=1e-9)
        assert max(logs["torch"]["norms"] + logs["jax"]["norms"]) <= 1e-8
    else:
        assert logs["torch"]["elements"] == logs["jax"]["elements"]
        assert np.allclose(logs["torch"]["norms"], logs["jax"]["norms"],
                           rtol=1e-8, atol=0)
    if kind == "hex":  # nonconforming hexes take the host direct solve
        assert rt["provenance"]["solver_path"] == "direct-nonconforming"
    listing = {name: sorted(os.listdir(tmp_path / name))
               for name in ("jax", "torch")}
    assert listing["torch"] == listing["jax"]
    assert "amr-mesh-2.msh" in listing["torch"]


def _magnetostatic_amr_config(tmp_path, mesh, pec=(1, 2, 3, 4)):
    """tests/test_amr.py:142, the current sheet through a tet box, on the
    CPU."""
    gmsh_write.write(mesh, str(tmp_path / "box.msh"))
    cfg = {
        "Problem": {"Type": "Magnetostatic", "Verbose": 0, "Output": "out"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3,
                  "Refinement": {"Tol": 1e-12, "MaxIts": 1,
                                 "UpdateFraction": 0.4}},
        "Domains": {"Materials": [{"Attributes": [1], "Permeability": 1.0}]},
        "Boundaries": {
            "SurfaceCurrent": [{"Index": 1, "Attributes": [7],
                                "Direction": "+X"}],
            "PEC": {"Attributes": list(pec)},
        },
        "Solver": {"Order": 1, "Device": "CPU", "Magnetostatic": {"Save": 0},
                   "Linear": {"Tol": 1e-10, "MaxIts": 1000}},
    }
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("pec", [(1, 2, 3, 4), (1, 2, 3, 4, 5, 6)])
def test_magnetostatic_amr_loop_matches_jax(tmp_path, monkeypatch, pec):
    """With PEC on four faces (tests/test_amr.py:142) the field is uniform
    on each side of the sheet and exact on every mesh: its indicators are
    round-off, so which elements they mark is not held.  Closing the two
    other faces makes the field vary, and the loops must then refine
    alike."""
    monkeypatch.setenv("PALACE_TPU_MULTICHIP", "0")
    mesh = box_tet(2, 2, 2, sheet_j=1)
    path = _magnetostatic_amr_config(tmp_path, mesh, pec)
    logs = {}
    for name, module, run in (("jax", jamr, jax_api.run),
                              ("torch", tamr, palace_torch.run)):
        logs[name] = {"elements": [mesh.num_elements], "norms": []}
        _spy(monkeypatch, module, logs[name])
        logs[name]["result"] = run(path, str(tmp_path / name))
    rj, rt = logs["jax"]["result"], logs["torch"]["result"]
    assert rt["amr_iterations"] == 1
    assert len(logs["torch"]["elements"]) == 2  # one refinement
    assert logs["torch"]["elements"][-1] > mesh.num_elements
    Mj = np.asarray(rj["M"])
    assert np.all(np.isfinite(rt["M"])) and np.all(np.diag(rt["M"]) > 0)
    assert np.max(np.abs(rt["M"] - Mj)) <= 1e-8 * np.max(np.abs(Mj))
    if len(pec) == 4:  # exact on every mesh: round-off indicators
        assert rt["M"][0, 0] == pytest.approx(np.pi * 1e-10, rel=1e-9)
        assert max(logs["torch"]["norms"] + logs["jax"]["norms"]) <= 1e-8
    else:
        assert logs["torch"]["norms"][0] > 0.1
        assert logs["torch"]["elements"] == logs["jax"]["elements"]
        assert np.allclose(logs["torch"]["norms"], logs["jax"]["norms"],
                           rtol=1e-8, atol=0)
    listing = {name: sorted(os.listdir(tmp_path / name))
               for name in ("jax", "torch")}
    assert listing["torch"] == listing["jax"]


def test_magnetostatic_hex_amr_is_refused(tmp_path):
    """Hex refinement leaves hanging nodes that only H1 spaces constrain,
    so the curl-curl solve there would be nonconforming."""
    path = _magnetostatic_amr_config(tmp_path, box_hex(2, 2, 2, sheet_j=1))
    with pytest.raises(NotImplementedError, match="nonconforming ND AMR"):
        palace_torch.run(path, str(tmp_path / "torch"))


def test_archive_iteration_matches_jax(tmp_path):
    for name, module in (("jax", jamr), ("torch", tamr)):
        d = tmp_path / name
        d.mkdir()
        (d / "terminal-C.csv").write_text("C\n")
        (d / "palace.json").write_text("{}\n")
        module.archive_iteration(str(d), 3, 12)
    assert sorted(os.listdir(tmp_path / "torch" / "iteration03")) == \
        sorted(os.listdir(tmp_path / "jax" / "iteration03")) == \
        ["palace.json", "terminal-C.csv"]


def _spy_passes(monkeypatch, module, log):
    """Record (elements, the run's omega) of every pass of the driver's
    `adapt_loop` (both eigen drivers return omega at result[0][4])."""
    loop = module.adapt_loop

    def spy(iodata, mesh, solve_and_estimate, post_dir=None):
        def wrapped(m):
            out = solve_and_estimate(m)
            log.append((m.num_elements, np.array(out[0][4])))
            return out
        return loop(iodata, mesh, wrapped, post_dir=post_dir)

    return spy


@pytest.mark.parametrize("kind", ["cube", "jittered"])
def test_eigen_amr_converges_matches_jax(tmp_path, monkeypatch, kind):
    """tests/test_amr.py:73 (the 1 cm PEC cube, box_tet 3^3, Order 1, host
    ARPACK, MaxIts 3) through both packages: four passes, the error below
    0.7 x the first pass's, and the same files (the eigen tables are
    written after the loop, so the iteration archive holds the adapted
    mesh).  The cube's lowest mode is triply degenerate and its structured
    mesh ties many indicators exactly, so which vector ARPACK returns and
    which of the tied elements Dörfler marks follow round-off: after the
    first pass the two packages' meshes part (1,276 against 1,292 elements
    at pass 3).  So the cube is held at its first pass (f within 1e-8);
    the same cube with its interior nodes jittered (seeded), whose
    indicators do not tie, is held at every pass: the same element counts
    and f within 1e-8."""
    from palace_torch.cases import write_amr_eigen_case
    from palace_torch.drivers import eigenmode as teigen

    monkeypatch.setenv("PALACE_TPU_MULTICHIP", "0")
    path = write_amr_eigen_case(str(tmp_path / "case"), 3, 1,
                                jitter=0.1 if kind == "jittered" else 0.0,
                                max_its=3, linear="Default", device="CPU",
                                verbose=0)
    logs = {"torch": [], "jax": []}
    monkeypatch.setattr(teigen, "adapt_loop",
                        _spy_passes(monkeypatch, tamr, logs["torch"]))
    monkeypatch.setattr(jamr, "adapt_loop",
                        _spy_passes(monkeypatch, jamr, logs["jax"]))
    rt = palace_torch.run(path, str(tmp_path / "torch"))
    rj = jax_api.run(path, str(tmp_path / "jax"))
    held = logs["torch"] if kind == "jittered" else logs["torch"][:1]
    for (nt, wt), (nj, wj) in zip(held, logs["jax"]):
        assert nt == nj
        assert np.abs(wt - wj).max() <= 1e-8 * np.abs(wj).max()
    assert len(logs["torch"]) == len(logs["jax"]) == 4
    assert rt["amr_iterations"] == 3
    f_exact = 299792458.0 / 2.0 * np.sqrt(2.0) / 1.0e-2 / 1e9
    for log in logs.values():
        f = [w[0].real * _ghz_per_omega(rt) for _, w in log]
        assert abs(f[-1] - f_exact) < 0.7 * abs(f[0] - f_exact)
    assert rt["frequencies_ghz"][0].real == pytest.approx(
        logs["torch"][-1][1][0].real * _ghz_per_omega(rt), rel=1e-14)
    if kind == "jittered":
        assert abs(rj["frequencies_ghz"][0] - rt["frequencies_ghz"][0]) \
            <= 1e-8 * abs(rj["frequencies_ghz"][0])
    passes = json.loads(json.dumps(rt["provenance"]))["amr_passes"]
    assert all(p["eigen_path"] == "host-arpack" for p in passes)
    assert np.allclose([p["re_f_ghz"][0] for p in passes],
                       [w[0].real * _ghz_per_omega(rt)
                        for _, w in logs["torch"]], rtol=1e-14, atol=0)
    listing = {name: sorted(os.listdir(tmp_path / name))
               for name in ("jax", "torch")}
    assert listing["torch"] == listing["jax"]
    assert "iteration2" in listing["torch"]


def _ghz_per_omega(res):
    """GHz per unit of the run's nondimensional omega."""
    from palace_torch.config import ValueType

    return res["sop"].iodata.units.scale_factor(ValueType.FREQUENCY) / (
        2 * np.pi)


def _s_diff(a, b):
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())


def test_driven_amr_loop_matches_jax(tmp_path, monkeypatch):
    """tests/test_amr.py:105 (the TEM box between two lumped ports,
    box_tet 3^3, Order 1, MaxIts 1) through both packages: the same
    element counts, port-S.csv of iteration1 and of the final pass within
    1e-8, the same files, and one setup time a pass in the provenance."""
    from palace_torch.cases import write_amr_driven_case

    monkeypatch.setenv("PALACE_TPU_MULTICHIP", "0")
    path = write_amr_driven_case(str(tmp_path / "case"), 3, 1,
                                 linear="Default", device="CPU", verbose=0)
    with open(path) as f:
        cfg = json.load(f)
    cfg["Solver"]["Driven"]["Restart"] = 2
    with open(path, "w") as f:
        json.dump(cfg, f)
    logs = {}
    for name, module, run in (("jax", jamr, jax_api.run),
                              ("torch", tamr, palace_torch.run)):
        logs[name] = {"elements": [162], "norms": []}
        _spy(monkeypatch, module, logs[name])
        logs[name]["result"] = run(path, str(tmp_path / name))
    assert logs["torch"]["elements"] == logs["jax"]["elements"]
    assert len(logs["torch"]["elements"]) == 2
    assert np.allclose(logs["torch"]["norms"], logs["jax"]["norms"],
                       rtol=1e-8, atol=0)
    for sub in ("iteration1", ""):
        st, sj = (np.loadtxt(tmp_path / name / sub / "port-S.csv",
                             delimiter=",", skiprows=1)
                  for name in ("torch", "jax"))
        assert st.shape == sj.shape and _s_diff(st, sj) <= 1e-8
    listing = {name: sorted(os.listdir(tmp_path / name))
               for name in ("jax", "torch")}
    assert listing["torch"] == listing["jax"]
    rt = logs["torch"]["result"]
    passes = json.loads(json.dumps(rt["provenance"]))["amr_passes"]
    assert rt["amr_iterations"] == 1 and len(passes) == 2
    assert [p["elements"] for p in passes] == logs["torch"]["elements"]
    assert all(p["setup_s"] > 0 and p["solver_path"] == "direct"
               for p in passes)


@pytest.mark.parametrize("problem", ["driven", "eigen"])
def test_hex_amr_is_refused(tmp_path, problem):
    """Driven and eigenmode AMR on hexes would solve the ND system on an
    unconstrained hanging-node mesh, as palace_tpu does."""
    from palace_torch.cases import write_eigen_case, write_slice_case

    writer = write_slice_case if problem == "driven" else write_eigen_case
    path = writer(str(tmp_path), 2, 1, device="CPU", verbose=0)
    with open(path) as f:
        cfg = json.load(f)
    cfg["Model"]["Refinement"] = {"MaxIts": 1}
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(NotImplementedError, match="nonconforming ND AMR"):
        palace_torch.run(path, str(tmp_path / "torch"))
