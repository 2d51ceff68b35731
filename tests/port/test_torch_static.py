"""The electrostatic and magnetostatic paths of palace_torch against
palace_tpu: the H1 element operator (fem/operators.py:h1_operator), essential
elimination and the Jacobi preconditioner (ops/partial.py,
linalg/smoothers.py), CG (linalg/iterative.py), the Laplace and curl-curl
models and their excitations, the H1 flux indicator and both drivers end to
end (drivers/{common,electrostatic,magnetostatic}.py), plus the rings
analytics (testing/rings.py) and the rings case writer (cases.py).

Each package builds its own inputs (mesh, space, IoData) from the same
parameters.  palace_tpu's `solve_spd` is held to its single-device branch
(PALACE_TPU_MULTICHIP=0): tests/conftest.py gives JAX eight virtual CPU
devices.  Tolerances: operators and vectors 1e-12 relative (the same float64
arithmetic in another summation order), eliminated applies 1e-13, Jacobi
exactly, CG solutions 1e-10 at equal iteration counts, driver tables 1e-9
(electrostatic, CG to 1e-12) and 1e-8 (the singular curl-curl system)."""

import csv
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import palace_torch
from palace_tpu import api as jax_api
from palace_tpu.config import IoData as JaxIoData
from palace_tpu.drivers import common as jcommon
from palace_tpu.fem import operators as jops
from palace_tpu.fem.h1 import H1Space
from palace_tpu.linalg.iterative import cg as jax_cg
from palace_tpu.linalg.smoothers import jacobi as jax_jacobi
from palace_tpu.mesh import gmsh_write
from palace_tpu.mesh.generate import box_hex, box_tet
from palace_tpu.models.curlcurl import CurlCurlOperator as JaxCurlCurl
from palace_tpu.models.laplace import LaplaceOperator as JaxLaplace
from palace_tpu.ops.partial import EliminatedOperator as JaxEliminated
from palace_tpu.testing import rings as jrings
from palace_torch.cases import write_rings_case
from palace_torch.config import IoData
from palace_torch.drivers import common as tcommon
from palace_torch.fem import operators as tops
from palace_torch.fem.h1 import H1Space as TorchH1Space
from palace_torch.linalg.iterative import cg
from palace_torch.linalg.smoothers import jacobi
from palace_torch.mesh import generate as tgen
from palace_torch.models.curlcurl import CurlCurlOperator
from palace_torch.models.laplace import LaplaceOperator
from palace_torch.ops.partial import EliminatedOperator, make_ess_mask
from palace_torch.testing import rings as trings

CPU = torch.device("cpu")
DIFF = {1: np.array([[2.0, 0.3, 0.0], [0.3, 1.5, 0.1], [0.0, 0.1, 1.2]])}
MASS = {1: np.diag([0.5, 0.7, 0.9])}


def _rel(a, b):
    a = a.toarray() if hasattr(a, "toarray") else np.asarray(a)
    b = b.toarray() if hasattr(b, "toarray") else np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _spaces(kind, p):
    jm = box_hex(2, 2, 2) if kind == "hex" else box_tet(2, 2, 2)
    tm = tgen.box_hex(2, 2, 2) if kind == "hex" else tgen.box_tet(2, 2, 2)
    return H1Space(jm, p), TorchH1Space(tm, p)


def _operators(kind, p):
    js, ts = _spaces(kind, p)
    jop = jops.h1_operator(js, diffusion_coef=DIFF, mass_coef=MASS)
    top = tops.h1_operator(ts, diffusion_coef=DIFF, mass_coef=MASS,
                           device=CPU)
    return js, ts, jop, top


@pytest.mark.parametrize("kind,p", [("hex", 1), ("hex", 2), ("tet", 1),
                                    ("tet", 2)])
def test_h1_operator_matches_jax(kind, p):
    js, ts, jop, top = _operators(kind, p)
    assert ts.num_dofs == js.num_dofs
    u = np.random.default_rng(p).standard_normal(js.num_dofs)
    assert _rel(top(u).numpy(), np.asarray(jop(jnp.asarray(u)))) <= 1e-12
    assert _rel(top.diagonal().numpy(), np.asarray(jop.diagonal())) <= 1e-12
    assert _rel(top.assemble_csr(), jop.assemble_csr()) <= 1e-12


def test_per_elem_scalar_matches_jax():
    table = {1: 2.5, 3: np.diag([1.0, 2.0, 6.0])}
    attrs = np.array([3, 1, 1, 3])
    assert np.array_equal(tops._per_elem_scalar(table, attrs),
                          jops._per_elem_scalar(table, attrs))


def _mask(ts):
    return make_ess_mask(ts.num_dofs, ts.boundary_dofs([1, 5]))


def test_eliminated_operator_matches_jax():
    js, ts, jop, top = _operators("hex", 2)
    mask = _mask(ts)
    jel, tel = JaxEliminated(jop, mask), EliminatedOperator(top, mask)
    rng = np.random.default_rng(7)
    u, b, xbc = (rng.standard_normal(js.num_dofs) for _ in range(3))
    assert _rel(tel(torch.as_tensor(u)).numpy(),
                np.asarray(jel(jnp.asarray(u)))) <= 1e-13
    assert _rel(tel.eliminate_rhs(torch.as_tensor(b),
                                  torch.as_tensor(xbc)).numpy(),
                np.asarray(jel.eliminate_rhs(jnp.asarray(b),
                                             jnp.asarray(xbc)))) <= 1e-13


def test_jacobi_ess_mask_matches_jax_exactly():
    rng = np.random.default_rng(11)
    d = rng.uniform(0.5, 2.0, 40)
    d[[3, 17]] = 0.0
    mask = np.zeros(40, bool)
    mask[[3, 5, 9, 30]] = True
    r = rng.standard_normal(40)
    want = np.asarray(jax_jacobi(jnp.asarray(d), jnp.asarray(mask))(
        jnp.asarray(r)))
    got = jacobi(torch.as_tensor(d), torch.as_tensor(mask))(torch.as_tensor(r))
    assert np.array_equal(got.numpy(), want)
    plain = jacobi(torch.as_tensor(d))(torch.as_tensor(r)).numpy()
    assert np.array_equal(plain, np.asarray(jax_jacobi(jnp.asarray(d))(
        jnp.asarray(r))))


def test_cg_matches_jax():
    """Jacobi-CG on an eliminated H1 system from x0 = 0: the same iteration
    count (palace_tpu tests the residual before each body) and x to 1e-10."""
    js, ts, jop, top = _operators("hex", 2)
    mask = _mask(ts)
    jel, tel = JaxEliminated(jop, mask), EliminatedOperator(top, mask)
    b = np.random.default_rng(5).standard_normal(js.num_dofs)
    b[mask] = 0.0
    jr = jax_cg(jel, jnp.asarray(b), M=jax_jacobi(jop.diagonal(),
                                                  jnp.asarray(mask)),
                tol=1e-11, max_its=500)
    tr = cg(tel, torch.as_tensor(b), M=jacobi(top.diagonal(),
                                              torch.as_tensor(mask)),
            tol=1e-11, max_its=500)
    assert tr.converged and bool(jr.converged)
    assert tr.iterations == int(jr.iterations)
    assert _rel(tr.x.numpy(), np.asarray(jr.x)) <= 1e-10


# ---------------------------------------------------------------------------
# Models and drivers on configs


def _write_case(tmp_path, mesh, cfg):
    gmsh_write.write(mesh, str(tmp_path / "box.msh"))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _es_config(order=2, tol=1e-12):
    """Two terminals on opposite x faces, grounded z faces, an energy
    domain, a probe and a charge flux."""
    return {
        "Problem": {"Type": "Electrostatic", "Verbose": 0, "Output": "out"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1], "Permittivity": 3.0}],
                    "Postprocessing": {
                        "Energy": [{"Index": 1, "Attributes": [1]}],
                        "Probe": [{"Index": 1, "Center": [0.3, 0.4, 0.6]}]}},
        "Boundaries": {
            "Ground": {"Attributes": [5, 6]},
            "Terminal": [{"Index": 1, "Attributes": [1]},
                         {"Index": 2, "Attributes": [2]}],
            "Postprocessing": {"SurfaceFlux": [
                {"Index": 1, "Attributes": [1], "Type": "Electric"}]}},
        "Solver": {"Order": order, "Device": "CPU",
                   "Electrostatic": {"Save": 0},
                   "Linear": {"Tol": tol, "MaxIts": 2000}},
    }


def _ms_config():
    """The current sheet of tests/test_drivers_e2e.py with a probe, an
    energy domain and a magnetic flux through the z = 0 face."""
    return {
        "Problem": {"Type": "Magnetostatic", "Verbose": 0, "Output": "out"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3},
        "Domains": {"Materials": [{"Attributes": [1], "Permeability": 1.0}],
                    "Postprocessing": {
                        "Energy": [{"Index": 1, "Attributes": [1]}],
                        "Probe": [{"Index": 1, "Center": [0.4, 0.3, 0.6]}]}},
        "Boundaries": {
            "PEC": {"Attributes": [1, 2, 3, 4]},
            "SurfaceCurrent": [{"Index": 1, "Attributes": [7],
                                "Direction": [1.0, 0.0, 0.0]}],
            "Postprocessing": {"SurfaceFlux": [
                {"Index": 1, "Attributes": [5], "Type": "Magnetic"}]}},
        "Solver": {"Order": 1, "Device": "CPU",
                   "Magnetostatic": {"Save": 0},
                   "Linear": {"Tol": 1e-12, "MaxIts": 2000}},
    }


def _meshes(cfg_path, kind):
    from palace_tpu.drivers.common import prepare_mesh as jax_prepare
    from palace_tpu.mesh.mesh import canonicalize_simplices as jcanon
    from palace_torch.drivers.common import prepare_mesh as torch_prepare
    from palace_torch.mesh.mesh import canonicalize_simplices as tcanon

    jio, tio = JaxIoData(cfg_path), IoData(cfg_path)
    jm, tm = jax_prepare(jio), torch_prepare(tio)
    if kind == "tet":
        jcanon(jm)
        tcanon(tm)
    return jio, tio, jm, tm


def test_laplace_excitation_matches_jax(tmp_path):
    path = _write_case(tmp_path, box_hex(2, 2, 3), _es_config())
    jio, tio, jm, tm = _meshes(path, "hex")
    jl, tl = JaxLaplace.build(jio, jm), LaplaceOperator.build(tio, tm, CPU)
    assert np.array_equal(tl.ess_mask, jl.ess_mask)
    for idx in (1, 2):
        jx, jb = jl.excitation(idx)
        tx, tb = tl.excitation(idx)
        assert np.array_equal(tx.numpy(), np.asarray(jx))
        assert _rel(tb.numpy(), np.asarray(jb)) <= 1e-12


def test_curlcurl_excitation_matches_jax(tmp_path):
    path = _write_case(tmp_path, box_tet(2, 2, 2, sheet_j=1), _ms_config())
    jio, tio, jm, tm = _meshes(path, "tet")
    jc, tc = JaxCurlCurl.build(jio, jm), CurlCurlOperator.build(tio, tm, CPU)
    assert np.array_equal(tc.ess_mask, jc.ess_mask)
    assert tc.sources[1].elements[0]["width"] == pytest.approx(
        jc.sources[1].elements[0]["width"], rel=1e-14)
    assert _rel(tc.excitation(1).numpy(), np.asarray(jc.excitation(1))) \
        <= 1e-12


def test_h1_indicator_matches_jax(tmp_path):
    path = _write_case(tmp_path, box_hex(2, 2, 3), _es_config())
    jio, tio, jm, tm = _meshes(path, "hex")
    jl, tl = JaxLaplace.build(jio, jm), LaplaceOperator.build(tio, tm, CPU)
    V = np.random.default_rng(2).standard_normal(jl.space.num_dofs)
    want = jcommon.compute_error_indicator_h1(jio, jl.space, jl.materials, V)
    got = tcommon.compute_error_indicator_h1(tio, tl.space, tl.materials, V)
    assert _rel(got, want) <= 1e-9  # mass solves stop at relres 1e-10


def _tables(d):
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".csv"):
            with open(os.path.join(d, name)) as f:
                rows = list(csv.reader(f))
            out[name] = (rows[0], np.array(rows[1:], float))
    return out


def _compare_tables(dj, dt, tol, skip=()):
    """Every column of every CSV to `tol` relative to its largest entry.
    A probe's field components share one scale, the largest component (a
    component that vanishes by symmetry is round-off); the error indicators
    are dimensionless relative errors, held to `tol` absolute where they
    are below 1 (round-off on an exact solution).  Tables in `skip` hold
    only round-off (a flux that vanishes by symmetry) and are compared by
    their headers."""
    tj, tt = _tables(dj), _tables(dt)
    assert sorted(tt) == sorted(tj)
    for name, (head, data) in tj.items():
        assert tt[name][0] == head, name
        if name in skip:
            continue
        for j in range(data.shape[1]):
            scale = np.abs(data[:, j]).max()
            if name.startswith("probe-") and j > 0:
                scale = np.abs(data[:, 1:]).max()
            if name == "error-indicators.csv":
                scale = max(scale, 1.0)
            err = np.abs(tt[name][1][:, j] - data[:, j]).max()
            assert err <= tol * max(scale, 1e-300), (name, head[j], err,
                                                     scale)
    return sorted(tj)


def _run_both(monkeypatch, path, tmp_path):
    monkeypatch.setenv("PALACE_TPU_MULTICHIP", "0")
    rj = jax_api.run(path, str(tmp_path / "jax"))
    rt = palace_torch.run(path, str(tmp_path / "torch"))
    return rj, rt


@pytest.mark.parametrize("case", ["parallel_plate", "two_terminal"])
def test_electrostatic_matches_jax(tmp_path, monkeypatch, case):
    if case == "parallel_plate":  # tests/test_drivers_e2e.py:25
        mesh = box_hex(2, 2, 2, lx=2.0, ly=3.0, lz=0.5)
        cfg = _es_config()
        cfg["Domains"] = {"Materials": [{"Attributes": [1],
                                         "Permittivity": 4.0}]}
        cfg["Boundaries"] = {"Ground": {"Attributes": [5]},
                             "Terminal": [{"Index": 1, "Attributes": [6]}]}
    else:
        mesh, cfg = box_hex(2, 2, 3), _es_config()
    path = _write_case(tmp_path, mesh, cfg)
    rj, rt = _run_both(monkeypatch, path, tmp_path)
    assert rt["iterations"] == list(rj["iterations"])
    for key in ("C", "Cm", "Cinv"):
        assert _rel(rt[key], rj[key]) <= 1e-9, key
    names = _compare_tables(tmp_path / "jax", tmp_path / "torch", 1e-9)
    want = ["domain-E.csv", "error-indicators.csv", "terminal-C.csv",
            "terminal-Cinv.csv", "terminal-Cm.csv", "terminal-V.csv"]
    if case == "two_terminal":
        want += ["probe-E.csv", "surface-F.csv"]
    assert names == sorted(want)
    if case == "parallel_plate":
        eps0 = 8.8541878188e-12
        assert rt["C"][0, 0] == pytest.approx(
            4.0 * eps0 * (2e-3 * 3e-3) / 0.5e-3, rel=1e-9)
    assert rt["provenance"]["solver_path"] == "device-cg"
    assert max(rt["provenance"]["cg_relres"]) <= 1e-12


def test_magnetostatic_matches_jax(tmp_path, monkeypatch):
    """The current sheet in a box (tests/test_drivers_e2e.py:49): M to 1e-8
    of palace_tpu's and of mu0 Lc / 4, every table to 1e-8 (the z = 0
    face's flux vanishes by symmetry: its table is held by its header)."""
    path = _write_case(tmp_path, box_tet(2, 2, 2, sheet_j=1), _ms_config())
    rj, rt = _run_both(monkeypatch, path, tmp_path)
    assert _rel(rt["M"], rj["M"]) <= 1e-8
    assert _rel(rt["Mm"], rj["Mm"]) <= 1e-8
    assert rt["M"][0, 0] == pytest.approx(1.25663706127e-6 * 0.25e-3,
                                          rel=1e-8)
    assert abs(rt["iterations"][0] - rj["iterations"][0]) <= 3
    names = _compare_tables(tmp_path / "jax", tmp_path / "torch", 1e-8,
                            skip=("surface-F.csv",))
    assert names == ["domain-E.csv", "error-indicators.csv", "probe-B.csv",
                     "surface-F.csv", "terminal-I.csv", "terminal-M.csv",
                     "terminal-Minv.csv", "terminal-Mm.csv"]


# ---------------------------------------------------------------------------
# The rings validation module and its case


def test_rings_analytics_match_jax():
    um = 1e-6
    pairs = [
        (trings.square_loop_mutual(6 * um, 24 * um),
         jrings.square_loop_mutual(6 * um, 24 * um)),
        (trings.square_ribbon_self(6 * um, um, model="pec"),
         jrings.square_ribbon_self(6 * um, um, model="pec")),
        (trings.square_ribbon_self(24 * um, um, n=12, model="uniform"),
         jrings.square_ribbon_self(24 * um, um, n=12, model="uniform")),
        (trings.square_ribbon_mutual(6 * um, 24 * um, um, n=6),
         jrings.square_ribbon_mutual(6 * um, 24 * um, um, n=6)),
    ]
    for got, want in pairs:
        assert abs(got - want) <= 1e-14 * abs(want)
    tm = trings.rings_mesh(6.0, 24.0, 1.0, 140.0, 4.0)
    jm = jrings.rings_mesh(6.0, 24.0, 1.0, 140.0, 4.0)
    assert np.array_equal(tm.nodes, jm.nodes)
    for tb, jb in zip(tm.bdr_buckets, jm.bdr_buckets):
        assert np.array_equal(tb.conn, jb.conn)
        assert np.array_equal(tb.attr, jb.attr)
    assert (trings.ATTR_RING_A, trings.ATTR_SRC_B) == (jrings.ATTR_RING_A,
                                                       jrings.ATTR_SRC_B)


def test_rings_electrostatic_matches_jax(tmp_path, monkeypatch):
    """The rings case (`write_rings_case`) at a coarse h = 4: cracked
    interior ring sheets as terminals, grounded box."""
    path = write_rings_case(str(tmp_path), 4.0, 1, problem="Electrostatic",
                            tol=1e-10, max_its=3000, device="CPU", verbose=0)
    rj, rt = _run_both(monkeypatch, path, tmp_path)
    assert rt["num_dofs"] == rj["num_dofs"]
    # The operators agree to 2e-16, but after 150 iterations the two CG
    # residual histories drift apart by up to 10% (rounding), so the count
    # at Tol 1e-10 may differ by one.
    assert all(abs(a - b) <= 2 for a, b in zip(rt["iterations"],
                                               rj["iterations"]))
    assert _rel(rt["C"], rj["C"]) <= 1e-9
    assert rt["C"][0, 1] < 0
    _compare_tables(tmp_path / "jax", tmp_path / "torch", 1e-9)
