"""2D meshes in the port against palace_tpu, on the CPU.

- The structured fine level refuses a 2D mesh with ValueError (palace_tpu's
  probe raises IndexError there), so every 2D device solve takes the
  element fine level.
- The 2D curl-flux indicators (out-of-plane flux projected onto scalar
  H1) and the RT grad-flux indicators on a seeded random complex ND field,
  on jittered triangles and quadrilaterals: 1e-10 of the largest.
- Whole runs on the decks of `palace_torch.cases` (rect_mesh):
  - the matched 2D plate line between two lumped ports on the port's
    device FGMRES + p-MG (`solver_path` "device", element fine level)
    against palace_tpu's sweep (its device probe fails on 2D, so it
    solves sparse direct): port-S, port-V, port-I and domain-E to 1e-8
    of each column's largest value; |S21| to 1 and arg S21 to -k0 L;
    the surface-F/Q tables of its 2D traces too;
  - the line ended by a first-order Absorbing boundary under an Impedance
    plate: port-V/I, domain-E and error-indicators to 1e-8;
  - the 2D adaptive PROM against the port's own uniform sweep, its HDM
    samples on the device solver;
  - the port's device-Lanczos eigensolve against palace_tpu's host ARPACK:
    eig.csv to 1e-9 and the analytic PEC-rectangle modes;
  - a few GeneralizedAlpha steps of the plate line: every table to 1e-10;
  - a 2D magnetostatic run whose CG reaches Tol in both packages:
    terminal-M and domain-E to 1e-8.
- 2D boundaries palace_tpu refuses or fails on: wave ports on a port line
  (its message), second-order Absorbing (a clear refusal where palace_tpu
  fails in a matmul) and a Floquet wave vector.
palace_tpu runs in this process on one device (tests/conftest.py gives JAX
eight)."""

import math
import os

import jax
import numpy as np
import pytest
import torch

import palace_torch
from palace_torch import cases
from palace_torch.config import IoData
from palace_torch.drivers.common import prepare_mesh
from palace_torch.fem.estimators import (curl_flux_indicators,
                                         grad_flux_indicators)
from palace_torch.fem.nd import NDSpace
from palace_torch.mesh import gmsh_write
from palace_torch.mesh.mesh import canonicalize_simplices, load_mesh
from palace_torch.models.materials import MaterialOperator
from palace_torch.models.spaceoperator import SpaceOperator
from palace_torch.ops.structured import StructuredTermApply
from palace_torch.utils.constants import C0
from palace_tpu import api as jax_api
from palace_tpu.fem.estimators import (
    curl_flux_indicators as jax_curl_flux_indicators,
    grad_flux_indicators as jax_grad_flux_indicators)
from palace_tpu.fem.nd import NDSpace as JaxNDSpace
from palace_tpu.mesh.mesh import canonicalize_simplices as jax_canonicalize
from palace_tpu.mesh.mesh import load_mesh as jax_load_mesh
from palace_tpu.models.materials import MaterialOperator as JaxMaterials


def _load(post, name):
    return np.atleast_2d(np.loadtxt(os.path.join(post, name), delimiter=",",
                                    skiprows=1))


def _col_rel(a, b) -> float:
    """max over columns of max |a - b| / max |b| (a column of zeros in both
    compares exactly)."""
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    assert a.shape == b.shape
    scale = np.maximum(np.abs(b).max(axis=0), 1e-300)
    return float((np.abs(a - b).max(axis=0) / scale).max())


def _runs(tmp_path, monkeypatch, write, jax_kw=None, **kw):
    """The config `write` makes, run by the port and by palace_tpu (on one
    device; `jax_kw` overrides the writer's arguments for palace_tpu's
    copy); returns (port result, the two output directories)."""
    monkeypatch.setenv("PALACE_TPU_MULTICHIP", "0")
    posts = {}
    for tag in ("torch", "jax"):
        args = dict(kw, **(jax_kw or {})) if tag == "jax" else kw
        posts[tag] = os.path.dirname(write(str(tmp_path / tag), device="CPU",
                                           verbose=0, **args))
    res = palace_torch.run(os.path.join(posts["torch"], "case.json"))
    real_count = jax.device_count
    jax.device_count = lambda *a: 1
    try:
        jax_api.run(os.path.join(posts["jax"], "case.json"))
    finally:
        jax.device_count = real_count
    return res, {t: os.path.join(p, "postpro") for t, p in posts.items()}


def _rect_pair(tmp_path, quad):
    path = str(tmp_path / "r.msh")
    gmsh_write.write(cases.rect_mesh(4, 3, 2.0, 1.0, quad=quad, jitter=0.2),
                     path)
    mesh, jmesh = load_mesh(path), jax_load_mesh(path)
    canonicalize_simplices(mesh)
    jax_canonicalize(jmesh)
    return mesh, jmesh


@pytest.mark.parametrize("quad", [False, True], ids=["tri", "quad"])
def test_structured_probe_refuses_2d(tmp_path, quad):
    """A 2D mesh raises ValueError in the structured probe (palace_tpu:
    IndexError at its third centroid axis), so the device solver takes the
    element fine level."""
    from palace_torch.linalg.device_ksp import BlockedDeviceSolver

    mesh, _ = _rect_pair(tmp_path, quad)
    assert mesh.nodes.shape[1] == 2
    space = NDSpace(mesh, 2)
    with pytest.raises(ValueError, match="3D hexahedral"):
        StructuredTermApply.build(space, [], np.zeros(space.num_dofs, bool),
                                  torch.device("cpu"))
    cfg = cases.write_plate_line_case(str(tmp_path / "c"), 20.0, 4, 1, 1,
                                      device="CPU", verbose=0)
    iodata = IoData(cfg)
    sop = SpaceOperator(iodata, prepare_mesh(iodata))
    omegas = [0.5, 0.7]
    solver = BlockedDeviceSolver(sop.space, iodata.boundaries.pec,
                                 sop.driven_terms(omegas), omegas,
                                 sop.ess_mask)
    assert solver.structured is None


@pytest.mark.parametrize("quad", [False, True], ids=["tri", "quad"])
def test_2d_indicators_match_jax(tmp_path, quad):
    """The 2D curl-flux indicators and (on triangles; RT spaces on
    quadrilaterals are refused in both packages) the grad-flux indicators
    of a seeded random complex field, with an anisotropic eps and mu_zz 2:
    1e-10 of the largest."""
    mesh, jmesh = _rect_pair(tmp_path, quad)
    eps = {1: np.diag([2.0, 3.0, 1.5])}
    muinv = {1: np.diag([1.0, 1.0, 0.5])}
    zero = {1: np.zeros((3, 3))}
    mats = MaterialOperator(eps, muinv, zero, zero, {})
    jmats = JaxMaterials(eps, muinv, zero, zero, {})
    space, jspace = NDSpace(mesh, 2), JaxNDSpace(jmesh, 2)
    rng = np.random.default_rng(11)
    E = rng.standard_normal(space.num_dofs) \
        + 1j * rng.standard_normal(space.num_dofs)
    eta = curl_flux_indicators(space, mats, E)
    jeta = jax_curl_flux_indicators(jspace, jmats, E)
    assert np.abs(eta - jeta).max() <= 1e-10 * np.abs(jeta).max()
    assert np.abs(jeta).max() > 0
    if quad:
        with pytest.raises(NotImplementedError):
            grad_flux_indicators(space, mats, E)
        return
    g, jg = grad_flux_indicators(space, mats, E), jax_grad_flux_indicators(
        jspace, jmats, E)
    assert np.abs(g - jg).max() <= 1e-10 * np.abs(jg).max()


#: The plate line of the driven tests: 20 mm, 10 x 2 cells, Order 2.
LINE = dict(length=20.0, n_len=10, n_h=2, order=2)


def test_device_driven_sweep_matches_jax(tmp_path, monkeypatch):
    """The port's device sweep (GMG at Tol 1e-12, element fine level)
    against palace_tpu's (its device probe fails on 2D, so it solves
    sparse direct), with SurfaceFlux and Dielectric tables on the 2D
    traces; the matched line passes the wave unreflected."""
    post = {"SurfaceFlux": [{"Index": 1, "Attributes": [2], "Type": "Power"},
                            {"Index": 2, "Attributes": [1],
                             "Type": "Electric"}],
            "Dielectric": [{"Index": 1, "Attributes": [1], "Thickness": 1e-3,
                            "Permittivity": 10.0, "LossTan": 1e-3}]}

    def write(d, **kw):
        import json

        path = cases.write_plate_line_case(d, **LINE, tol=1e-12, **kw)
        with open(path) as f:
            cfg = json.load(f)
        cfg["Boundaries"]["Postprocessing"] = post
        with open(path, "w") as f:
            json.dump(cfg, f)
        return path

    res, out = _runs(tmp_path, monkeypatch, write)
    prov = res["provenance"]
    assert prov["solver_path"] == "device"
    assert prov["fine_level"] == "element"
    assert set(prov["estimator_mass_route"]) == {"device-cg"}
    for name in ("port-V.csv", "port-I.csv", "domain-E.csv", "surface-F.csv",
                 "surface-Q.csv"):
        assert _col_rel(_load(out["torch"], name),
                        _load(out["jax"], name)) <= 1e-8, name
    s, js = _load(out["torch"], "port-S.csv"), _load(out["jax"], "port-S.csv")
    # |S21| (dB) and arg S21 (deg); |S11| sits at round-off (-150 dB).
    assert np.abs(s[:, 3:] - js[:, 3:]).max() <= 1e-8 * 180.0
    assert np.abs(s[:, 3]).max() < 1e-8  # |S21| = 1 to 1e-9
    assert s[:, 1].max() < -100.0
    f = s[:, 0] * 1e9
    phase = np.angle(np.exp(-1j * 2 * math.pi * f / C0 * 20e-3), deg=True)
    assert np.abs(s[:, 4] - phase).max() < 0.05
    # E_mag and its domain column are 0 on a 2D mesh, as in palace_tpu.
    dom = _load(out["torch"], "domain-E.csv")
    assert np.all(dom[:, 2] == 0.0) and np.all(dom[:, 7] == 0.0)


def test_2d_impedance_and_absorbing_match_jax(tmp_path, monkeypatch):
    """The other boundaries a 2D mesh takes: the plate line ended by a
    first-order Absorbing boundary in place of port 2, its top plate an
    Impedance (Rs 50 Ohm, Ls 0.1 nH) in place of PEC, on the device sweep
    against palace_tpu's: port-V, port-I, domain-E and error-indicators to
    1e-8 of each column's largest value."""
    def write(d, **kw):
        import json

        path = cases.write_plate_line_case(d, **dict(LINE, n_len=6),
                                           tol=1e-12, **kw)
        with open(path) as f:
            cfg = json.load(f)
        b = cfg["Boundaries"]
        b["LumpedPort"] = b["LumpedPort"][:1]
        b["PEC"] = {"Attributes": [1]}
        b["Absorbing"] = {"Attributes": [2], "Order": 1}
        b["Impedance"] = [{"Attributes": [3], "Rs": 50.0, "Ls": 1e-10}]
        with open(path, "w") as f:
            json.dump(cfg, f)
        return path

    res, out = _runs(tmp_path, monkeypatch, write)
    assert res["provenance"]["solver_path"] == "device"
    for name in ("port-V.csv", "port-I.csv", "domain-E.csv",
                 "error-indicators.csv"):
        assert _col_rel(_load(out["torch"], name),
                        _load(out["jax"], name)) <= 1e-8, name
    # C: port 1's R, the sheet's Rs and the absorbing rim; K: the sheet's Ls.
    assert (len(res["sop"].C_bdr), len(res["sop"].K_bdr)) == (3, 1)


def test_adaptive_prom_matches_uniform_sweep(tmp_path):
    """The 2D adaptive PROM (HDM samples on the device solver) against the
    port's uniform device sweep at the same frequencies."""
    ad = palace_torch.run(cases.write_plate_line_case(
        str(tmp_path / "ad"), **dict(LINE, n_len=6), adaptive=True,
        device="CPU", verbose=0))
    freqs = [2.0 + 0.8 * k for k in range(11)]
    un = palace_torch.run(cases.write_plate_line_case(
        str(tmp_path / "un"), **dict(LINE, n_len=6), freqs=freqs,
        device="CPU", verbose=0))
    prov = ad["provenance"]
    assert prov["solver_path"] == "prom-adaptive"
    assert prov["prom_hdm_path"] == "device"
    assert prov.get("prom_hdm_direct_fallbacks", 0) == 0
    a = _load(os.path.join(str(tmp_path / "ad"), "postpro"), "port-V.csv")
    u = _load(os.path.join(str(tmp_path / "un"), "postpro"), "port-V.csv")
    rows = [int(round((f - 2.0) / 0.1)) for f in freqs]
    assert np.allclose(a[rows, 0], u[:, 0])
    assert _col_rel(a[rows, 1:], u[:, 1:]) <= 1e-6


def test_device_lanczos_matches_jax_arpack(tmp_path, monkeypatch):
    """The port's device Lanczos (GMG) against palace_tpu's host ARPACK
    (Linear Default on a small mesh) on the PEC rectangle, 4 x 2 cells at
    Order 3: eig.csv Re f to 1e-9, the analytic (1, 0) and (2, 0) modes to
    3e-5 (at most 1.52e-5 at this size), E_mag 0 and p_mag 1, as
    palace_tpu writes them."""
    res, out = _runs(tmp_path, monkeypatch,
                     lambda d, **kw: cases.write_rect_eigen_case(
                         d, 4, 2, 3, modes=2, **kw),
                     linear="GMG", jax_kw={"linear": "Default"})
    assert res["provenance"]["eigen_path"] == "device-lanczos"
    assert res["provenance"]["fine_level"] == "element"
    e, je = _load(out["torch"], "eig.csv"), _load(out["jax"], "eig.csv")
    assert np.abs(e[:, 1] / je[:, 1] - 1.0).max() <= 1e-9
    exact = [cases.rect_mode_freq(1, 0), cases.rect_mode_freq(2, 0)]
    assert np.abs(e[:, 1] / exact - 1.0).max() < 3e-5
    assert _col_rel(_load(out["torch"], "domain-E.csv"),
                    _load(out["jax"], "domain-E.csv")) <= 1e-8
    assert _col_rel(_load(out["torch"], "error-indicators.csv"),
                    _load(out["jax"], "error-indicators.csv")) <= 1e-6


def test_generalized_alpha_steps_match_jax(tmp_path, monkeypatch):
    """Ten GeneralizedAlpha steps of the 2D plate line: port-V/I, domain-E
    and error-indicators.csv to 1e-10 of each column's largest value."""
    res, out = _runs(tmp_path, monkeypatch,
                     lambda d, **kw: cases.write_plate_line_case(
                         d, **LINE, problem="Transient", max_time=0.02,
                         **kw))
    for name in ("port-V.csv", "port-I.csv", "domain-E.csv",
                 "error-indicators.csv"):
        assert _col_rel(_load(out["torch"], name),
                        _load(out["jax"], name)) <= 1e-10, name
    assert _load(out["torch"], "port-V.csv").shape[0] == 11
    assert set(res["provenance"]["estimator_mass_route"]) == {"device-cg"}


def test_magnetostatic_matches_jax(tmp_path, monkeypatch):
    """The 2D magnetostatic deck whose CG reaches Tol in both packages:
    terminal-M/Minv/Mm and domain-E to 1e-8.  Its field is exact on any
    mesh (B_z constant), so its indicators are round-off and are held only
    through `test_2d_indicators_match_jax`."""
    res, out = _runs(tmp_path, monkeypatch,
                     lambda d, **kw: cases.write_rect_magnetostatic_case(
                         d, 6, 3, 2, **kw))
    for name in ("terminal-M.csv", "terminal-Minv.csv", "terminal-Mm.csv",
                 "domain-E.csv"):
        assert _col_rel(_load(out["torch"], name),
                        _load(out["jax"], name)) <= 1e-8, name
    assert res["provenance"]["cg_relres"][0] <= 1e-10


@pytest.mark.parametrize("case", ["waveport", "absorbing2", "floquet"])
def test_2d_refusals(tmp_path, case):
    """Wave ports on a 2D mesh refuse with palace_tpu's message (a port
    line has no facets of the port's kind); second-order Absorbing
    boundaries and a Floquet wave vector need a 3D mesh."""
    iodata = IoData(cases.write_plate_line_case(
        str(tmp_path), 20.0, 4, 1, 1, device="CPU", verbose=0))
    b = iodata.boundaries
    if case == "waveport":
        from palace_torch.config.schema import WavePortConfig

        b.lumped_ports = []
        b.wave_ports = [WavePortConfig(index=1, attributes=[4],
                                       excitation=True)]
        match = "wave port 1: no boundary facets"
        err = ValueError
    elif case == "absorbing2":
        from palace_torch.config.schema import AbsorbingConfig

        b.absorbing = AbsorbingConfig(attributes=[2], order=2)
        match, err = "3D mesh", NotImplementedError
    else:
        b.floquet_wave_vector = [0.1, 0.0, 0.0]
        match, err = "3D mesh", NotImplementedError
    with pytest.raises(err, match=match):
        SpaceOperator(iodata, prepare_mesh(iodata))


def test_plate_line_r_matches_the_2d_port_geometry(tmp_path):
    """The matched R of `cases.plate_line_r` is eta0 d / Lc: a 2D lumped
    port has length d along its direction and unit (nondimensional) depth,
    so its sheet impedance R w / l is eta0."""
    iodata = IoData(cases.write_plate_line_case(
        str(tmp_path), 20.0, 4, 1, 1, device="CPU", verbose=0))
    sop = SpaceOperator(iodata, prepare_mesh(iodata))
    port = sop.ports[1]
    (elem,) = port.elems
    assert elem.w == 1.0
    assert elem.l == pytest.approx(cases.PLATE_D / 20.0, rel=1e-12)
    # Nondimensional impedances are in units of eta0.
    assert port.R * elem.w / elem.l == pytest.approx(1.0, rel=1e-12)
