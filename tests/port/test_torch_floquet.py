"""Floquet problems of the port against palace_tpu's, on the CPU: the Bloch
terms of the eigenproblem and the driven sweep, and Floquet
(diffraction-order) ports.

- `nd_cross_operator` (the antisymmetric -(B - B^T) table) on tets and
  hexes, Order 2, an oblique k and an anisotropic mu: 1e-12 of the largest
  entry.
- `FloquetPortData` (the orders, gamma, e_te / e_tm, the low-rank terms,
  `excitation_rhs`, `s_parameters`) at normal and at frequency-scaled
  oblique incidence, and the Floquet parts of `SpaceOperator` (the volume
  CSRs, `stiffness_csr`, `system_csr`, the `driven_terms` coefficients at
  three omega, `floquet_mag_quad`, `floquet_port_a2_csr`,
  `floquet_lowrank`, `floquet_rhs2`): 1e-12.
- `curl_flux_indicators(floquet_k=...)`: 1e-8.
- Whole runs: tests/test_floquet.py's three eigen cases and
  tests/test_periodic.py's plain periodic box (eig.csv Re f to 1e-8), the
  two cells of tests/test_floquet_port.py (port-floquet-S.csv to 1e-8 of
  each column's largest value or 1, dB and degrees), and the Bloch-phase
  sweep on the device solver with and without FloquetReferenceFrequency,
  on tets and on a periodic hex box (domain-E.csv and
  error-indicators.csv to 1e-8, equal FGMRES iteration counts).
  palace_tpu runs in this process, its driven sweep held to one device
  (tests/conftest.py gives JAX eight).
- The device sweep's p-MG under the Bloch terms, frequency by frequency:
  lambda_max estimates (1e-12), coarse solves (1e-10) and each column's
  relres after one unconverged 8-step FGMRES cycle (1e-9).
- The adaptive PROM with FloquetReferenceFrequency against palace_tpu's
  uniform sweep (E_elec and E_mag to 2e-6, the tolerance of
  test_torch_prom.py's adaptive-against-uniform test), where palace_tpu's
  own PROM leaves the frequency-scaled terms out; adaptive sweeps with
  Floquet ports and the structured fine level on a periodic mesh are
  refused.
"""

import json
import math
import os

import jax
import numpy as np
import pytest

import palace_torch
from palace_tpu import api as jax_api
from palace_tpu.config import IoData as JaxIoData
from palace_tpu.drivers.common import prepare_mesh as jax_prepare_mesh
from palace_tpu.fem.estimators import (
    curl_flux_indicators as jax_curl_flux_indicators)
from palace_tpu.fem.nd import NDSpace as JaxNDSpace
from palace_tpu.fem.nd_operators import (
    nd_cross_operator as jax_nd_cross_operator)
from palace_tpu.mesh.generate import box_hex as jax_box_hex
from palace_tpu.mesh.generate import box_tet as jax_box_tet
from palace_tpu.mesh.mesh import canonicalize_simplices as jax_canonicalize
from palace_tpu.models.spaceoperator import SpaceOperator as JaxSpaceOperator
from palace_torch import cases
from palace_torch.config import IoData
from palace_torch.config import ValueType
from palace_torch.drivers import driven
from palace_torch.drivers.common import prepare_mesh
from palace_torch.fem.estimators import curl_flux_indicators
from palace_torch.fem.nd import NDSpace
from palace_torch.fem.nd_operators import nd_cross_operator
from palace_torch.mesh.generate import box_hex, box_tet
from palace_torch.mesh.mesh import canonicalize_simplices
from palace_torch.models.spaceoperator import SpaceOperator

#: An anisotropic, symmetric positive definite mu^-1 and an oblique k.
MU_INV = np.array([[1.2, 0.1, -0.05], [0.1, 0.8, 0.2], [-0.05, 0.2, 1.5]])
K_OBLIQUE = np.array([0.7, -1.1, 0.4])


def _rel(a, b) -> float:
    """max |a - b| / max |b| for arrays or sparse matrices."""
    if hasattr(a, "tocsr"):
        return float(abs(a - b).max() / max(abs(b).max(), 1e-300))
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _load(post, name):
    return np.atleast_2d(np.loadtxt(os.path.join(post, name), delimiter=",",
                                    skiprows=1))


def _col_rel(a, b, floor=0.0) -> float:
    """Per column max |a - b| / max(max |b|, floor), NaN where both are."""
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    out = 0.0
    for j in range(b.shape[1]):
        ok = ~np.isnan(b[:, j])
        if ok.any():
            s = max(np.abs(b[ok, j]).max(), floor, 1e-300)
            out = max(out, np.abs(a[ok, j] - b[ok, j]).max() / s)
    return out


@pytest.mark.parametrize("kind", ["tet", "hex"])
def test_nd_cross_operator_matches_jax(kind):
    gen, jgen = ((box_tet, jax_box_tet) if kind == "tet"
                 else (box_hex, jax_box_hex))
    mesh, jmesh = gen(2, 2, 2, 1.0, 0.8, 1.3), jgen(2, 2, 2, 1.0, 0.8, 1.3)
    canonicalize_simplices(mesh)
    jax_canonicalize(jmesh)
    kx = np.array([[0.0, -K_OBLIQUE[2], K_OBLIQUE[1]],
                   [K_OBLIQUE[2], 0.0, -K_OBLIQUE[0]],
                   [-K_OBLIQUE[1], K_OBLIQUE[0], 0.0]])
    coef = {1: MU_INV @ kx}
    op = nd_cross_operator(NDSpace(mesh, 2), coef)
    jop = jax_nd_cross_operator(JaxNDSpace(jmesh, 2), coef)
    A, jA = op.assemble_csr(), jop.assemble_csr()
    assert _rel(A, jA) <= 1e-12
    assert abs(A + A.T).max() == 0.0  # antisymmetric: B^T - B


def _pair(path):
    """(port SpaceOperator, palace_tpu SpaceOperator, omegas)."""
    io = IoData(path)
    jio = JaxIoData(path)
    sop = SpaceOperator(io, prepare_mesh(io))
    jsop = JaxSpaceOperator(jio, jax_prepare_mesh(jio))
    fs = io.units.scale_factor(ValueType.FREQUENCY)
    return sop, jsop, [2 * math.pi * f / fs
                       for f in driven.driven_samples_ghz(io)]


@pytest.fixture(scope="module", params=["normal", "oblique"])
def cell(request, tmp_path_factory):
    """The Floquet-port cell (box_tet 2 x 2 x 4, Order 2) at 11, 12 and 13
    GHz; "oblique" is k_F = (0.9, 0.3, 0) /cm scaled from 12 GHz."""
    kw = (dict(kf=(0.9, 0.3, 0.0), fref=12.0)
          if request.param == "oblique" else {})
    path = cases.write_floquet_cell_case(
        str(tmp_path_factory.mktemp(request.param)), 2, 2,
        freqs=(11.0, 12.0, 13.0), device="CPU", verbose=0, **kw)
    return (request.param,) + _pair(path)


def test_floquet_port_data_matches_jax(cell):
    _, sop, jsop, omegas = cell
    rng = np.random.default_rng(3)
    n = sop.space.num_dofs
    E = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    assert sorted(sop.floquet_ports) == sorted(jsop.floquet_ports) == [1, 2]
    for idx, fp in sop.floquet_ports.items():
        jfp = jsop.floquet_ports[idx]
        assert (fp.bz_m, fp.bz_n, fp.max_m, fp.max_n, fp.excitation) == (
            jfp.bz_m, jfp.bz_n, jfp.max_m, jfp.max_n, jfp.excitation)
        assert abs(fp.area - jfp.area) <= 1e-12 * jfp.area
        assert _rel(fp.normal, jfp.normal) <= 1e-12
        for om in omegas:
            fp.initialize(om)
            jfp.initialize(om)
            assert abs(fp.gamma0 - jfp.gamma0) <= 1e-12 * jfp.gamma0
            assert len(fp.orders) == len(jfp.orders)
            for o, jo in zip(fp.orders, jfp.orders):
                assert (o.m, o.n, o.out, o.dtn) == (jo.m, jo.n, jo.out,
                                                    jo.dtn)
                assert abs(o.gamma_sq - jo.gamma_sq) <= 1e-12 * max(
                    abs(jo.gamma_sq), 1.0)
                for a in ("B", "e_te", "e_tm", "v_te", "v_tm"):
                    assert _rel(getattr(o, a), getattr(jo, a)) <= 1e-12, a
            lr, jlr = fp.lowrank_terms(om), jfp.lowrank_terms(om)
            assert len(lr) == len(jlr) > 0
            for (g, v), (jg, jv) in zip(lr, jlr):
                assert abs(g - jg) <= 1e-12 * abs(jg)
                assert _rel(v, jv) <= 1e-12
            if fp.excitation:
                assert _rel(fp.excitation_rhs(om, n),
                            jfp.excitation_rhs(om, n)) <= 1e-12
            for sub in (True, False):
                S = fp.s_parameters(E, om, sub)
                jS = jfp.s_parameters(E, om, sub)
                assert S.keys() == jS.keys() and S
                assert _rel(list(S.values()), list(jS.values())) <= 1e-12


def test_floquet_port_operators_match_jax(cell):
    _, sop, jsop, omegas = cell
    assert sop.excitations() == jsop.excitations() == {1: [1]}
    assert sop.aux_bdr_attrs() == jsop.aux_bdr_attrs()
    for om in omegas:
        assert _rel(sop.floquet_port_a2_csr(om),
                    jsop.floquet_port_a2_csr(om)) <= 1e-12
        (U, g), (jU, jg) = sop.floquet_lowrank(om), jsop.floquet_lowrank(om)
        assert _rel(U, jU) <= 1e-12 and _rel(g, jg) <= 1e-12
        assert _rel(sop.floquet_rhs2(1, om), jsop.floquet_rhs2(1, om)) \
            <= 1e-12
        assert _rel(sop.system_csr(om), jsop.system_csr(om)) <= 1e-12


@pytest.mark.parametrize("fref", [0.0, 15.0])
def test_space_operator_floquet_terms_match_jax(tmp_path, fref):
    """The Bloch terms of the dipole box (box_tet 2^3, Order 2) with an
    oblique k, without and with FloquetReferenceFrequency."""
    path = cases.write_floquet_dipole_case(
        str(tmp_path), 2, 2, freqs=(14.0, 15.5, 17.0), fref=fref,
        device="CPU", verbose=0)
    with open(path) as f:
        cfg = json.load(f)
    cfg["Boundaries"]["Periodic"]["FloquetWaveVector"] = list(K_OBLIQUE)
    with open(path, "w") as f:
        json.dump(cfg, f)
    sop, jsop, omegas = _pair(path)
    assert sop.floquet_omega_ref == jsop.floquet_omega_ref
    assert (fref > 0) == (sop.floquet_omega_ref > 0)
    assert _rel(sop.floquet_k, jsop.floquet_k) <= 1e-12
    for X, jX in zip(sop.floquet_csrs(), jsop.floquet_csrs()):
        assert _rel(X, jX) <= 1e-12
    assert _rel(sop.stiffness_csr(), jsop.stiffness_csr()) <= 1e-12
    terms = {t.name: t for t in sop.driven_terms(omegas)}
    jterms = {t.name: t for t in jsop.driven_terms(omegas)}
    assert list(terms) == list(jterms)
    assert {"floquet_mass", "floquet_cross"} <= set(terms)
    rng = np.random.default_rng(4)
    n = sop.space.num_dofs
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    for om in omegas:
        assert _rel(sop.system_csr(om), jsop.system_csr(om)) <= 1e-12
        for name, t in terms.items():
            assert abs(t.coef(om) - jterms[name].coef(om)) <= 1e-12 * abs(
                jterms[name].coef(om))
        for attrs in (None, [1]):
            q, jq = (sop.floquet_mag_quad(x, om, attrs),
                     jsop.floquet_mag_quad(x, om, attrs))
            assert abs(q - jq) <= 1e-12 * abs(jq)
    for name in ("floquet_mass", "floquet_cross"):
        for (g, A), (jg, jA) in zip(terms[name].tables, jterms[name].tables):
            np.testing.assert_array_equal(g, jg)
            assert _rel(A, jA) <= 1e-12


def test_floquet_indicators_match_jax(tmp_path):
    path = cases.write_floquet_dipole_case(str(tmp_path), 2, 2,
                                           device="CPU", verbose=0)
    sop, jsop, _ = _pair(path)
    rng = np.random.default_rng(6)
    n = sop.space.num_dofs
    E = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    for k in (sop.floquet_k, K_OBLIQUE):
        eta = curl_flux_indicators(sop.space, sop.materials, E, floquet_k=k)
        jeta = jax_curl_flux_indicators(jsop.space, jsop.materials, E,
                                        floquet_k=k)
        assert _rel(eta, jeta) <= 1e-8
    plain = curl_flux_indicators(sop.space, sop.materials, E)
    assert _rel(eta, plain) > 1e-3  # the correction does something


def _runs(tmp_path, write, **kw):
    """The config `write` makes, run by the port and by palace_tpu (its
    driven sweep on one device); returns (port result, the two output
    directories)."""
    posts = {}
    for tag in ("torch", "jax"):
        posts[tag] = os.path.dirname(write(str(tmp_path / tag), device="CPU",
                                           verbose=0, **kw))
    res = palace_torch.run(os.path.join(posts["torch"], "case.json"))
    real_count = jax.device_count
    jax.device_count = lambda *a: 1
    try:
        jax_api.run(os.path.join(posts["jax"], "case.json"))
    finally:
        jax.device_count = real_count
    return res, {t: os.path.join(p, "postpro") for t, p in posts.items()}


#: tests/test_floquet.py's three cases and tests/test_periodic.py's box
#: (the same cube without a Floquet wave vector): kx, N, Target.
EIGEN_CASES = {"forward": (2.0, 2, 17.0), "backward": (2.0, 1, 24.5),
               "bz-wrapped": (1.5 + 2 * math.pi, 1, 16.0),
               "periodic": (0.0, 2, 15.0)}


@pytest.mark.parametrize("case", sorted(EIGEN_CASES))
def test_floquet_eigen_runs_match_jax(tmp_path, case):
    kx, modes, target = EIGEN_CASES[case]
    res, post = _runs(tmp_path, lambda d, **kw: cases.write_floquet_box_case(
        d, 3, 2, kx=kx, modes=modes, target=target, **kw))
    eig_t, eig_j = _load(post["torch"], "eig.csv"), _load(post["jax"],
                                                           "eig.csv")
    assert eig_t.shape == eig_j.shape == (modes, 6)
    assert _rel(eig_t[:, 1], eig_j[:, 1]) <= 1e-8
    assert res["provenance"]["eigen_path"] == "host-arpack"
    # The analytic modes, to the tolerances of the palace_tpu tests.
    exact = cases.floquet_box_freq(math.remainder(kx, 2 * math.pi),
                                   -1 if case == "backward" else 0)
    tol = 2e-2 if case == "backward" else 6e-3
    assert np.abs(eig_t[:, 1] / exact - 1.0).max() < tol
    # Per mode E_elec = E_mag (the Floquet magnetic energy included); the
    # modes of a degenerate pair are not compared between packages.
    dom = _load(post["torch"], "domain-E.csv")
    assert np.abs(dom[:, 2] / dom[:, 1] - 1.0).max() < 1e-6
    if kx:
        route = res["provenance"]["estimator_mass_route"]
        assert set(route) == {"device-cg"}


@pytest.mark.parametrize("incidence", ["normal", "oblique"])
def test_floquet_cell_runs_match_jax(tmp_path, incidence):
    kw = (dict(kf=(0.9, 0.0, 0.0), fref=12.0) if incidence == "oblique"
          else {})
    res, post = _runs(tmp_path, lambda d, **k: cases.write_floquet_cell_case(
        d, 3, 2, **k, **kw))
    assert res["provenance"]["solver_path"] == "direct"
    for name in ("port-floquet-S.csv", "domain-E.csv"):
        a, b = _load(post["torch"], name), _load(post["jax"], name)
        assert _col_rel(a, b, floor=1.0) <= 1e-8, name
    S = res["measurements"][(1, 0)].floquet_s
    assert abs(abs(S[2][(0, 0, True)]) - 1.0) < 0.05
    assert abs(S[1][(0, 0, True)]) < 0.08


@pytest.mark.parametrize("case", ["tet", "tet-fref", "hex"])
def test_bloch_device_sweep_matches_jax(tmp_path, case):
    """The dipole box on the device FGMRES + p-MG (the element fine level:
    the structured one refuses the periodic hex box)."""
    kw = dict(tol=1e-10)
    if case == "tet-fref":
        kw.update(fref=15.0, freqs=(14.0, 15.5, 17.0))
    if case == "hex":
        kw.update(hex_mesh=True)
    res, post = _runs(tmp_path, lambda d, **k:
                      cases.write_floquet_dipole_case(d, 2, 2, **k, **kw))
    prov = res["provenance"]
    assert prov["solver_path"] == "device"
    assert prov["fine_level"] == "element"
    for name in ("domain-E.csv", "error-indicators.csv"):
        a, b = _load(post["torch"], name), _load(post["jax"], name)
        assert _col_rel(a, b) <= 1e-8, name
    its = []
    for p in post.values():
        with open(os.path.join(p, "palace.json")) as f:
            its.append(json.load(f)["LinearSolver"]["TotalIts"])
    assert its[0] == its[1] > 0


@pytest.mark.parametrize("fref", [0.0, 15.0])
def test_bloch_pmg_matches_jax(tmp_path, fref):
    """The p-MG of the device sweep under the Bloch terms (the cross
    table is antisymmetric with a zero diagonal, its coefficient i or
    i omega) on the dipole box (box_tet 3^3, Order 2), frequency by
    frequency against palace_tpu's: the smoothers' lambda_max estimates
    on every level and its auxiliary level (1e-12), the coarse
    factorization (a solve, 1e-10), and each column's relres after one
    FGMRES cycle of 8 steps (1e-9 relative).  The cycle stops well short
    of convergence: a converged run's count, one cycle of `restart` steps
    a column, would not show a weaker preconditioner."""
    from palace_torch.linalg.device_ksp import BlockedDeviceSolver
    from palace_tpu.linalg.device_ksp import (
        BlockedDeviceSolver as JaxBlockedDeviceSolver)

    path = cases.write_floquet_dipole_case(str(tmp_path), 3, 2, fref=fref,
                                           device="CPU", verbose=0)
    sop, jsop, omegas = _pair(path)
    pec = sop.iodata.boundaries.pec
    kw = dict(tol=1e-14, max_its=8, restart=8)
    tsolver = BlockedDeviceSolver(sop.space, pec, sop.driven_terms(omegas),
                                  omegas, sop.ess_mask, **kw)
    jsolver = JaxBlockedDeviceSolver(jsop.space, pec,
                                     jsop.driven_terms(omegas), omegas,
                                     jsop.ess_mask, **kw)
    assert tsolver.structured is None
    names = [t.name for t in tsolver.terms]
    assert {"floquet_mass", "floquet_cross"} <= set(names)
    cross = tsolver.terms[names.index("floquet_cross")]
    for w in omegas:  # purely imaginary: i, or i omega under fref
        c = cross.coef(w)
        assert c.real == 0.0 and c.imag > 0.0
    assert _rel(tsolver._lmax_all, jsolver._lmax_all) <= 1e-12
    assert _rel(tsolver._aux_lmax_all, jsolver._aux_lmax_all) <= 1e-12
    rng = np.random.default_rng(8)
    nc = tsolver._levels[-1]["n"]
    b = rng.standard_normal(nc) + 1j * rng.standard_normal(nc)
    for lu, jlu in zip(tsolver._coarse_lus, jsolver._coarse_lus):
        assert _rel(lu.solve(b), jlu.solve(b)) <= 1e-10
    rhs = np.stack([driven._rhs(sop, next(iter(sop.excitations())), w)
                    for w in omegas], axis=1)
    _, info = tsolver.solve(rhs)
    _, jinfo = jsolver.solve(rhs)
    assert np.array_equal(info["iterations"], [8] * len(omegas))
    assert np.array_equal(info["iterations"], jinfo["iterations"])
    assert (info["relres"] > 1e-12).all()  # not converged: informative
    assert np.abs(info["relres"] / jinfo["relres"] - 1.0).max() <= 1e-9


def test_adaptive_prom_with_reference_frequency(tmp_path):
    """The port's adaptive sweep against palace_tpu's uniform one on the
    dipole box (box_tet 3^3, Order 2, k 2 /cm, FloquetReferenceFrequency
    15 GHz, 14-17 GHz; sparse-direct solves: the fix is in the reduced
    system, which both HDM routes share)."""
    freqs = [14.0, 15.0, 16.0, 17.0]
    kw = dict(fref=15.0, tol=1e-10, fstep=1.0, linear="SuperLU")
    ta = cases.write_floquet_dipole_case(str(tmp_path / "a"), 3, 2,
                                         adaptive_tol=1e-6, device="CPU",
                                         verbose=0, **kw)
    res = palace_torch.run(ta)
    assert res["provenance"]["solver_path"] == "prom-adaptive"
    assert res["prom"].stopped_by == {1: "memory"}
    _, post = _runs(tmp_path / "u", lambda d, **k:
                    cases.write_floquet_dipole_case(d, 3, 2, freqs=freqs,
                                                    **k, **kw))
    a = _load(os.path.join(os.path.dirname(ta), "postpro"), "domain-E.csv")
    b = _load(post["jax"], "domain-E.csv")
    assert a.shape == b.shape
    for col in (1, 2):  # E_elec, E_mag
        assert _rel(a[:, col], b[:, col]) <= 2e-6


def test_adaptive_sweep_with_floquet_ports_is_refused(tmp_path):
    path = cases.write_floquet_cell_case(str(tmp_path), 2, 1, device="CPU",
                                         verbose=0)
    with open(path) as f:
        cfg = json.load(f)
    cfg["Solver"]["Driven"] = {"MinFreq": 11.0, "MaxFreq": 13.0,
                               "FreqStep": 0.5, "AdaptiveTol": 1e-6}
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(NotImplementedError,
                       match="adaptive sweeps with Floquet ports"):
        palace_torch.run(path)


def test_structured_fine_level_refuses_periodic_meshes(tmp_path):
    from palace_torch.ops.structured import StructuredTermApply

    path = cases.write_floquet_dipole_case(str(tmp_path), 2, 2,
                                           hex_mesh=True, device="CPU",
                                           verbose=0)
    io = IoData(path)
    sop = SpaceOperator(io, prepare_mesh(io))
    assert sop.mesh.node_ident is not None
    with pytest.raises(ValueError, match="periodic mesh"):
        StructuredTermApply.build(sop.space, sop.driven_terms(),
                                  sop.ess_mask, sop.device)


def test_floquet_ports_need_a_driven_problem(tmp_path):
    path = cases.write_floquet_cell_case(str(tmp_path), 2, 1, device="CPU",
                                         verbose=0)
    with open(path) as f:
        cfg = json.load(f)
    cfg["Problem"]["Type"] = "Eigenmode"
    cfg["Solver"]["Eigenmode"] = {"N": 1, "Target": 10.0}
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="only available for driven"):
        palace_torch.run(path)
