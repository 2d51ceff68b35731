"""The transient driver of palace_torch against palace_tpu on the CPU.

- The copied steppers (generalized-alpha, SDIRK23, the adaptive SDIRK and
  BDF) against palace_tpu's on the forced oscillators of
  tests/test_driven_transient.py:230-260, scalar and vector, to 1e-14.
- The six pulse shapes and their derivatives against palace_tpu's.
- `palace_torch.run` against `palace_tpu.run` on the TEM line at box_tet
  4 x 3 x 3, Order 2, 13 steps (GeneralizedAlpha and ARKODE; one
  palace_tpu run a scheme; a probe and a domain energy): port-V/I,
  domain-E and probe-E/B within 1e-10 of each column's maximum,
  error-indicators.csv within 1e-8; every indicator mass solve on the
  device CG.
- RungeKutta and CVODE through the port against its GeneralizedAlpha
  (5e-2 of the peak |V2|, tests/test_driven_transient.py:366); the
  adaptive schemes at the reference's default RelTol and AbsTol.
- The route of the indicators' mass solves: forcing the sparse-direct
  rescue (CG capped at one iteration) is recorded as "host-splu".
- Refusals inherited from palace_tpu (Conductivity boundaries, more than
  one excitation) and its AMR warning; an indicator's NotImplementedError
  propagates (palace_tpu drops the indicators quietly)."""

import math
import os

import numpy as np
import pytest

import palace_torch
from palace_torch.cases import write_tem_line_case
from palace_torch.drivers import transient as ttr
from palace_torch.utils import excitations as texc
from palace_tpu.drivers import transient as jtr
from palace_tpu.utils import excitations as jexc

#: The small line: 10 mm, 4 cells along it and 3 across, Order 2, 13 steps
#: of 0.005 ns of the 10 GHz ModulatedGaussian pulse of width 0.08 ns of
#: tests/test_driven_transient.py:343 (the rising edge of the pulse).  The
#: adaptive schemes run at the reference's default tolerances (RelTol
#: 1e-4, AbsTol 1e-9): at 1e-6 and 1e-12 ARKODE takes 13,088 internal
#: steps here.
LINE = dict(length=10.0, n_len=4, n_cross=3, order=2, domain_post={
    "Probe": [{"Index": 1, "Center": [6.0, 4.0, 5.5]}],
    "Energy": [{"Index": 1, "Attributes": [1]}]})
PULSE = dict(excitation_freq=10.0, excitation_width=0.08, max_time=0.06,
             time_step=0.005)


class _ScalarOscillator:
    """M u1' = -(K u2 + C u1) + g'(t), u2' = u1 (M = 1, K one stiffness a
    component), through the implicit_solve and mult interface of
    TransientOperator."""

    def __init__(self, K=400.0, C=1.5):
        self.K, self.C = K, C

    def dJ(self, t):
        return math.exp(-0.5 * ((t - 0.5) / 0.1) ** 2)

    def rhs(self, u1, u2, t):
        return -(self.K * u2 + self.C * u1) + self.dJ(t)

    def implicit_solve(self, dt, u1, u2, t):
        A = 1.0 + dt * dt * self.K + dt * self.C
        k1 = (self.rhs(u1, u2, t) - dt * self.K * u1) / A
        return k1, u1 + dt * k1

    def mult(self, u1, u2, t):
        return self.rhs(u1, u2, t), u1


def _oscillator(vector: bool):
    return _ScalarOscillator(K=np.array([400.0, 100.0, 900.0])
                             if vector else np.array([400.0]))


def _run_fixed(mod, name, vector):
    op = _oscillator(vector)
    ode = getattr(mod, name)(op)
    x, t = tuple(np.zeros(op.K.size) for _ in range(3)), 0.0
    out = []
    for _ in range(60):
        x, t = ode.step(x, t, 1.0 / 60)
        out.append(np.concatenate(x))
    return np.array(out)


def _run_adaptive(mod, name, vector):
    op = _oscillator(vector)
    ode = getattr(mod, name)(op, 1e-6, 1e-12)
    x, t = tuple(np.zeros(op.K.size) for _ in range(3)), 0.0
    out = []
    for i in range(1, 11):
        x, t = ode.advance(x, t, 0.1 * i, 0.05)
        out.append(np.concatenate(x))
    return np.array(out), ode.n_steps, ode.n_rejected


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("name", ["GeneralizedAlpha", "SDIRK23"])
def test_fixed_steppers_match_jax(name, vector):
    got = _run_fixed(ttr, name, vector)
    want = _run_fixed(jtr, name, vector)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("name", ["AdaptiveSDIRK", "AdaptiveBDF"])
def test_adaptive_steppers_match_jax(name, vector):
    got, n_got, r_got = _run_adaptive(ttr, name, vector)
    want, n_want, r_want = _run_adaptive(jtr, name, vector)
    assert (n_got, r_got) == (n_want, r_want) and n_got > 10
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()


def test_wrms_matches_jax():
    rng = np.random.default_rng(3)
    err = [rng.standard_normal(7) for _ in range(3)]
    x = [rng.standard_normal(7) for _ in range(3)]
    assert ttr._WRMS(1e-4, 1e-9)(err, x) == jtr._WRMS(1e-4, 1e-9)(err, x)


@pytest.mark.parametrize("kind", ["Sinusoidal", "Gaussian",
                                  "DifferentiatedGaussian",
                                  "ModulatedGaussian", "Ramp",
                                  "SmootherStep"])
@pytest.mark.parametrize("dot", [False, True], ids=["g", "dg"])
def test_pulses_match_jax(kind, dot):
    class Cfg:
        excitation = kind
        pulse_f = 2 * math.pi * 3.0
        pulse_tau = 0.15

    ts = np.linspace(-0.2, 1.5, 171)
    got = np.array([texc.get_excitation(Cfg, dot)(t) for t in ts])
    want = np.array([jexc.get_excitation(Cfg, dot)(t) for t in ts])
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)


def _table(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def _col_rel(a, b):
    """Max over columns of max |a - b| / max |b| (columns of zeros: abs)."""
    scale = np.abs(b).max(axis=0)
    return float((np.abs(a - b).max(axis=0)
                  / np.where(scale > 0, scale, 1.0)).max())


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """palace_tpu's run of the small line, one a scheme, on one device and
    one BLAS thread, as the port's tests run (tests/port/conftest.py): the
    adaptive controller's accept and hysteresis decisions follow the
    round-off of the sparse solves, and SuperLU's round-off follows the
    BLAS thread count."""
    from threadpoolctl import threadpool_limits

    from palace_tpu import api as jax_api

    old = os.environ.get("PALACE_TPU_MULTICHIP")
    os.environ["PALACE_TPU_MULTICHIP"] = "0"
    out = {}
    try:
        with threadpool_limits(limits=1, user_api="blas"):
            for scheme in ("GeneralizedAlpha", "ARKODE"):
                d = str(tmp_path_factory.mktemp(f"jax_{scheme}"))
                cfg = write_tem_line_case(d, **LINE, scheme=scheme, **PULSE,
                                          device="CPU", verbose=0)
                res = jax_api.run(cfg, output_dir=os.path.join(d, "out"))
                out[scheme] = (res, os.path.join(d, "out"))
    finally:
        if old is None:
            os.environ.pop("PALACE_TPU_MULTICHIP", None)
        else:
            os.environ["PALACE_TPU_MULTICHIP"] = old
    return out


@pytest.mark.parametrize("scheme", ["GeneralizedAlpha", "ARKODE"])
def test_run_matches_jax(tmp_path, jax_runs, scheme):
    jres, jdir = jax_runs[scheme]
    cfg = write_tem_line_case(str(tmp_path), **LINE, scheme=scheme, **PULSE,
                              device="CPU", verbose=0)
    res = palace_torch.run(cfg, output_dir=str(tmp_path / "out"))
    assert res["num_dofs"] == jres["num_dofs"] == 1718
    assert len(res["rows"]) == len(jres["rows"]) == 13
    for name in ("port-V.csv", "port-I.csv", "domain-E.csv", "probe-E.csv",
                 "probe-B.csv"):
        a, b = _table(tmp_path / "out" / name), _table(os.path.join(jdir,
                                                                     name))
        assert a.shape == b.shape and np.abs(b[:, 1:]).max() > 0
        assert _col_rel(a, b) <= 1e-10, name
    a = _table(tmp_path / "out" / "error-indicators.csv")
    b = _table(os.path.join(jdir, "error-indicators.csv"))
    assert b[0, 0] > 0 and _col_rel(a, b) <= 1e-8
    prov = res["provenance"]
    assert prov["estimator_mass_route"] == {"device-cg": 26}
    clock = prov["transient_seconds"]
    assert clock["steps"] == 13 and min(clock[k] for k in (
        "implicit_solve", "energies", "indicators")) > 0


def test_schemes_track_generalized_alpha(tmp_path):
    """RungeKutta and CVODE through the port stay within 5e-2 of the peak
    |V2| of its GeneralizedAlpha run."""
    v2 = {}
    for scheme in ("GeneralizedAlpha", "RungeKutta", "CVODE"):
        cfg = write_tem_line_case(str(tmp_path / scheme), **LINE,
                                  scheme=scheme, **PULSE, device="CPU",
                                  verbose=0)
        res = palace_torch.run(cfg)
        v2[scheme] = np.array([r["ports"][2]["V"] for r in res["rows"]])
        if scheme == "CVODE":
            assert res["provenance"]["transient_internal_steps"] >= 12
    scale = np.abs(v2["GeneralizedAlpha"]).max()
    assert scale > 0
    for scheme in ("RungeKutta", "CVODE"):
        assert np.isfinite(v2[scheme]).all()
        assert np.abs(v2[scheme] - v2["GeneralizedAlpha"]).max() \
            < 5e-2 * scale, scheme


def test_forced_splu_route_is_recorded(tmp_path, monkeypatch):
    from palace_torch.fem import estimators

    monkeypatch.setattr(estimators, "MASS_CG_MAX_ITS", 1)
    cfg = write_tem_line_case(str(tmp_path), 10.0, 2, 2, 1,
                              **dict(PULSE, max_time=0.01), device="CPU",
                              verbose=0)
    res = palace_torch.run(cfg)
    route = res["provenance"]["estimator_mass_route"]
    # Step 0's fields are zero, so its two CG solves converge at once;
    # from step 1 each recovery operator's CG stalls and its LU serves
    # every later solve.
    assert route == {"device-cg": 2, "host-splu": 4}


@pytest.mark.parametrize("change,match", [
    ("conductivity", "surface conductivity"),
    ("two_excitations", "exactly one excitation"),
])
def test_inherited_refusals(tmp_path, change, match):
    import json

    cfg = write_tem_line_case(str(tmp_path), 10.0, 2, 2, 1, **PULSE,
                              device="CPU", verbose=0)
    with open(cfg) as f:
        data = json.load(f)
    b = data["Boundaries"]
    if change == "conductivity":
        b["PEC"] = {"Attributes": [6]}
        b["Conductivity"] = [{"Attributes": [5], "Conductivity": 5.8e7}]
    else:
        b["LumpedPort"][1]["Excitation"] = 2
    with open(cfg, "w") as f:
        json.dump(data, f)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        palace_torch.run(cfg)


@pytest.mark.parametrize("output", ["surface_flux", "dielectric", "farfield",
                                    "paraview"])
def test_unported_outputs_name_roadmap_item(tmp_path, output):
    """Deliberate divergence: palace_tpu's transient driver writes none of
    these outputs and says nothing; the port refuses them by name."""
    import json

    cfg = write_tem_line_case(str(tmp_path), 10.0, 2, 2, 1, **PULSE,
                              device="CPU", verbose=0)
    with open(cfg) as f:
        data = json.load(f)
    post = {"surface_flux": {"SurfaceFlux": [
                {"Index": 1, "Attributes": [2], "Type": "Power"}]},
            "dielectric": {"Dielectric": [
                {"Index": 1, "Attributes": [2], "Thickness": 0.01,
                 "Permittivity": 10.0, "LossTan": 0.01}]},
            "farfield": {"FarField": {"Attributes": [1, 2]}}}.get(output)
    if post:
        data["Boundaries"]["Postprocessing"] = post
    else:
        data["Solver"]["Transient"]["SaveStep"] = 2
    with open(cfg, "w") as f:
        json.dump(data, f)
    with pytest.raises(NotImplementedError,
                       match="transient surface and ParaView output"):
        palace_torch.run(cfg)


def test_amr_warns_and_runs_without(tmp_path, capsys):
    import json

    cfg = write_tem_line_case(str(tmp_path), 10.0, 2, 2, 1,
                              **dict(PULSE, max_time=0.01), device="CPU",
                              verbose=1)
    with open(cfg) as f:
        data = json.load(f)
    data["Model"]["Refinement"] = {"MaxIts": 2}
    with open(cfg, "w") as f:
        json.dump(data, f)
    res = palace_torch.run(cfg)
    assert "AMR is not currently supported" in capsys.readouterr().out
    assert len(res["rows"]) == 3
    assert os.path.exists(os.path.join(res["post_dir"], "port-V.csv"))


def test_indicator_refusal_propagates(tmp_path, monkeypatch):
    """Deliberate divergence: palace_tpu drops the per-step indicators
    quietly on NotImplementedError (its RT space refuses mixed prism +
    other-geometry meshes, which the ND space accepts); the port's
    transient driver catches nothing."""
    from palace_torch.fem import estimators

    def refuse(*args, **kwargs):
        raise NotImplementedError("RT space on mixed prism + other-geometry "
                                  "meshes")

    monkeypatch.setattr(estimators, "grad_flux_indicators", refuse)
    cfg = write_tem_line_case(str(tmp_path), 10.0, 2, 2, 1,
                              **dict(PULSE, max_time=0.01), device="CPU",
                              verbose=0)
    with pytest.raises(NotImplementedError, match="mixed prism"):
        palace_torch.run(cfg)
