"""The nonlinear eigenmode branch of palace_torch (wave ports and
second-order absorbing boundaries) against palace_tpu on the CPU.

- `waveport_a2_csr` and `abc2_a2_csr` at three frequencies, 1e-10
  relative.
- The pencil the eigensolver receives: K, C and M after the quadratic
  Newton interpolation of A2 on [i omega_t, i omega_u], and the div-free
  data, captured at palace_tpu's and the port's `quadratic_eigs_jd` on the
  same config, 1e-12 relative.
- A short WR-90 guide shorted at x = L and opened at x = 0 through a wave
  port (port face 4 x 3 cells at Order 2, where the port mode is
  reproducible: ROADMAP §3) or a second-order absorbing boundary, through
  both packages: eig.csv Re f within 1e-8 and Im f within 1e-6 relative.
- The 1D oracle `cases.shorted_guide_mode`: its roots satisfy
  k cos(k L) + i beta sin(k L) = 0 with beta at their own Re omega
  (1e-12), and omega = c sqrt(k^2 + (pi / a)^2)."""

import cmath
import math

import numpy as np
import pytest

import palace_torch
from palace_torch.cases import (shorted_guide_mode, te10l_qc,
                                write_guide_eigen_case)
from palace_torch.config import IoData, ValueType
from palace_torch.drivers import eigenmode as teigen
from palace_torch.drivers.common import prepare_mesh
from palace_torch.models.spaceoperator import SpaceOperator
from palace_tpu import api as jax_api
from palace_tpu.config import IoData as JaxIoData
from palace_tpu.drivers.common import prepare_mesh as jax_prepare_mesh
from palace_tpu.linalg import eig as jeig
from palace_tpu.models.spaceoperator import SpaceOperator as JaxSpaceOperator


def _case(tmp_path, opening, n_len=6):
    return write_guide_eigen_case(str(tmp_path / "case"), n_len, 4, 3, 2,
                                  opening=opening, device="CPU", verbose=0)


def _rel(a, b):
    return abs(a - b).max() / abs(b).max()


@pytest.mark.parametrize("opening,method", [
    ("waveport", "waveport_a2_csr"), ("absorbing", "abc2_a2_csr")])
def test_a2_csrs_match_jax(tmp_path, opening, method):
    path = _case(tmp_path, opening, n_len=3)
    io_t, io_j = IoData(path), JaxIoData(path)
    sop_t = SpaceOperator(io_t, prepare_mesh(io_t))
    sop_j = JaxSpaceOperator(io_j, jax_prepare_mesh(io_j))
    for f_ghz in (8.5, 10.0, 12.0):
        om = 2 * math.pi * io_t.units.nondimensionalize(ValueType.FREQUENCY,
                                                        f_ghz)
        At, Aj = getattr(sop_t, method)(om), getattr(sop_j, method)(om)
        assert At.shape == Aj.shape and abs(Aj).max() > 0
        assert _rel(At, Aj) <= 1e-10


class _Captured(BaseException):
    """Stops a run at its first JD call (palace_tpu catches Exception)."""


def _capture(store):
    def jd(K, C, M, ess, sigma, nev, X0, **kw):
        store.update(K=K, C=C, M=M, ess=np.asarray(ess), sigma=sigma,
                     divfree=kw.get("divfree"))
        raise _Captured()
    return jd


def test_newton_pencil_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PALACE_TPU_MULTICHIP", "0")
    path = _case(tmp_path, "waveport", n_len=3)
    got = {"torch": {}, "jax": {}}
    monkeypatch.setattr(teigen, "quadratic_eigs_jd", _capture(got["torch"]))
    monkeypatch.setattr(jeig, "quadratic_eigs_jd", _capture(got["jax"]))
    for name, run in (("torch", palace_torch.run), ("jax", jax_api.run)):
        with pytest.raises(_Captured):
            run(path, str(tmp_path / name))
    t, j = got["torch"], got["jax"]
    assert t["sigma"] == j["sigma"] and np.array_equal(t["ess"], j["ess"])
    for key in ("K", "C", "M"):
        assert t[key].shape == j[key].shape
        assert _rel(t[key], j[key]) <= 1e-12, key
    for At, Aj in zip(t["divfree"], j["divfree"]):
        assert At.shape == Aj.shape and _rel(At, Aj) <= 1e-12


@pytest.mark.parametrize("opening", ["waveport", "absorbing"])
def test_shorted_guide_matches_jax(tmp_path, monkeypatch, opening):
    monkeypatch.setenv("PALACE_TPU_MULTICHIP", "0")
    path = _case(tmp_path, opening)
    res = palace_torch.run(path, str(tmp_path / "torch"))
    jax_api.run(path, output_dir=str(tmp_path / "jax"))
    et, ej = (np.atleast_2d(np.loadtxt(tmp_path / d / "eig.csv",
                                       delimiter=",", skiprows=1))
              for d in ("torch", "jax"))
    assert et.shape == ej.shape == (2, 6) and np.isfinite(et).all()
    assert (np.abs(et[:, 1] - ej[:, 1]) / np.abs(ej[:, 1])).max() <= 1e-8
    assert (np.abs(et[:, 2] - ej[:, 2]) / np.abs(ej[:, 2])).max() <= 1e-6
    assert (et[:, 2] > 0).all()
    prov = res["provenance"]
    assert prov["eigen_path"] == "quadratic-jd"
    assert len(prov["nonlinear_refine_iterations"]) == 2
    assert prov["nonlinear_harvest_rounds"] == 0
    if opening == "waveport":
        assert prov["waveport1_deflation"]


def test_1d_oracle_roots_satisfy_their_equation():
    a, length, c0 = 22.86e-3, 60e-3, 299792458.0
    kc = math.pi / a
    for guess, near in ((9.4, 9.4385), (11.4, 11.3913)):
        f, k, beta = shorted_guide_mode(guess)
        om = 2 * math.pi * f * 1e9
        assert beta == pytest.approx(
            math.sqrt((om.real / c0) ** 2 - kc ** 2), rel=1e-14)
        g = k * cmath.cos(k * length) + 1j * beta * cmath.sin(k * length)
        assert abs(g) <= 1e-12 * abs(k)
        assert abs(om - c0 * cmath.sqrt(k * k + kc * kc)) <= 1e-12 * abs(om)
        assert f.real == pytest.approx(near, abs=1e-4) and f.imag > 0
    q, f101 = te10l_qc(a, 10.16e-3, 30e-3, 0.02369)
    assert f101 == pytest.approx(
        c0 / 2 * math.sqrt(1 / a ** 2 + 1 / 30e-3 ** 2), rel=1e-14)
    assert q == pytest.approx(7706.542, rel=1e-6)
