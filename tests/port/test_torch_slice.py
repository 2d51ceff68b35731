"""The slice end to end: palace_torch.run on the 4^3 hex, Order 2 driven
case (CPU) against palace_tpu.run on the same config in a subprocess on one
CPU device (single-device BlockedDeviceSolver).  domain-E.csv and
error-indicators.csv agree to 1e-7 relative per column (both solves stop at
Tol 1e-10; the CSVs print 13 significant digits)."""

import os
import subprocess
import sys

import numpy as np

import palace_torch
from palace_torch.cases import write_slice_case

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TABLES = ("domain-E.csv", "error-indicators.csv")


def _load(post, name):
    return np.atleast_2d(np.loadtxt(os.path.join(post, name), delimiter=",",
                                    skiprows=1))


def _col_rel(a, b):
    out = 0.0
    for j in range(b.shape[1]):
        s = np.abs(b[:, j]).max()
        d = np.abs(a[:, j] - b[:, j]).max()
        out = max(out, d / s if s > 0 else d)
    return out


def test_slice_matches_jax_package(tmp_path):
    t_cfg = write_slice_case(str(tmp_path / "torch"), 4, 2, tol=1e-10,
                             verbose=0, device="CPU")
    j_cfg = write_slice_case(str(tmp_path / "jax"), 4, 2, tol=1e-10,
                             verbose=0, device="CPU")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, palace_tpu; "
         "palace_tpu.run(sys.argv[1])", j_cfg],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    res = palace_torch.run(t_cfg)
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out
    prov = res["provenance"]
    assert prov["solver_path"] == "device"
    assert prov["fine_level"] == "structured"
    assert res["num_dofs"] == 1944
    for name in TABLES:
        a = _load(res["post_dir"], name)
        b = _load(os.path.join(os.path.dirname(j_cfg), "postpro"), name)
        assert a.shape == b.shape and np.isfinite(a).all()
        assert _col_rel(a, b) < 1e-7, name
