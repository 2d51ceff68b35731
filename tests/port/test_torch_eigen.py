"""The eigenmode slice against palace_tpu on the CPU.

- `DivFreeProjector` and `_m_orthonormalize` against palace_tpu's on the
  same numpy inputs, 1e-12 relative.
- The device (block Lanczos) branch end to end: the port on the 3^3 hex,
  Order 2 PEC cavity with Linear.Type "GMG", run in a subprocess that
  refuses jax and palace_tpu imports, against palace_tpu.run on the same
  config in a subprocess on one CPU device (single-device solver).  Both
  stop at Eigenmode.Tol 1e-5 on the backward error (two restarts instead of
  four at 1e-8, half the run time); they take the same iterates, so eig.csv
  Re{f} agrees within 1e-8 relative and domain-E.csv within 1e-7 per column.
- The host ARPACK branch end to end on the box-tet cavity of
  tests/test_drivers_e2e.py:76, same tolerances.
- The unported branches raise NotImplementedError naming their ROADMAP
  item; the damped and nonlinear branches, ported since, run."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import palace_torch
from palace_tpu import api as jax_api
from palace_tpu.fem.nd import NDSpace as JaxNDSpace
from palace_tpu.linalg import device_eig as jeig
from palace_tpu.mesh import gmsh_write as jax_gmsh_write
from palace_tpu.mesh.generate import box_tet as jax_box_tet
from palace_tpu.mesh.mesh import canonicalize_simplices as jax_canonicalize
from palace_torch.cases import write_eigen_case
from palace_torch.fem.nd import NDSpace
from palace_torch.fem.nd_operators import nd_operator
from palace_torch.linalg import device_eig as teig
from palace_torch.mesh.generate import box_tet
from palace_torch.mesh.mesh import canonicalize_simplices

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PORT_RUN = r"""
import json, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "palace_tpu"):
            raise ImportError("import refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(1)
import palace_torch
res = palace_torch.run(sys.argv[1])
assert not any(k.split(".")[0] in ("jax", "jaxlib", "palace_tpu")
               for k in sys.modules)
print("PROVENANCE " + json.dumps(res["provenance"]))
"""


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _load(post, name):
    return np.atleast_2d(np.loadtxt(os.path.join(post, name), delimiter=",",
                                    skiprows=1))


def _check_tables(post_t, post_j):
    eig_t, eig_j = _load(post_t, "eig.csv"), _load(post_j, "eig.csv")
    assert eig_t.shape == eig_j.shape and np.isfinite(eig_t).all()
    assert _rel(eig_t[:, 1], eig_j[:, 1]) < 1e-8
    dom_t, dom_j = _load(post_t, "domain-E.csv"), _load(post_j, "domain-E.csv")
    assert dom_t.shape == dom_j.shape and np.isfinite(dom_t).all()
    for c in range(dom_j.shape[1]):
        scale = np.abs(dom_j[:, c]).max()
        assert np.abs(dom_t[:, c] - dom_j[:, c]).max() <= 1e-7 * scale


def _space_pair():
    """The box-tet 2^3, Order 2 space built by each package, with its PEC
    mask and the port's mass matrix (same dof numbering on both sides)."""
    mesh, mesh_j = box_tet(2, 2, 2), jax_box_tet(2, 2, 2)
    canonicalize_simplices(mesh)
    jax_canonicalize(mesh_j)
    space, space_j = NDSpace(mesh, 2), JaxNDSpace(mesh_j, 2)
    ess = np.zeros(space.num_dofs, bool)
    ess[space.boundary_dofs([1, 2, 3, 4, 5, 6])] = True
    M = nd_operator(space, mass_coef={1: np.diag([2.0, 1.5, 1.0])})
    return space, space_j, ess, M.assemble_csr()


def test_divfree_projector_matches_jax():
    space, space_j, ess, M = _space_pair()
    rng = np.random.default_rng(3)
    X = rng.standard_normal((space.num_dofs, 4)) \
        + 1j * rng.standard_normal((space.num_dofs, 4))
    X[ess] = 0.0
    pec = [1, 2, 3, 4, 5, 6]
    Y = teig.DivFreeProjector(space, pec, M, ess)(X)
    Y_j = jeig.DivFreeProjector(space_j, pec, M, ess)(X)
    assert _rel(Y, Y_j) < 1e-12
    # The projected block is M-orthogonal to the gradients.
    G = teig.DivFreeProjector(space, pec, M, ess).G
    assert np.abs(G.T @ (M @ Y)).max() < 1e-10 * np.abs(G.T @ (M @ X)).max()


@pytest.mark.parametrize("n_blocks", [0, 2])
def test_m_orthonormalize_matches_jax(n_blocks):
    rng = np.random.default_rng(n_blocks)
    n = 60
    A = rng.standard_normal((n, n))
    M = sp.csr_matrix(A @ A.T + n * np.eye(n))

    def applyM(X):
        return M @ X

    blocks = []
    for _ in range(n_blocks):
        B = rng.standard_normal((n, 5)) + 1j * rng.standard_normal((n, 5))
        blocks.append(teig._m_orthonormalize(blocks, B, applyM))
    W = rng.standard_normal((n, 6)) + 1j * rng.standard_normal((n, 6))
    V = teig._m_orthonormalize(blocks, W, applyM)
    V_j = jeig._m_orthonormalize(blocks, W, applyM)
    assert V.shape == V_j.shape == (n, 6)
    assert _rel(V, V_j) < 1e-12
    assert np.abs(V.conj().T @ (M @ V) - np.eye(6)).max() < 1e-12


def test_device_eigen_matches_jax_package(tmp_path):
    t_cfg, j_cfg = (write_eigen_case(str(tmp_path / tag), 3, 2, tol=1e-5,
                                     device="CPU", verbose=0)
                    for tag in ("torch", "jax"))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, cfg], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for code, cfg in ((PORT_RUN, t_cfg), ("import sys, palace_tpu; "
                                              "palace_tpu.run(sys.argv[1])",
                                              j_cfg))]
    try:
        # About 25 s alone; a fully loaded parallel run slows both solves
        # several times over, and a longer wait would hold its worker.
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    prov = json.loads(outs[0].split("PROVENANCE ", 1)[1].splitlines()[0])
    assert prov["eigen_path"] == "device-lanczos"
    assert prov["fine_level"] == "structured"
    _check_tables(os.path.join(os.path.dirname(t_cfg), "postpro"),
                  os.path.join(os.path.dirname(j_cfg), "postpro"))


def test_host_eigen_matches_jax_package(tmp_path):
    cfg = {
        "Problem": {"Type": "Eigenmode", "Verbose": 0, "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-2},
        "Domains": {"Materials": [{"Attributes": [1], "Permittivity": 1.0}]},
        "Boundaries": {"PEC": {"Attributes": [1, 2, 3, 4, 5, 6]}},
        "Solver": {"Order": 2, "Device": "CPU",
                   "Eigenmode": {"N": 3, "Target": 15.0, "Tol": 1e-9},
                   "Linear": {"Tol": 1e-9}},
    }
    posts = {}
    for tag in ("torch", "jax"):
        d = tmp_path / tag
        os.makedirs(d)
        jax_gmsh_write.write(jax_box_tet(3, 3, 3), str(d / "box.msh"))
        with open(d / "case.json", "w") as f:
            json.dump(cfg, f)
        posts[tag] = str(d / "postpro")
    res = palace_torch.run(str(tmp_path / "torch" / "case.json"))
    jax_api.run(str(tmp_path / "jax" / "case.json"))
    assert res["provenance"]["eigen_path"] == "host-arpack"
    _check_tables(posts["torch"], posts["jax"])


#: Feature -> (the ROADMAP item its refusal names, or None once it is
#: ported, the config edit, and for a ported output the file it writes).
#: The damped and nonlinear branches are ported and must now run, as must
#: the surface, far-field and ParaView outputs; eigenmode AMR runs on
#: tets, and the hex box of `write_eigen_case` is refused as nonconforming
#: ND AMR.
_UNPORTED = {
    "damped": (None, lambda c: c["Boundaries"].update(
        PEC={"Attributes": [2, 3, 4, 5, 6]},
        Impedance=[{"Attributes": [1], "Rs": 50.0}]), None),
    "nonlinear": (None, lambda c: c["Boundaries"].update(
        PEC={"Attributes": [2, 3, 4, 5, 6]},
        Absorbing={"Attributes": [1], "Order": 2}), None),
    "floquet": (None, lambda c: c["Boundaries"].update(
        Periodic={"FloquetWaveVector": [0.1, 0.0, 0.0]}), "eig.csv"),
    "surface": (None, lambda c: c["Boundaries"].update(Postprocessing={
        "SurfaceFlux": [{"Index": 1, "Attributes": [1],
                         "Type": "Electric"}]}), "surface-F.csv"),
    "farfield": (None, lambda c: c["Boundaries"].update(Postprocessing={
        "FarField": {"Attributes": [1]}}), "farfield-rE.csv"),
    "paraview": (None, lambda c: c["Solver"]["Eigenmode"].update(Save=1),
                 "paraview/eigenmode/eigenmode_0000.vtu"),
    "amr": ("nonconforming ND AMR",
            lambda c: c["Model"].update(Refinement={"MaxIts": 1}), None),
}


@pytest.mark.parametrize("feature", sorted(_UNPORTED))
def test_unported_eigen_branches_name_roadmap_item(tmp_path, feature):
    """A refused branch names its ROADMAP item; a ported one runs (at 3^3:
    the JD seed asks for more vectors than the 2^3 box has) and writes its
    output."""
    item, edit, written = _UNPORTED[feature]
    path = write_eigen_case(str(tmp_path), 2 if item else 3, 1,
                            linear="SuperLU", device="CPU", verbose=0)
    with open(path) as f:
        cfg = json.load(f)
    edit(cfg)
    with open(path, "w") as f:
        json.dump(cfg, f)
    if item is None:
        res = palace_torch.run(path)
        f = np.asarray(res["frequencies_ghz"])
        assert len(f) == 4 and (f.real > 5.0).all()
        if written is not None:
            assert res["provenance"]["eigen_path"] == "host-arpack"
            assert os.path.getsize(os.path.join(res["post_dir"],
                                                written)) > 0
            return
        assert res["provenance"]["eigen_path"] == "quadratic-jd"
        assert (f.imag > 0).all()
        return
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        palace_torch.run(path)
