"""The BoundaryMode driver of the port against palace_tpu's, on the CPU.

- `BoundaryModeProblem`'s forms (the ND and H1 blocks, their loss parts,
  `_mixed_grad`, the impedance-sheet and first-order Absorbing rim line
  masses) on the WR-90 cross-section with an Ls sheet, an Absorbing wall
  and a lossy dielectric: 1e-12 of each matrix's largest entry.
- Whole runs (`palace_torch.run` against `palace_tpu.run`):
  - that lossy, open cross-section with an interface dielectric:
    mode-kn, |mode-V|, mode-Z, domain-E, surface-Q and error-indicators to
    1e-8 of each column's largest value;
  - the PEC guide: TE10 kn to 1e-8 of palace_tpu's and to 2e-5 of the
    analytic `te10_kn`; the second mode evanescent (which evanescent mode,
    and its kn's sign, follow ARPACK's random start in both packages) and
    left out of the indicators;
  - the parallel-plate (TEM) cross-section: n_eff = sqrt(eps_r) and Z_PV =
    eta0 d / (w sqrt(eps_r)) to 1e-8;
  - the port face of the box_tet WR-90 guide (`_extract_boundary_submesh`,
    other wave ports relabelled PEC) with an anisotropic eps, which makes
    `_rotate_materials` count: TE10 against palace_tpu (1e-8) and against
    the analytic kn of eps_zz; the submesh against palace_tpu's;
  - quadrilaterals: kn against palace_tpu, indicators zero in both (no RT
    space on quadrilaterals).
Where a mode's Im kn is round-off (1e-15 1/m) its sign differs between
runs, so Re kn and Re n_eff are compared and Im kn held near 0.
Every indicator mass solve runs on the device CG.  Signed fields are not
compared: the mode's phase is fixed at its largest dof, which ties on a
symmetric mesh."""

import os

import numpy as np
import pytest

import palace_torch
from palace_torch import cases
from palace_torch.config import IoData
from palace_torch.drivers import boundarymode as bm
from palace_torch.drivers.common import prepare_mesh
from palace_torch.models.materials import MaterialOperator
from palace_tpu import api as jax_api
from palace_tpu.config import IoData as JaxIoData
from palace_tpu.drivers import boundarymode as jbm
from palace_tpu.drivers.common import prepare_mesh as jax_prepare_mesh
from palace_tpu.models.materials import MaterialOperator as JaxMaterials


def _load(post, name):
    return np.atleast_2d(np.loadtxt(os.path.join(post, name), delimiter=",",
                                    skiprows=1))


def _col_rel(a, b) -> float:
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    assert a.shape == b.shape
    scale = np.maximum(np.abs(b).max(axis=0), 1e-300)
    return float((np.abs(a - b).max(axis=0) / scale).max())


def _runs(tmp_path, write, **kw):
    """The deck `write` makes, run by the port and by palace_tpu; returns
    (port result, palace_tpu result, the two output directories)."""
    posts = {}
    for tag in ("torch", "jax"):
        posts[tag] = os.path.dirname(write(str(tmp_path / tag), device="CPU",
                                           verbose=0, **kw))
    res = palace_torch.run(os.path.join(posts["torch"], "case.json"))
    jres = jax_api.run(os.path.join(posts["jax"], "case.json"))
    return res, jres, {t: os.path.join(p, "postpro")
                       for t, p in posts.items()}


#: The lossy, open WR-90 cross-section: Ls sheet on y = b, first-order
#: Absorbing on x = a, eps_r 2 with tan delta 0.01, an interface layer.
OPEN = dict(sheet_ls=1e-12, absorbing=True, loss_tan=0.01, eps_r=2.0,
            dielectric=True)


def test_forms_match_jax(tmp_path):
    cfg = cases.write_boundarymode_case(str(tmp_path), 6, 3, 2, **OPEN,
                                        device="CPU", verbose=0)
    io, jio = IoData(cfg), JaxIoData(cfg)
    prob = bm.BoundaryModeProblem(io, prepare_mesh(io),
                                  MaterialOperator.build(io))
    jprob = jbm.BoundaryModeProblem(jio, jax_prepare_mesh(jio),
                                    JaxMaterials.build(jio))

    def rel(a, b):
        return abs(a - b).max() / abs(b).max()

    for name in ("_Btt", "_Ktt", "_Mtt", "_Mtt_i", "_Knn", "_Mnn", "_Mnn_i",
                 "_Atn"):
        assert rel(getattr(prob, name), getattr(jprob, name)) <= 1e-12, name
    ((Rs, Ls, Cs, Mt, Mn),) = prob._imp_terms
    ((jRs, jLs, jCs, jMt, jMn),) = jprob._imp_terms
    assert (Rs, Ls, Cs) == (jRs, jLs, jCs)
    assert rel(Mt, jMt) <= 1e-12 and rel(Mn, jMn) <= 1e-12
    ((Mt, Mn),) = prob._ff_terms
    ((jMt, jMn),) = jprob._ff_terms
    assert rel(Mt, jMt) <= 1e-12 and rel(Mn, jMn) <= 1e-12
    assert np.array_equal(prob.ess_nd, jprob.ess_nd)
    assert prob.mu_eps_max == jprob.mu_eps_max


def test_open_lossy_section_matches_jax(tmp_path):
    res, _, out = _runs(tmp_path, lambda d, **kw: cases.write_boundarymode_case(
        d, 6, 3, 2, **OPEN, **kw))
    for name in ("mode-kn.csv", "mode-Z.csv", "domain-E.csv",
                 "surface-Q.csv", "error-indicators.csv"):
        assert _col_rel(_load(out["torch"], name),
                        _load(out["jax"], name)) <= 1e-8, name
    v, jv = _load(out["torch"], "mode-V.csv"), _load(out["jax"], "mode-V.csv")
    assert np.abs(np.abs(v[:, 1] + 1j * v[:, 2])
                  / np.abs(jv[:, 1] + 1j * jv[:, 2]) - 1.0).max() <= 1e-8
    kn = _load(out["torch"], "mode-kn.csv")
    assert np.all(kn[:, 2] < 0.0)  # lossy: decaying along +z
    prov = res["provenance"]
    assert prov["eigen_path"] == "host-arpack"
    assert set(prov["estimator_mass_route"]) == {"device-cg"}


def test_pec_guide_te10(tmp_path):
    """The PEC WR-90 cross-section at 10 GHz: TE10, and an evanescent
    second mode (TE20 is cut off below 13.1 GHz)."""
    res, _, out = _runs(tmp_path, lambda d, **kw: cases.write_boundarymode_case(
        d, 8, 4, 2, **kw))
    kn, jkn = _load(out["torch"], "mode-kn.csv"), _load(out["jax"],
                                                        "mode-kn.csv")
    assert abs(kn[0, 1] / jkn[0, 1] - 1.0) <= 1e-8
    assert abs(kn[0, 1] / cases.te10_kn(10.0) - 1.0) < 2e-5
    # The second mode is evanescent; which one (TE20 or TE01, all with Re
    # kn ~ 0) follows ARPACK's random start, in both packages.
    assert abs(kn[1, 1]) < 1e-6 * abs(kn[1, 2])
    for name in ("mode-Z.csv", "domain-E.csv", "error-indicators.csv"):
        t, j = _load(out["torch"], name), _load(out["jax"], name)
        assert _col_rel(t[:1], j[:1]) <= 1e-8, name
    assert res["n_eff"][0].real == pytest.approx(kn[0, 3], rel=1e-12)


def test_tem_cross_section_is_analytic(tmp_path):
    """The parallel-plate cross-section: its constant TEM field lies in the
    ND space, so n_eff and Z_PV are exact to the solver's tolerance."""
    res, _, out = _runs(tmp_path, lambda d, **kw: cases.write_tem_section_case(
        d, 5, 2, 2, **kw))
    kn = _load(out["torch"], "mode-kn.csv")
    z = _load(out["torch"], "mode-Z.csv")
    assert kn[0, 3] == pytest.approx(1.5, rel=1e-8)
    assert abs(kn[0, 4]) < 1e-8
    assert z[0, 1] == pytest.approx(cases.tem_section_z(), rel=1e-8)
    assert _col_rel(z, _load(out["jax"], "mode-Z.csv")) <= 1e-8


def test_port_face_matches_jax(tmp_path):
    """BoundaryMode on the x = 0 face of the box_tet guide with eps diag(2,
    3, 4): the face's normal is global x, so only `_rotate_materials` takes
    eps_xx out of the in-plane block; TE10 (E along global z) sees 4."""
    res, _, out = _runs(tmp_path, lambda d, **kw: (
        cases.write_port_face_mode_case(d, 2, 6, 3, 2, eps=(2.0, 3.0, 4.0),
                                        **kw)))
    for name in ("domain-E.csv", "error-indicators.csv"):
        assert _col_rel(_load(out["torch"], name),
                        _load(out["jax"], name)) <= 1e-8, name
    kn, jkn = _load(out["torch"], "mode-kn.csv"), _load(out["jax"],
                                                        "mode-kn.csv")
    # Re kn and Re n_eff; Im kn is round-off in both.
    assert _col_rel(kn[:, [1, 3]], jkn[:, [1, 3]]) <= 1e-8
    assert np.abs(kn[:, 2]).max() < 1e-10 * kn[0, 1]
    assert abs(kn[0, 1] / cases.te10_kn(10.0, eps_r=4.0) - 1.0) < 1e-3
    prob = res["problem"]
    assert prob.mesh.nodes.shape[1] == 2
    # The face's in-plane eps block holds eps_yy and eps_zz, the normal
    # one eps_xx.
    eps = prob.materials.permittivity[1]
    assert sorted(np.round(np.diag(eps)[:2], 12)) == [3.0, 4.0]
    assert eps[2, 2] == pytest.approx(2.0, rel=1e-12)


def test_submesh_extraction_matches_jax(tmp_path):
    cfg = cases.write_port_face_mode_case(str(tmp_path), 2, 4, 2, 2,
                                          device="CPU", verbose=0)
    io, jio = IoData(cfg), JaxIoData(cfg)
    sub, frame = bm._extract_boundary_submesh(prepare_mesh(io), [1],
                                              pec_attrs={2, 3, 4, 5, 6})
    jsub, jframe = jbm._extract_boundary_submesh(jax_prepare_mesh(jio), [1],
                                                 pec_attrs={2, 3, 4, 5, 6})
    assert np.array_equal(frame, jframe)
    assert np.array_equal(sub.nodes, jsub.nodes)
    for b, jb in zip(sub.buckets + sub.bdr_buckets,
                     jsub.buckets + jsub.bdr_buckets):
        assert b.geom.value == jb.geom.value
        assert np.array_equal(b.conn, jb.conn)
        assert np.array_equal(b.attr, jb.attr)
    assert set(np.unique(sub.bdr_buckets[0].attr)) <= {3, 4, 5, 6}


def test_quad_section_matches_jax(tmp_path):
    """Quadrilaterals: the modes match; neither package has an RT space on
    quadrilaterals, so both write a zero indicator table."""
    _, _, out = _runs(tmp_path, lambda d, **kw: cases.write_boundarymode_case(
        d, 6, 3, 2, quad=True, modes=1, **kw))
    kn, jkn = _load(out["torch"], "mode-kn.csv"), _load(out["jax"],
                                                        "mode-kn.csv")
    # Re kn and Re n_eff; Im kn is round-off (1e-15 1/m) in both.
    assert _col_rel(kn[:, [1, 3]], jkn[:, [1, 3]]) <= 1e-8
    assert np.abs(kn[:, 2]).max() < 1e-10 * kn[0, 1]
    ind = _load(out["torch"], "error-indicators.csv")
    assert np.all(ind == 0.0)
    assert np.all(_load(out["jax"], "error-indicators.csv") == 0.0)
