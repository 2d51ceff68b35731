"""The qdata mode of palace_torch's PAOperator (quadrature-point partial
assembly with shared basis tables) against its element mode and against
palace_tpu's element mode, on tet and hex meshes, Order 1-3, H1 and ND,
each coefficient alone and together: apply, diagonal and assembled CSR to
1e-12 relative (float64 on both sides; only the summation order differs).

palace_tpu's own qdata mode is held only where it is right: the ND apply and
diagonal, the H1 mass term and the H1 CSR.  Its two faults are pinned as the
port's deliberate divergences: palace_tpu's qdata apply drops the H1
diffusion term, and its qdata CSR drops the ND mass term."""

import jax.numpy as jnp
import numpy as np
import pytest

from palace_tpu.fem.h1 import H1Space as JaxH1Space
from palace_tpu.fem.nd import NDSpace as JaxNDSpace
from palace_tpu.fem.nd_operators import nd_operator as jax_nd_operator
from palace_tpu.fem.operators import h1_operator as jax_h1_operator
from palace_tpu.mesh import generate as jgen
from palace_tpu.mesh.mesh import canonicalize_simplices as j_canonicalize
from palace_torch.fem.h1 import H1Space
from palace_torch.fem.nd import NDSpace
from palace_torch.fem.nd_operators import nd_operator
from palace_torch.fem.operators import h1_operator
from palace_torch.mesh import generate as tgen
from palace_torch.mesh.mesh import canonicalize_simplices

TOL = 1e-12
MESHES = ["tet", "hex"]
ORDERS = [1, 2, 3]
COEFS = ["first", "second", "both"]
H1_COEFS = {"first": dict(diffusion_coef={1: np.array([[2.0, 0.3, 0.0],
                                                         [0.3, 1.0, 0.1],
                                                         [0.0, 0.1, 1.5]])}),
            "second": dict(mass_coef={1: 3.0})}
ND_COEFS = {"first": dict(curl_coef={1: np.diag([1.0, 0.8, 1.3])}),
            "second": dict(mass_coef={1: np.array([[2.0, 0.1, 0.0],
                                                   [0.1, 1.5, 0.0],
                                                   [0.0, 0.0, 1.0]])})}


def _coefs(family, which):
    table = H1_COEFS if family == "h1" else ND_COEFS
    if which == "both":
        return {**table["first"], **table["second"]}
    return dict(table[which])


def _mesh(gen, canon, kind):
    mesh = gen.box_tet(2, 2, 2) if kind == "tet" else gen.box_hex(2, 2, 2)
    canon(mesh)
    return mesh


def _torch_op(family, kind, p, mode, **coefs):
    mesh = _mesh(tgen, canonicalize_simplices, kind)
    if family == "h1":
        return h1_operator(H1Space(mesh, p), mode=mode, **coefs)
    return nd_operator(NDSpace(mesh, p), mode=mode, **coefs)


def _jax_op(family, kind, p, mode, **coefs):
    mesh = _mesh(jgen, j_canonicalize, kind)
    if family == "h1":
        return jax_h1_operator(JaxH1Space(mesh, p), mode=mode, **coefs)
    return jax_nd_operator(JaxNDSpace(mesh, p), dtype=jnp.float64, mode=mode,
                           **coefs)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _u(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("which", COEFS)
@pytest.mark.parametrize("p", ORDERS)
@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("family", ["h1", "nd"])
def test_qdata_matches_element_modes(family, kind, p, which):
    """Port qdata == port element == palace_tpu element (its CSR)."""
    coefs = _coefs(family, which)
    qd = _torch_op(family, kind, p, "qdata", **coefs)
    el = _torch_op(family, kind, p, "element", **coefs)
    ref = _jax_op(family, kind, p, "element", **coefs).assemble_csr()
    assert qd.mode == "qdata" and all(b.A is None for b in qd.buckets)
    u = _u(qd.num_dofs)
    y = qd(u).numpy()
    assert _rel(y, el(u).numpy()) < TOL
    assert _rel(y, ref @ u) < TOL
    d = qd.diagonal().numpy()
    assert _rel(d, el.diagonal().numpy()) < TOL
    assert _rel(d, ref.diagonal()) < TOL
    A = qd.assemble_csr().toarray()
    assert _rel(A, ref.toarray()) < TOL
    assert _rel(A, el.assemble_csr().toarray()) < TOL


@pytest.mark.parametrize("p", ORDERS)
@pytest.mark.parametrize("kind", MESHES)
def test_nd_qdata_apply_and_diagonal_match_jax_qdata(kind, p):
    coefs = _coefs("nd", "both")
    qd = _torch_op("nd", kind, p, "qdata", **coefs)
    jqd = _jax_op("nd", kind, p, "qdata", **coefs)
    u = _u(qd.num_dofs, 1)
    assert _rel(qd(u).numpy(), np.asarray(jqd(jnp.asarray(u)))) < TOL
    assert _rel(qd.diagonal().numpy(), np.asarray(jqd.diagonal())) < TOL


@pytest.mark.parametrize("p", ORDERS)
@pytest.mark.parametrize("kind", MESHES)
def test_h1_qdata_matches_jax_qdata_where_it_is_right(kind, p):
    """palace_tpu's H1 qdata apply and diagonal are right for the mass term
    alone, and its CSR for both terms."""
    mass = _coefs("h1", "second")
    qd = _torch_op("h1", kind, p, "qdata", **mass)
    jqd = _jax_op("h1", kind, p, "qdata", **mass)
    u = _u(qd.num_dofs, 2)
    assert _rel(qd(u).numpy(), np.asarray(jqd(jnp.asarray(u)))) < TOL
    assert _rel(qd.diagonal().numpy(), np.asarray(jqd.diagonal())) < TOL
    both = _coefs("h1", "both")
    A = _torch_op("h1", kind, p, "qdata", **both).assemble_csr()
    J = _jax_op("h1", kind, p, "qdata", **both).assemble_csr()
    assert _rel(A.toarray(), J.toarray()) < TOL


@pytest.mark.parametrize("kind", MESHES)
def test_h1_qdata_keeps_the_diffusion_term(kind):
    """Deliberate divergence: palace_tpu's qdata apply and diagonal never
    upload the planar diffusion table and drop the term; the port's match
    element mode."""
    coefs = _coefs("h1", "first")
    qd = _torch_op("h1", kind, 2, "qdata", **coefs)
    el = _torch_op("h1", kind, 2, "element", **coefs)
    jqd = _jax_op("h1", kind, 2, "qdata", **coefs)
    u = _u(qd.num_dofs, 3)
    y_el = el(u).numpy()
    assert _rel(qd(u).numpy(), y_el) < TOL
    assert _rel(qd.diagonal().numpy(), el.diagonal().numpy()) < TOL
    assert _rel(np.asarray(jqd(jnp.asarray(u))), y_el) > 0.5
    assert _rel(np.asarray(jqd.diagonal()), el.diagonal().numpy()) > 0.5


@pytest.mark.parametrize("kind", MESHES)
def test_nd_qdata_csr_keeps_the_mass_term(kind):
    """Deliberate divergence: palace_tpu's qdata `assemble_csr` and
    `assemble_dense_local` ignore G2 / qd_diff2, the ND mass; the port's
    match element mode."""
    coefs = _coefs("nd", "second")
    qd = _torch_op("nd", kind, 2, "qdata", **coefs)
    el = _torch_op("nd", kind, 2, "element", **coefs)
    jqd = _jax_op("nd", kind, 2, "qdata", **coefs)
    ref = el.assemble_csr().toarray()
    assert _rel(qd.assemble_csr().toarray(), ref) < TOL
    for a, b in zip(qd.assemble_dense_local(), el.assemble_dense_local()):
        assert _rel(a, b) < TOL
    assert _rel(jqd.assemble_csr().toarray(), ref) > 0.5


@pytest.mark.parametrize("family", ["h1", "nd"])
def test_qdata_element_energy_matches_element_mode(family):
    """0.5 u_e^H A_e u_e per element, real and complex u (palace_tpu's
    qdata element_energy raises)."""
    coefs = _coefs(family, "both")
    qd = _torch_op(family, "hex", 2, "qdata", **coefs)
    el = _torch_op(family, "hex", 2, "element", **coefs)
    rng = np.random.default_rng(4)
    u = rng.standard_normal(qd.num_dofs)
    uc = u + 1j * rng.standard_normal(qd.num_dofs)
    for x in (u, uc):
        for a, b in zip(qd.element_energy(x), el.element_energy(x)):
            assert _rel(a.numpy(), b.numpy()) < TOL


def test_nd_qdata_on_2d_meshes():
    """The qdata mass term runs on 2D meshes; the curl term is 3D-only, as
    in palace_tpu."""
    from palace_torch.cases import rect_mesh

    mesh = rect_mesh(3, 2, 1.0, 0.5)
    canonicalize_simplices(mesh)
    space = NDSpace(mesh, 2)
    mass = {1: np.eye(3)}
    qd = nd_operator(space, mass_coef=mass, mode="qdata")
    el = nd_operator(space, mass_coef=mass)
    u = _u(space.num_dofs, 5)
    assert _rel(qd(u).numpy(), el(u).numpy()) < TOL
    with pytest.raises(NotImplementedError, match="3D-only"):
        nd_operator(space, curl_coef=mass, mode="qdata")
