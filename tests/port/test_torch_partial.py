"""palace_torch element operators against palace_tpu on the same meshes:
PAOperator apply / diagonal / CSR / element energies (ops/partial.py) and
nd_operator element matrices + discrete gradient (fem/nd_operators.py).
Tolerance 1e-12 relative: both sides run float64 and differ only in
summation order."""

import jax.numpy as jnp
import numpy as np
import pytest

from palace_tpu.fem.h1 import H1Space
from palace_tpu.fem.nd import NDSpace
from palace_tpu.fem.nd_operators import nd_h1_gradient as jax_gradient
from palace_tpu.fem.nd_operators import nd_operator as jax_nd_operator
from palace_tpu.mesh.generate import box_hex, box_tet
from palace_tpu.mesh.mesh import canonicalize_simplices
from palace_tpu.ops.partial import Scatter as JaxScatter
from palace_tpu.ops.partial import detect_dof_group as jax_detect_dof_group
from palace_torch.fem.h1 import H1Space as TorchH1Space
from palace_torch.fem.nd import NDSpace as TorchNDSpace
from palace_torch.fem.nd_operators import nd_h1_gradient, nd_operator
from palace_torch.mesh import generate as tgen
from palace_torch.mesh.mesh import canonicalize_simplices as t_canonicalize
from palace_torch.ops.partial import (
    BucketTables, PAOperator, Scatter, detect_dof_group)

CASES = [("tet", 1), ("tet", 2), ("tet", 3), ("hex", 2)]
TOL = 1e-12


def _space(kind, p):
    mesh = box_tet(3, 3, 3) if kind == "tet" else box_hex(2, 2, 2)
    canonicalize_simplices(mesh)
    return NDSpace(mesh, p)


def _torch_space(kind, p):
    """The same space built from the port's own copies."""
    mesh = tgen.box_tet(3, 3, 3) if kind == "tet" else tgen.box_hex(2, 2, 2)
    t_canonicalize(mesh)
    return TorchNDSpace(mesh, p)


def _coefs():
    return dict(curl_coef={1: np.diag([1.0, 0.8, 1.3])},
                mass_coef={1: np.array([[2.0, 0.1, 0.0], [0.1, 1.5, 0.0],
                                        [0.0, 0.0, 1.0]])})


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("kind,p", CASES)
def test_pa_operator_matches_jax(kind, p):
    space = _space(kind, p)
    jop = jax_nd_operator(space, dtype=jnp.float64, **_coefs())
    top = PAOperator(space.num_dofs, [
        BucketTables(gidx=np.asarray(b.gidx), A=np.asarray(b.A),
                     signs=None if b.signs is None else np.asarray(b.signs))
        for b in jop.buckets])
    rng = np.random.default_rng(1)
    u = rng.standard_normal(space.num_dofs)
    assert _rel(top(u).numpy(), jop(jnp.asarray(u))) < TOL
    uc = u + 1j * rng.standard_normal(space.num_dofs)
    assert _rel(top(uc).numpy(), jop(jnp.asarray(uc.real))
                + 1j * np.asarray(jop(jnp.asarray(uc.imag)))) < TOL
    assert _rel(top.diagonal().numpy(), jop.diagonal()) < TOL
    A_t, A_j = top.assemble_csr(), jop.assemble_csr()
    assert abs(A_t - A_j).max() < TOL * abs(A_j).max()
    for e_t, e_j in zip(top.element_energy(u), jop.element_energy(u)):
        assert _rel(e_t.numpy(), e_j) < TOL


@pytest.mark.parametrize("kind,p", CASES)
def test_nd_operator_element_matrices_match_jax(kind, p):
    space, tspace = _space(kind, p), _torch_space(kind, p)
    jop = jax_nd_operator(space, dtype=jnp.float64, **_coefs())
    top = nd_operator(tspace, **_coefs())
    for bt, bj in zip(top.buckets, jop.buckets):
        assert _rel(bt.A, bj.A) < TOL
        assert np.array_equal(bt.gidx, bj.gidx)
        if bj.signs is not None:
            assert np.array_equal(bt.signs, np.asarray(bj.signs))
    G_t = nd_h1_gradient(tspace, TorchH1Space(tspace.mesh, p))
    G_j = jax_gradient(space, H1Space(space.mesh, p))
    assert abs(G_t - G_j).max() < TOL


@pytest.mark.parametrize("kind,p", CASES + [("hex", 1), ("hex", 3)])
def test_scatter_and_dof_group_match_jax(kind, p):
    """The sorted segment-sum tables and the g-dof grouping the element
    applies gather with, on the element dofs of ND and H1 spaces."""
    space = _space(kind, p)
    for gidx, n in ((space.elem_dofs, space.num_dofs),
                    (H1Space(space.mesh, p).elem_dofs,
                     H1Space(space.mesh, p).num_dofs)):
        sc, sc_j = Scatter.build(gidx, n), JaxScatter.build(gidx, n)
        assert np.array_equal(sc.perm, sc_j.perm)
        assert np.array_equal(sc.seg_ids, sc_j.seg_ids)
        assert detect_dof_group(gidx, n) == jax_detect_dof_group(gidx, n)
