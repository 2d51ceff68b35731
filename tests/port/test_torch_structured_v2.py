"""The carry-class structured apply (the counterpart of Pallas kernel #2,
`structured_apply_flat_v2`): its tables against palace_tpu's exactly; its
plain version against the Pallas kernel run in interpret mode in float32 at
1e-5 relative (the Pallas body accumulates in float32); its lattice apply
against palace_tpu's convolution in float64 at 1e-12 relative; the solver's
class-layout term apply against the natural-layout one at 1e-12; and the
kernel wrapper's CPU dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palace_tpu.ops import pallas_structured as jps
from palace_tpu.ops.structured import StructuredNDOperator as JaxSOp
from palace_torch.fem.nd import NDSpace
from palace_torch.fem.nd_operators import nd_operator
from palace_torch.interop import structured_from_numpy
from palace_torch.linalg.device_ksp import Term
from palace_torch.mesh.generate import box_hex
from palace_torch.ops import structured_kernel as sk
from palace_torch.ops.partial import signed_tables
from palace_torch.ops.structured import (
    StructuredNDOperator, StructuredTermApply)

LAYOUTS = [(p, shape) for p in (1, 2, 3)
           for shape in ((3, 2, 4), (1, 1, 1), (4, 3, 2))]


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("p,shape", LAYOUTS)
def test_class_tables_match_jax(p, shape):
    perm_c, perm_l, slices = sk._class_tables(p, shape)
    perm_c_j, perm_l_j, slices_j = jps._class_tables(p, shape)
    assert np.array_equal(perm_c, perm_c_j)
    assert np.array_equal(perm_l, perm_l_j)
    assert slices == slices_j
    jsop = JaxSOp.build_uniform(p, shape, 0.5, dtype=jnp.float64, mass=0.3)
    Af_perm, perm_c = sk.v2_tables(structured_from_numpy(jsop))
    Af_perm_j, perm_c_j = jps.v2_tables(jsop)
    assert np.array_equal(Af_perm, np.asarray(Af_perm_j))
    assert np.array_equal(perm_c, perm_c_j)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_plain_v2_matches_pallas_float32(p):
    shape = (3, 2, 4)
    jsop = JaxSOp.build_uniform(p, shape, 0.25, dtype=jnp.float32)
    Af_perm, _ = sk.v2_tables(structured_from_numpy(jsop))
    Af_perm = Af_perm.astype(np.float32)
    rng = np.random.default_rng(p)
    u = rng.standard_normal((2, 3 * p ** 3, sk.flat_size(p, shape))).astype(
        np.float32)
    y_j = np.asarray(jps.structured_apply_flat_v2(
        jnp.asarray(Af_perm), jnp.asarray(u), p=p, shape=shape,
        interpret=True), np.float64)
    y = sk.structured_apply_flat_v2_ref(torch.as_tensor(Af_perm),
                                        torch.as_tensor(u), p=p, shape=shape)
    assert y.dtype == torch.float32
    assert _rel(y.numpy().astype(np.float64), y_j) < 1e-5


@pytest.mark.parametrize("p,shape", [(1, (3, 2, 4)), (2, (3, 2, 4)),
                                     (3, (3, 2, 4)), (2, (5, 3, 2))])
def test_lattice_v2_matches_jax_conv_float64(p, shape):
    jsop = JaxSOp.build_uniform(p, shape, 0.25, dtype=jnp.float64, mass=0.7)
    lat = np.random.default_rng(10 + p).standard_normal(
        (2,) + jsop.lat_gdof.shape)
    y_j = np.asarray(jsop(jnp.asarray(lat)))
    y = sk.structured_apply_lattice_v2(structured_from_numpy(jsop),
                                       torch.as_tensor(lat)).numpy()
    assert _rel(y, y_j) < 1e-12


@pytest.mark.parametrize("p", [2, 3])
def test_class_term_apply_equals_natural(p):
    """The solver's fine-level term apply in the carry-class layout (second
    kernel) against the natural layout (first kernel) on the same terms,
    vectors mapped through each layout's lattice permutation."""
    space = NDSpace(box_hex(3, 2, 4, lx=0.75, ly=0.5, lz=1.0), p)
    ess = np.zeros(space.num_dofs, bool)
    ess[space.boundary_dofs([1, 2, 3, 4, 5, 6])] = True
    K = nd_operator(space, curl_coef={1: np.eye(3)})
    M = nd_operator(space, mass_coef={1: 2.0 * np.eye(3)})
    terms = [Term("K", signed_tables(K.buckets), lambda w: 1.0 + 0.0j),
             Term("M", signed_tables(M.buckets), lambda w: -w * w)]
    dev = torch.device("cpu")
    nat = StructuredTermApply.build(space, terms, ess, dev)
    cls = StructuredTermApply.build(space, terms, ess, dev, layout="class")
    assert cls.layout == "class" and nat.layout == "natural"
    assert np.array_equal(np.sort(cls.perm), np.sort(nat.perm))
    rng = np.random.default_rng(p)
    F = 3
    x = np.zeros((space.num_dofs, F), complex)
    x[nat.perm] = (rng.standard_normal((len(nat.perm), F))
                   + 1j * rng.standard_normal((len(nat.perm), F)))
    coefs = torch.as_tensor(rng.standard_normal((2, F))
                            + 1j * rng.standard_normal((2, F)))
    y_nat = np.zeros_like(x)
    y_nat[nat.perm] = nat(coefs, torch.as_tensor(x[nat.perm])).numpy()
    y_cls = np.zeros_like(x)
    y_cls[cls.perm] = cls(coefs, torch.as_tensor(x[cls.perm])).numpy()
    assert _rel(y_cls, y_nat) < 1e-12


def test_cpu_wrapper_v2_runs_plain_version_without_launch():
    p, shape = 2, (3, 2, 4)
    Af_perm, _ = sk.v2_tables(StructuredNDOperator.build_uniform(p, shape,
                                                                 0.25))
    rng = np.random.default_rng(4)
    u = torch.as_tensor(rng.standard_normal(
        (3, 3 * p ** 3, sk.flat_size(p, shape))))
    Af_perm = torch.as_tensor(Af_perm)
    before = sk.structured_apply_flat_v2.launches
    y = sk.structured_apply_flat_v2(Af_perm, u, p=p, shape=shape)
    assert sk.structured_apply_flat_v2.launches == before
    assert torch.equal(y, sk.structured_apply_flat_v2_ref(Af_perm, u, p=p,
                                                          shape=shape))
    with pytest.raises(ValueError):
        sk.structured_apply_flat_v2(Af_perm, u[:, :, :-1], p=p, shape=shape)
    with pytest.raises(ValueError):
        sk.structured_apply_flat_v2(Af_perm.float(), u, p=p, shape=shape)
