"""Structured box-hex apply: the port's plain flat-lattice version and its
conv3d reference against palace_tpu's StructuredNDOperator (XLA convolution)
and its Pallas kernel run in interpret mode, plus the builders, the lattice
and flat layouts, the solver's term apply and the kernel wrapper's dispatch.
Tolerances: 1e-12 relative in float64 against the convolution (same
arithmetic, other summation order); 1e-5 relative in float32 against the
Pallas interpret run; layouts and tables exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palace_tpu.fem.nd import NDSpace
from palace_tpu.fem.nd_operators import nd_operator as jax_nd_operator
from palace_tpu.mesh.generate import box_hex
from palace_tpu.linalg.device_ksp import Term as JaxTerm
from palace_tpu.ops.pallas_structured import _flat_tables as jax_flat_tables
from palace_tpu.ops.pallas_structured import (
    structured_apply_lattice as jax_pallas_apply)
from palace_tpu.ops.pallas_structured import to_flat as jax_to_flat
from palace_tpu.ops.structured import StructuredNDOperator as JaxSOp
from palace_tpu.ops.structured import StructuredTermApply as JaxTermApply
from palace_tpu.ops.structured import hex_local_map as jax_hex_local_map
from palace_tpu.ops.structured import pec_ess_lat as jax_pec_ess_lat
from palace_torch.fem.nd import NDSpace as TorchNDSpace
from palace_torch.fem.nd_operators import nd_operator
from palace_torch.interop import structured_from_numpy, terms_from_numpy
from palace_torch.mesh.generate import box_hex as t_box_hex
from palace_torch.ops import structured_kernel as sk
from palace_torch.ops.partial import signed_tables
from palace_torch.ops.structured import (
    StructuredNDOperator, StructuredTermApply, hex_local_map, pec_ess_lat)

SHAPE = (3, 2, 4)
LAYOUTS = [(p, shape) for p in (1, 2, 3)
           for shape in ((3, 2, 4), (1, 1, 1), (4, 3, 2))]


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _spaces(p):
    """The 3 x 2 x 4 PEC box hex space and its essential mask, built by
    palace_tpu and by the port's own copies (same dof numbering)."""
    out = []
    for box, space_cls in ((box_hex, NDSpace), (t_box_hex, TorchNDSpace)):
        space = space_cls(box(3, 2, 4, lx=0.75, ly=0.5, lz=1.0), p)
        ess = np.zeros(space.num_dofs, bool)
        ess[space.boundary_dofs([1, 2, 3, 4, 5, 6])] = True
        out += [space, ess]
    return out


def _lattice(sop, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2,) + sop.lat_gdof.shape).astype(dtype)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_plain_apply_matches_jax_float64(p):
    jsop = JaxSOp.build_uniform(p, SHAPE, 0.25, dtype=jnp.float64, mass=0.7)
    tsop = structured_from_numpy(jsop)
    lat = _lattice(jsop, np.float64)
    y_conv = np.asarray(jsop(jnp.asarray(lat)))
    y_flat = tsop(torch.as_tensor(lat)).numpy()
    y_conv_t = tsop.conv_apply(torch.as_tensor(lat)).numpy()
    assert _rel(y_flat, y_conv) < 1e-12
    assert _rel(y_conv_t, y_conv) < 1e-12


@pytest.mark.parametrize("p,shape", LAYOUTS)
def test_plain_apply_equals_per_dof_slices(p, shape):
    """The plain version's one gather and one scatter-add against the TPU
    kernel body's per-local-dof slice copies, bit for bit (same products,
    same summation order)."""
    chan, offs, mask, _, Lp, Lu, _ = sk._flat_tables(p, shape)
    rng = np.random.default_rng(p)
    nd = len(chan)
    Af = torch.as_tensor(rng.standard_normal((nd, nd)))
    u = torch.as_tensor(rng.standard_normal((3, 3 * p ** 3, Lu)))
    ul = torch.stack([u[:, chan[n], offs[n]:offs[n] + Lp]
                      for n in range(nd)], dim=1)
    vl = torch.matmul(Af, ul) * torch.as_tensor(mask)
    y = torch.zeros_like(u)
    for n in range(nd):
        y[:, chan[n], offs[n]:offs[n] + Lp] += vl[:, n]
    assert torch.equal(sk.structured_apply_flat_ref(Af, u, p=p, shape=shape),
                       y)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_plain_apply_matches_pallas_float32(p):
    jsop = JaxSOp.build_uniform(p, SHAPE, 0.25, dtype=jnp.float32)
    tsop = structured_from_numpy(jsop)
    lat = _lattice(jsop, np.float32, seed=p)
    y_pallas = np.asarray(jax_pallas_apply(jsop, jnp.asarray(lat),
                                           interpret=True), np.float64)
    y_flat = tsop(torch.as_tensor(lat))
    y_conv_t = tsop.conv_apply(torch.as_tensor(lat))
    for y in (y_flat, y_conv_t):
        assert y.dtype == torch.float32
        assert _rel(y.numpy().astype(np.float64), y_pallas) < 1e-5


@pytest.mark.parametrize("p", [1, 2, 3])
def test_build_uniform_matches_jax(p):
    jsop = JaxSOp.build_uniform(p, SHAPE, 0.5, dtype=jnp.float64, curl=1.5,
                                mass=0.3)
    tsop = StructuredNDOperator.build_uniform(p, SHAPE, 0.5, curl=1.5,
                                              mass=0.3)
    assert _rel(tsop.Af, np.asarray(jsop._Af)) < 1e-12
    assert _rel(tsop.W, np.asarray(jsop.W)) < 1e-12
    assert np.array_equal(tsop.ess_lat, np.asarray(jsop.ess_lat))
    assert np.array_equal(tsop.lat_gdof, jsop.lat_gdof)
    assert tsop.num_dofs == jsop.num_dofs


def test_build_from_mesh_matches_jax():
    space, ess, tspace, tess = _spaces(2)
    assert np.array_equal(tess, ess)
    coefs = dict(curl_coef={1: np.eye(3)}, mass_coef={1: 2.0 * np.eye(3)})
    jsop = JaxSOp.build(space, jax_nd_operator(space, dtype=jnp.float64,
                                               **coefs), ess,
                        dtype=jnp.float64)
    tsop = StructuredNDOperator.build(tspace, nd_operator(tspace, **coefs),
                                      tess)
    assert np.array_equal(tsop.lat_gdof, jsop.lat_gdof)
    assert np.array_equal(tsop.ess_lat, np.asarray(jsop.ess_lat))
    assert _rel(tsop.Af, np.asarray(jsop._Af)) < 1e-12
    # The lattice apply equals the assembled operator on free dofs.
    rng = np.random.default_rng(3)
    u = np.where(ess, 0.0, rng.standard_normal(space.num_dofs))
    y = tsop.from_lattice(tsop(torch.as_tensor(tsop.to_lattice(u))).numpy())
    A = nd_operator(tspace, **coefs).assemble_csr()
    assert _rel(y[:, 0], np.where(ess, 0.0, A @ u)) < 1e-12


def test_cpu_wrapper_runs_plain_version_without_launch():
    p = 2
    sop = StructuredNDOperator.build_uniform(p, SHAPE, 0.25)
    rng = np.random.default_rng(4)
    u = torch.as_tensor(rng.standard_normal(
        (3, 3 * p ** 3, sk.flat_size(p, SHAPE))))
    Af = torch.as_tensor(sop.Af)
    before = sk.structured_apply_flat.launches
    y = sk.structured_apply_flat(Af, u, p=p, shape=SHAPE)
    assert sk.structured_apply_flat.launches == before
    assert torch.equal(y, sk.structured_apply_flat_ref(Af, u, p=p,
                                                       shape=SHAPE))
    with pytest.raises(ValueError):
        sk.structured_apply_flat(Af, u[:, :, :-1], p=p, shape=SHAPE)
    with pytest.raises(ValueError):
        sk.structured_apply_flat(Af.float(), u, p=p, shape=SHAPE)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_hex_local_map_matches_jax(p):
    deltas, chan = hex_local_map(p)
    deltas_j, chan_j = jax_hex_local_map(p)
    assert np.array_equal(deltas, deltas_j)
    assert np.array_equal(chan, chan_j)


@pytest.mark.parametrize("p,shape", LAYOUTS)
def test_pec_ess_lat_matches_jax(p, shape):
    assert np.array_equal(pec_ess_lat(p, shape), jax_pec_ess_lat(p, shape))


@pytest.mark.parametrize("p,shape", LAYOUTS)
def test_flat_layout_matches_jax(p, shape):
    chan, offs, mask, *sizes = sk._flat_tables(p, shape)
    chan_j, offs_j, mask_j, *sizes_j = jax_flat_tables(p, shape)
    assert np.array_equal(chan, chan_j) and np.array_equal(offs, offs_j)
    assert np.array_equal(mask, mask_j) and sizes == sizes_j
    lat = np.random.default_rng(p).standard_normal((2, 3 * p ** 3) + shape)
    flat = sk.to_flat(torch.as_tensor(lat), p, shape)
    assert flat.shape == (2, 3 * p ** 3, sk.flat_size(p, shape))
    assert np.array_equal(flat.numpy(), np.asarray(jax_to_flat(
        jnp.asarray(lat), p, shape)))
    assert np.array_equal(sk.from_flat(flat, p, shape).numpy(), lat)


@pytest.mark.parametrize("p", [2, 3])
def test_term_apply_matches_jax(p):
    """The solver's fine-level term apply (complex block, lattice order)
    against palace_tpu's StructuredTermApply on the same term tables."""
    space, ess, tspace, tess = _spaces(p)
    K = nd_operator(tspace, curl_coef={1: np.eye(3)})
    M = nd_operator(tspace, mass_coef={1: 2.0 * np.eye(3)})
    jterms = [JaxTerm("K", signed_tables(K.buckets), lambda w: 1.0 + 0.0j),
              JaxTerm("M", signed_tables(M.buckets), lambda w: -w * w)]
    japply = JaxTermApply.build(space, jterms, ess)
    tapply = StructuredTermApply.build(tspace, terms_from_numpy(jterms), tess,
                                       torch.device("cpu"))
    assert np.array_equal(tapply.perm, japply.perm)
    rng = np.random.default_rng(p)
    F = 3
    u = (rng.standard_normal((len(tapply.perm), F))
         + 1j * rng.standard_normal((len(tapply.perm), F)))
    coefs = (rng.standard_normal((2, F)) + 1j * rng.standard_normal((2, F)))
    y_t = tapply(torch.as_tensor(coefs), torch.as_tensor(u)).numpy()
    y_j = np.asarray(japply(jnp.asarray(coefs), jnp.asarray(u)))
    assert _rel(y_t, y_j) < 1e-12
