"""The hand-written structured-apply kernels (natural channel order and
carry-class order) against their plain PyTorch versions on the card (float64
tolerance 1e-12, float32 1e-5, relative to max |y|).  At p = 3 the shapes
(2, 3, 31) and (2, 2, 33) have three and four windows, so the kernel keeps
three and two k-chunks in shared memory instead of four; at p = 4 the kernel
takes its 39 n-tiles in two passes.  These tests need a
CUDA device and skip without one; the file imports no jax, so on a machine
without JAX run it as
    python -m pytest tests/port/test_torch_kernel_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from palace_torch.ops import structured_kernel as sk
from palace_torch.ops.structured import StructuredNDOperator


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _inputs(p, shape, dtype, device, batch=16, seed=5):
    sop = StructuredNDOperator.build_uniform(p, shape, 0.25, mass=0.5)
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.standard_normal(
        (batch, 3 * p ** 3, sk.flat_size(p, shape))), dtype=dtype,
        device=device)
    return torch.as_tensor(sop.Af, dtype=dtype, device=device), u


@pytest.mark.cuda
@pytest.mark.parametrize("p,shape", [(1, (3, 2, 4)), (2, (3, 2, 4)),
                                     (3, (3, 2, 4)), (2, (5, 7, 3)),
                                     (3, (2, 3, 31)), (3, (2, 2, 33)),
                                     (4, (3, 2, 4)), (4, (6, 5, 7))])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_kernel_matches_plain_on_card(cuda_device, p, shape, dtype, tol):
    Af, u = _inputs(p, shape, dtype, cuda_device)
    before = sk.structured_apply_flat.launches
    y = sk.structured_apply_flat(Af, u, p=p, shape=shape)
    torch.cuda.synchronize()
    assert sk.structured_apply_flat.launches == before + 1
    y_ref = sk.structured_apply_flat_ref(Af, u, p=p, shape=shape)
    assert float((y - y_ref).abs().max()) <= tol * float(y_ref.abs().max())


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda_device):
    p, shape = 2, (3, 2, 4)
    Af, u = _inputs(p, shape, torch.float64, cuda_device)
    with pytest.raises(ValueError):  # not contiguous
        sk.structured_apply_flat(Af.T, u, p=p, shape=shape)
    with pytest.raises(ValueError):  # dtype mismatch
        sk.structured_apply_flat(Af.float(), u, p=p, shape=shape)
    with pytest.raises(ValueError):  # no kernel for complex data
        sk.structured_apply_flat(Af.to(torch.complex128),
                                 u.to(torch.complex128), p=p, shape=shape)


@pytest.mark.cuda
@pytest.mark.parametrize("p,shape", [(1, (3, 2, 4)), (2, (3, 2, 4)),
                                     (3, (3, 2, 4)), (2, (5, 7, 3)),
                                     (3, (12, 12, 12)), (3, (2, 3, 31)),
                                     (3, (2, 2, 33)), (4, (3, 2, 4)),
                                     (4, (6, 5, 7))])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_class_kernel_matches_plain_on_card(cuda_device, p, shape, dtype,
                                            tol):
    Af, u = _inputs(p, shape, dtype, cuda_device)
    Af_perm, _ = sk.v2_tables(StructuredNDOperator.build_uniform(
        p, shape, 0.25, mass=0.5))
    Af_perm = torch.as_tensor(Af_perm, dtype=dtype, device=cuda_device)
    before = sk.structured_apply_flat_v2.launches
    y = sk.structured_apply_flat_v2(Af_perm, u, p=p, shape=shape)
    torch.cuda.synchronize()
    assert sk.structured_apply_flat_v2.launches == before + 1
    y_ref = sk.structured_apply_flat_v2_ref(Af_perm, u, p=p, shape=shape)
    assert float((y - y_ref).abs().max()) <= tol * float(y_ref.abs().max())


@pytest.mark.cuda
def test_class_lattice_apply_matches_natural_on_card(cuda_device):
    """Both kernels compute the same operator: the carry-class lattice apply
    equals the natural-order one after the channel permutation."""
    p, shape = 3, (5, 4, 6)
    sop = StructuredNDOperator.build_uniform(p, shape, 0.25, mass=0.5)
    lat = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (4,) + sop.lat_gdof.shape), device=cuda_device)
    y1 = sk.structured_apply_lattice(sop, lat)
    y2 = sk.structured_apply_lattice_v2(sop, lat)
    assert float((y1 - y2).abs().max()) <= 1e-12 * float(y1.abs().max())
