"""The card's peaks and the work of kernel #1, for roofline shares.

Kernel #1 (`structured_apply_flat`, csrc/structured_apply.cu) applies one
order-p Nedelec element matrix Af (nd x nd, nd = 3 p (p + 1)^2) to B real
columns on a uniform nx x ny x nz hex lattice held in a flat padded layout
of C = 3 p^3 channels, each Lu long.  Its least work:

- operations: 2 nd^2 per real cell and column;
- bytes: u read and y written once (B C Lu values each), Af and the
  cell mask (Lp values) read once.

The layout sizes follow the kernel's flat lattice: strides sx = (ny + 1)
(nz + 1), sy = nz + 1; L0 = (nx - 1) sx + (ny - 1) sy + nz covers the
cells, Lp rounds it up to 128, and Lu = round128(Lp + sx + sy) + 128 adds
the largest local-dof offset (sx + sy) and a tile of padding.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM data-sheet peaks: HBM3 bytes/s and float64 FLOP/s (the
#: DMMA tensor-core rate), at the 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_FLOPS_F64 = 67e12


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel1_layout(p: int, shape):
    nx, ny, nz = (int(s) for s in shape)
    sx, sy = (ny + 1) * (nz + 1), nz + 1
    L0 = (nx - 1) * sx + (ny - 1) * sy + (nz - 1) + 1
    Lp = _round_up(L0, 128)
    Lu = _round_up(Lp + sx + sy, 128) + 128
    return Lp, Lu


def kernel1_ops(p: int, shape, batch: int) -> float:
    nd = 3 * p * (p + 1) ** 2
    return 2.0 * nd * nd * math.prod(int(s) for s in shape) * batch


def kernel1_bytes(p: int, shape, batch: int, itemsize: int = 8) -> float:
    nd, C = 3 * p * (p + 1) ** 2, 3 * p ** 3
    Lp, Lu = kernel1_layout(p, shape)
    return float((2 * batch * C * Lu + nd * nd + Lp) * itemsize)


def kernel1_bound_s(p: int, shape, batch: int) -> float:
    """The least time of one float64 launch: the larger of bytes over the
    memory rate and operations over the float64 peak."""
    return max(kernel1_bytes(p, shape, batch) / PEAK_BYTES,
               kernel1_ops(p, shape, batch) / PEAK_FLOPS_F64)
