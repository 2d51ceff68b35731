"""Vectorized small-matrix kernels (much faster than np.linalg for batched
2x2/3x3 operations on millions of quadrature points).

Copied from palace_tpu/utils/smallmat.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import numpy as np


def det(A: np.ndarray) -> np.ndarray:
    """Determinant over the last two axes (1x1, 2x2, or 3x3)."""
    n = A.shape[-1]
    if n == 1:
        return A[..., 0, 0].copy()
    if n == 2:
        return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    if n == 3:
        return (
            A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
        )
    return np.linalg.det(A)


def inv(A: np.ndarray, detA: np.ndarray | None = None) -> np.ndarray:
    """Inverse over the last two axes (1x1, 2x2, or 3x3)."""
    n = A.shape[-1]
    if detA is None:
        detA = det(A)
    if n == 1:
        return (1.0 / A[..., 0, 0])[..., None, None]
    out = np.empty_like(A)
    if n == 2:
        out[..., 0, 0] = A[..., 1, 1]
        out[..., 0, 1] = -A[..., 0, 1]
        out[..., 1, 0] = -A[..., 1, 0]
        out[..., 1, 1] = A[..., 0, 0]
        return out / detA[..., None, None]
    if n == 3:
        out[..., 0, 0] = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
        out[..., 0, 1] = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
        out[..., 0, 2] = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
        out[..., 1, 0] = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
        out[..., 1, 1] = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
        out[..., 1, 2] = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
        out[..., 2, 0] = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
        out[..., 2, 1] = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
        out[..., 2, 2] = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
        return out / detA[..., None, None]
    return np.linalg.inv(A)
