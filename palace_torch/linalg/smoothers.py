"""Jacobi preconditioner (counterpart of palace_tpu/linalg/smoothers.py
`jacobi`; reference: palace/linalg/jacobi.hpp:15)."""

from __future__ import annotations

from typing import Callable

import torch


def jacobi(diag: torch.Tensor, ess_mask: torch.Tensor | None = None
           ) -> Callable:
    """Inverse-diagonal preconditioner (identity where the diagonal is 0,
    and on the essential dofs of `ess_mask` when one is given)."""
    dinv = 1.0 / torch.where(diag != 0, diag, torch.ones_like(diag))
    if ess_mask is not None:
        dinv = torch.where(ess_mask, torch.ones_like(dinv), dinv)

    def apply(r):
        return dinv * r

    return apply
