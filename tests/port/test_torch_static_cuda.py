"""The static drivers on the card against the CPU (palace_torch only).  The
test needs a CUDA device and skips without one; the file imports no jax, so
on a machine without JAX run it as
    python -m pytest tests/port/test_torch_static_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

import palace_torch
from palace_torch.cases import write_rings_case


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.cuda
def test_rings_static_on_card_matches_cpu(tmp_path):
    """One rings solve of each static driver on the GPU against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for problem, key in (("Electrostatic", "C"), ("Magnetostatic", "M")):
        res = {}
        for device in ("GPU", "CPU"):
            path = write_rings_case(str(tmp_path / f"{problem}{device}"), 4.0,
                                    1, problem=problem, tol=1e-10,
                                    max_its=3000, device=device, verbose=0)
            res[device] = palace_torch.run(path)
        assert _rel(res["GPU"][key], res["CPU"][key]) <= 1e-8
        assert max(res["GPU"]["provenance"]["cg_relres"]) <= 1e-10
