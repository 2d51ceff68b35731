"""A run with the timed path broken underneath comes out not correct:
one fault of each kind a solve cell can have (a single card has no
exchange between chips to leave out)."""

import numpy as np
import pytest
import torch

import run as bench_run
from small import small_cell


def _patch_solve(monkeypatch, fault):
    from palace_torch.linalg.device_ksp import BlockedDeviceSolver

    solve = BlockedDeviceSolver.solve

    def broken(self, rhs, omega_idx=None):
        X, info = solve(self, rhs, omega_idx)
        return fault(X, rhs), info

    monkeypatch.setattr(BlockedDeviceSolver, "solve", broken)


def unchanged(X, rhs):
    """The solve hands back its starting state."""
    return np.zeros_like(X)


def half_batch(X, rhs):
    """Half of the block solved; the other half the mean of the rest."""
    Y = X.copy()
    h = max(1, X.shape[1] // 2)
    Y[:, h:] = X[:, :h].mean(axis=1, keepdims=True)
    if X.shape[1] == 1:
        Y[:, 0] *= 0.5
    return Y


def altered(X, rhs):
    """One answer changed where it is produced."""
    Y = X.copy()
    k = int(np.argmax(np.abs(Y[:, 0])))
    Y[k, 0] *= 1.0 + 1e-6
    return Y


@pytest.mark.parametrize("name", ["cavity-p3.sweep", "wr90-p3.sweep"])
@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_fault_not_correct(monkeypatch, name, fault):
    _patch_solve(monkeypatch, fault)
    cell = small_cell(name)
    result, lines = bench_run.run_cell(cell, 2 ** 31 + 3, 0.1, False,
                                       torch.device("cpu"))
    assert not result["correct"], lines


def test_altered_sparam_not_correct(monkeypatch):
    from palace_torch.drivers import driven

    measure = driven.measure_step

    def broken(*a, **k):
        m = measure(*a, **k)
        m.ports[2].S *= 1.0 + 1e-6
        return m

    monkeypatch.setattr(driven, "measure_step", broken)
    result, lines = bench_run.run_cell(small_cell("wr90-p3.sweep"),
                                       2 ** 31 + 3, 0.1, False,
                                       torch.device("cpu"))
    assert not result["correct"], lines
