"""Temporal excitation pulse shapes g(t) and derivatives g'(t)
(reference: palace/utils/excitations.hpp:16-113).

Copied from palace_tpu/utils/excitations.py, imports pointed at palace_torch.
"""

from __future__ import annotations

import math


def pulse_sinusoidal(t, omega, t0):
    return math.sin(omega * (t - t0))


def dpulse_sinusoidal(t, omega, t0):
    return omega * math.cos(omega * (t - t0))


def pulse_gaussian(t, tau, t0):
    ts = t - t0
    return math.exp(-0.5 * ts * ts / (tau * tau))


def dpulse_gaussian(t, tau, t0):
    ts = t - t0
    oot2 = 1.0 / (tau * tau)
    return -ts * oot2 * math.exp(-0.5 * ts * ts * oot2)


def pulse_gaussian_diff(t, tau, t0):
    ts = t - t0
    oot2 = 1.0 / (tau * tau)
    return -ts * oot2 * math.exp(-0.5 * ts * ts * oot2)


def dpulse_gaussian_diff(t, tau, t0):
    ts = t - t0
    oot2 = 1.0 / (tau * tau)
    return -oot2 * (1.0 - ts * ts * oot2) * math.exp(-0.5 * ts * ts * oot2)


def pulse_gaussian_mod(t, omega, tau, t0):
    ts = t - t0
    return math.sin(omega * ts) * math.exp(-0.5 * ts * ts / (tau * tau))


def dpulse_gaussian_mod(t, omega, tau, t0):
    ts = t - t0
    oot2 = 1.0 / (tau * tau)
    return (-ts * oot2 * math.sin(omega * ts) + omega * math.cos(omega * ts)) \
        * math.exp(-0.5 * ts * ts * oot2)


def pulse_ramp(t, tau, t0):
    return 0.0 if t <= t0 else (1.0 if t - t0 >= tau else (t - t0) / tau)


def dpulse_ramp(t, tau, t0):
    return 0.0 if (t <= t0 or t - t0 >= tau) else 1.0 / tau


def pulse_smootherstep(t, tau, t0):
    ts = 0.0 if t <= t0 else (1.0 if t - t0 >= tau else (t - t0) / tau)
    return ts * ts * ts * (6.0 * ts * ts - 15.0 * ts + 10.0)


def dpulse_smootherstep(t, tau, t0):
    ts = 0.0 if t <= t0 else (1.0 if t - t0 >= tau else (t - t0) / tau)
    return ts * ts / tau * (30.0 * ts * ts - 60.0 * ts + 30.0)


def get_excitation(cfg, dot: bool):
    """(reference: palace/drivers/transientsolver.cpp:118-205)."""
    kind = cfg.excitation
    delay = (4.5 * cfg.pulse_tau
             if kind in ("Gaussian", "DifferentiatedGaussian", "ModulatedGaussian")
             else 0.0)
    if kind == "Sinusoidal":
        f = dpulse_sinusoidal if dot else pulse_sinusoidal
        return lambda t: f(t, cfg.pulse_f, delay)
    if kind == "Gaussian":
        f = dpulse_gaussian if dot else pulse_gaussian
        return lambda t: f(t, cfg.pulse_tau, delay)
    if kind == "DifferentiatedGaussian":
        f = dpulse_gaussian_diff if dot else pulse_gaussian_diff
        return lambda t: f(t, cfg.pulse_tau, delay)
    if kind == "ModulatedGaussian":
        f = dpulse_gaussian_mod if dot else pulse_gaussian_mod
        return lambda t: f(t, cfg.pulse_f, cfg.pulse_tau, delay)
    if kind in ("Ramp", "RampStep"):
        f = dpulse_ramp if dot else pulse_ramp
        return lambda t: f(t, cfg.pulse_tau, delay)
    if kind in ("SmoothStep", "SmootherStep"):
        f = dpulse_smootherstep if dot else pulse_smootherstep
        return lambda t: f(t, cfg.pulse_tau, delay)
    raise ValueError(f"unknown excitation type {kind}")
