"""freq_setup_s: seconds of BlockedDeviceSolver.add_omega per frequency in
the window (lambda_max estimates and the coarse LU; host clock)."""


def read(run):
    t = run.window_totals().get("freq_setup")
    return t[0] / t[1] if t and t[1] else None
