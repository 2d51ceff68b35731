"""krylov_s: seconds of BlockedDeviceSolver.solve per frequency in the
window; the solve ends in the host copy of X, so the span is synchronised
(host clock)."""


def read(run):
    t = run.window_totals().get("krylov")
    return t[0] / t[1] if t and t[1] else None
