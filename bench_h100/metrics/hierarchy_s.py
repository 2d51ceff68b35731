"""hierarchy_s: the span around BlockedDeviceSolver(...) in set-up: the
p-multigrid levels, transfers, auxiliary spaces and device tables (host
clock)."""


def read(run):
    t = run.setup_totals().get("hierarchy")
    return t[0] if t else None
