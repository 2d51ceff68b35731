"""assembly_s: the span around SpaceOperator(...) in set-up (host clock)."""


def read(run):
    t = run.setup_totals().get("assembly")
    return t[0] if t else None
