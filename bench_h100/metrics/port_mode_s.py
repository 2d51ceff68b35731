"""port_mode_s: host seconds of the wave ports' mode solves
(models/waveport.py:solve_mode, the program's provenance counter
waveport_mode_seconds) per frequency in the window; nothing where the
configuration has no wave port."""


def read(run):
    n = sum(len(r.freqs_ghz) for r in run.requests)
    if not run.counters.get("waveport_mode_solves") or not n:
        return None
    return run.counters["waveport_mode_seconds"] / n
