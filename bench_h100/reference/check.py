"""The comparison that decides `correct`.

It judges what a program (or the lower-precision control put in its
place) produced, against the float64 reference worked out anew from the
configuration and the mesh (reference/driven.py):

- `operator`: the largest entry of |K - K_ref|, |M - M_ref| (M with its
  complex permittivity) and, with wave ports, of the port terms
  |A2 - A2_ref| at one requested frequency, each over the largest entry
  of the reference's;
- `load`: the same for the excitation b(omega) at that frequency;
- `residual`: the largest ||A_ref(omega) x - b_ref(omega)|| / ||b_ref|| of
  every solution column x the window produced, omega from the requested
  frequency;
- `energy`: the largest relative gap between the program's E_elec and
  E_mag of a column and the reference's of the same column;
- `sparam` (configurations with ports): the largest |S - S_ref| of a
  column and port, S_ref from the same column.

The configuration's `check` block names the numbers its cells compare and
holds each one's limit (set from readings of sound runs and of the
control; PERF.md lists them).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from reference.driven import DrivenReference


def _rel_max(a, b) -> float:
    if a is None or b is None:
        return 0.0 if a is None and b is None else float("inf")
    if a.shape != b.shape:
        return float("inf")
    d = abs(a - b).max()
    s = abs(b).max()
    return float(d / s) if s > 0 else float(d)


def _rel(a: float, b: float) -> float:
    if b == 0:
        return 0.0 if a == 0 else float("inf")
    return float(abs(a - b) / abs(b))


def judge(config: dict, mesh, out: dict, ref: DrivenReference | None = None
          ) -> Dict[str, float]:
    """{name: number} of one run's outputs `out`: K, M, A2 (sparse or
    None), b at f_ghz, and columns [{f_ghz, x, energies, S}]."""
    ref = ref if ref is not None else DrivenReference(config, mesh)
    c128 = np.complex128
    w0 = ref.omega(out["f_ghz"])
    a2 = ref.a2(w0)
    nums = {
        "operator": max(
            _rel_max(out["K"].astype(c128), ref.K),
            _rel_max(out["M"].astype(c128),
                     ref.eps_c() * ref.M.astype(c128)),
            _rel_max(None if out["A2"] is None else out["A2"].astype(c128),
                     a2)),
        "load": _rel_max(np.asarray(out["b"], c128), ref.rhs(w0)),
    }
    res = en = sp = 0.0
    if not out["columns"]:
        res = en = sp = float("inf")
    for c in out["columns"]:
        x = np.asarray(c["x"])
        if x.shape != (ref.space.num_dofs,) or not np.all(np.isfinite(x)):
            res = en = sp = float("inf")
            continue
        x = x.astype(c128)
        w = ref.omega(c["f_ghz"])
        b = ref.rhs(w)
        res = max(res, float(np.linalg.norm(ref.apply(x, w) - b)
                             / np.linalg.norm(b)))
        e, m = ref.energies(x, w)
        pe, pm = c["energies"]
        en = max(en, _rel(pe, e), _rel(pm, m))
        for idx, s in ref.sparams(x, w).items():
            sp = max(sp, abs(complex(c["S"].get(idx, np.inf)) - s))
    nums["residual"], nums["energy"], nums["sparam"] = res, en, float(sp)
    return {k: nums[k] for k in config["check"]}


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(np.isfinite(nums[k]) and nums[k] <= limits[k] for k in limits)


def lines(nums: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"check {k} {nums[k]!r} limit {limits[k]!r}" for k in limits]
