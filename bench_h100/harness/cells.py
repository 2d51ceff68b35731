"""Find a cell's configuration, traffic mix and metric readers by name.

`BENCHMARK.json` names everything; each piece is a file of its own under
this folder, so a new cell or metric is new files and new entries:

- configuration `<c>`: `configs/<c>.json` (the file `BENCHMARK.json`
  gives for it);
- traffic mix `<t>`: `traffic/<t>.json`;
- metric `<m>`: `metrics/<m>.py`, whose `read(run)` returns the number
  or None where the run gives it nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: its end-to-end metrics untraced,
        its per-layer metrics traced."""
        return self.per_layer if trace else self.end_to_end


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(repo_dir: str = REPO_DIR) -> dict:
    return _load_json(os.path.join(repo_dir, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, bench: Optional[dict] = None,
              repo_dir: str = REPO_DIR) -> Cell:
    bench = bench if bench is not None else load_benchmark(repo_dir)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = _load_json(os.path.join(repo_dir, cfg_entry["file"]))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic",
                                      f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in moved and _reports(m, name)]
    return Cell(name, int(w["chips"]), w["config"], config, w["traffic"],
                traffic, e2e, layer)


def metric_reader(name: str) -> Callable:
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every metric whose reader finds a
    number in `run`."""
    out = {}
    for m in metrics:
        v = metric_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
