"""Cells of BENCHMARK.json cut to sizes a CPU test holds."""

import copy

from harness import cells

#: (cells, order) a CPU test runs each configuration at.
SMALL = {"cavity-p3": ([3, 3, 3], 2), "wr90-p3": ([6, 4, 3], 2)}


def small_cell(name: str):
    cell = cells.find_cell(name)
    cell.config = copy.deepcopy(cell.config)
    shape, order = SMALL[cell.config_name]
    cell.config["mesh"]["cells"] = shape
    cell.config["palace"]["Solver"]["Order"] = order
    cell.traffic = dict(cell.traffic, host_threads=2)
    return cell
