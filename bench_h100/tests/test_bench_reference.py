"""The reference against the program at small sizes on the CPU: a run of
each cell is correct, and the float32 control put in the program's place
is not."""

import numpy as np
import pytest
import torch

import run as bench_run
from reference import check
from reference.control import control_numbers
from small import small_cell

CELLS = ["cavity-p3.sweep", "wr90-p3.sweep"]


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct(name):
    cell = small_cell(name)
    result, lines = bench_run.run_cell(cell, 2 ** 31 + 11, 0.5, False,
                                       torch.device("cpu"))
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"solve_s", "setup_s"}
    assert list(result)[-1] == "check"
    for k, v in result["check"].items():
        assert v["value"] <= v["limit"] * 1e-2, (k, v)


@pytest.mark.parametrize("name", ["cavity-p3.sweep", "wr90-p3.sweep"])
def test_float32_control_fails(name):
    cell = small_cell(name)
    nums, correct = control_numbers(cell, 2 ** 31 + 5, 2)
    assert not correct
    limits = cell.config["check"]
    assert nums["operator"] > 10 * limits["operator"]
    assert nums["residual"] > 10 * limits["residual"]


def test_reference_space_matches_program():
    """The frozen dof layout against the program's: numbering, signs and
    the PEC set of the small cavity."""
    import json
    import tempfile

    from harness.meshgen import box_hex, write_msh
    from palace_torch.config import IoData
    from palace_torch.drivers.common import prepare_mesh
    from palace_torch.fem.nd import NDSpace
    from reference.driven import DrivenReference

    cell = small_cell("cavity-p3.sweep")
    mesh = box_hex(cell.config["mesh"]["cells"], cell.config["mesh"]["size"])
    with tempfile.TemporaryDirectory() as d:
        write_msh(mesh, f"{d}/box.msh")
        with open(f"{d}/c.json", "w") as f:
            json.dump(cell.config["palace"], f)
        io = IoData(f"{d}/c.json")
        space = NDSpace(prepare_mesh(io), 2)
    ref = DrivenReference(cell.config, mesh)
    assert np.array_equal(space.elem_dofs[0], ref.space.elem_dofs)
    assert np.array_equal(space.elem_signs[0], ref.space.signs)
    assert np.array_equal(np.sort(space.boundary_dofs(range(1, 7))),
                          np.flatnonzero(ref.ess))


def test_port_mode_at_full_face():
    """The guide's port at its full cross-section (8 x 6 faces, Order 3):
    the trace dofs' mass is positive definite (other dofs' traces are
    rounding), and the mode's kn is the TE10 line's to discretization."""
    import math

    from harness.meshgen import box_hex
    from reference.driven import DrivenReference

    cell = small_cell("wr90-p3.sweep")
    cell.config["mesh"]["cells"] = [1, 8, 6]
    cell.config["palace"]["Solver"]["Order"] = 3
    m = cell.config["mesh"]
    ref = DrivenReference(cell.config, box_hex(m["cells"], m["size"]))
    w = ref.omega(10.0)
    a = m["size"][1] / max(m["size"])  # 22.86 mm over Lc
    for p in ref.ports:
        kn = ref.kn(p, w)
        assert kn == pytest.approx(math.sqrt(w * w - (math.pi / a) ** 2),
                                   rel=1e-6)
