"""The port imports nothing of JAX and nothing of the JAX package.

- Statically: an AST scan of every palace_torch source, chip_smoke.py,
  the ranks of the sharded tests (tests/port/sharded_worker.py) and the
  port's scripts (profile_torch_slice.py, mutate_kernels.py,
  ab_kernel_core.py, rehearse_smoke_cpu.py) finds no import of jax, jaxlib or
  palace_tpu, function-level imports and string imports (`__import__`,
  `importlib.import_module`) included; nor does any of them load a
  module from a file path (`spec_from_file_location`, `runpy.run_path`),
  which would bring in code the scan does not read.
- At run time: in a fresh interpreter whose import system refuses those
  packages, every palace_torch module imports, the 3^3 driven slice case,
  the box-tet eigenmode case (host branch), a coarse rings magnetostatic
  case, a hex electrostatic AMR pass (nonconforming refinement and its
  host solve), the WR-90 guide between two wave ports (device solver) and
  its adaptive sweep ended by a second-order absorbing boundary, the
  copper-walled cavity (damped eigen branch), the shorted guide's
  nonlinear eigenproblem, a driven tet AMR loop, a transient TEM line, the
  driven line's surface tables and ParaView output and the dipole's far
  field run on the CPU, and neither package is in sys.modules at the end.  The eigenmode device branch runs
  under the same guard in test_torch_eigen.py."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REFUSED = ("jax", "jaxlib", "palace_tpu")

SCRIPT = r"""
import importlib, json, os, pkgutil, sys

REFUSED = ("jax", "jaxlib", "palace_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("import refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import palace_torch
for m in pkgutil.walk_packages(palace_torch.__path__, "palace_torch."):
    importlib.import_module(m.name)
from palace_torch.cases import write_slice_case
from palace_torch.mesh import gmsh_write
from palace_torch.mesh.generate import box_tet

res = palace_torch.run(write_slice_case(os.path.join(sys.argv[1], "driven"),
                                        3, 2, tol=1e-10, device="CPU",
                                        verbose=0))
assert res["num_dofs"] == 882
eig = os.path.join(sys.argv[1], "eigen")
os.makedirs(eig)
gmsh_write.write(box_tet(3, 3, 3), os.path.join(eig, "box.msh"))
with open(os.path.join(eig, "case.json"), "w") as f:
    json.dump({
        "Problem": {"Type": "Eigenmode", "Verbose": 0, "Output": "postpro"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-2},
        "Domains": {"Materials": [{"Attributes": [1], "Permittivity": 1.0}]},
        "Boundaries": {"PEC": {"Attributes": [1, 2, 3, 4, 5, 6]}},
        "Solver": {"Order": 2, "Device": "CPU",
                   "Eigenmode": {"N": 3, "Target": 15.0, "Tol": 1e-9},
                   "Linear": {"Tol": 1e-9}}}, f)
res = palace_torch.run(os.path.join(eig, "case.json"))
assert len(res["frequencies_ghz"]) == 3
from palace_torch.cases import write_rings_case
from palace_torch.mesh.generate import box_hex

res = palace_torch.run(write_rings_case(os.path.join(sys.argv[1], "mag"),
                                        4.0, 1, device="CPU", verbose=0))
assert res["M"].shape == (2, 2)
amr = os.path.join(sys.argv[1], "amr")
os.makedirs(amr)
gmsh_write.write(box_hex(2, 2, 2), os.path.join(amr, "box.msh"))
with open(os.path.join(amr, "case.json"), "w") as f:
    json.dump({
        "Problem": {"Type": "Electrostatic", "Verbose": 0, "Output": "out"},
        "Model": {"Mesh": "box.msh", "L0": 1.0e-3,
                  "Refinement": {"Tol": 1e-12, "MaxIts": 1}},
        "Domains": {"Materials": [{"Attributes": [1], "Permittivity": 1.0}]},
        "Boundaries": {"Terminal": [{"Index": 1, "Attributes": [1]}],
                       "Ground": {"Attributes": [5]}},
        "Solver": {"Order": 1, "Device": "CPU",
                   "Linear": {"Tol": 1e-12}}}, f)
res = palace_torch.run(os.path.join(amr, "case.json"))
assert res["amr_iterations"] == 1
assert res["provenance"]["solver_path"] == "direct-nonconforming"
from palace_torch.cases import write_waveguide_case

res = palace_torch.run(write_waveguide_case(
    os.path.join(sys.argv[1], "guide"), 6, 3, 2, 1, device="CPU", verbose=0))
assert res["provenance"]["solver_path"] == "device"
assert res["provenance"]["waveport1_deflation"]
res = palace_torch.run(write_waveguide_case(
    os.path.join(sys.argv[1], "guide_a"), 6, 3, 2, 1, termination="absorbing",
    adaptive=True, device="CPU", verbose=0))
assert res["provenance"]["prom_hdm_path"] == "direct-slow-a2"
from palace_torch.cases import (write_amr_driven_case, write_cavity_case,
                                write_guide_eigen_case)

res = palace_torch.run(write_cavity_case(
    os.path.join(sys.argv[1], "cavity"), 4, 2, 5, 1, device="CPU", verbose=0))
assert res["provenance"]["eigen_path"] == "quadratic-jd"
res = palace_torch.run(write_guide_eigen_case(
    os.path.join(sys.argv[1], "guide_e"), 6, 3, 2, 1, device="CPU",
    verbose=0))
assert len(res["provenance"]["nonlinear_refine_iterations"]) == 2
res = palace_torch.run(write_amr_driven_case(
    os.path.join(sys.argv[1], "amr_d"), 2, 1, linear="Default", device="CPU",
    verbose=0))
assert res["amr_iterations"] == 1
from palace_torch.cases import write_dipole_case, write_tem_line_case

res = palace_torch.run(write_tem_line_case(
    os.path.join(sys.argv[1], "line"), 10.0, 2, 2, 1, max_time=0.004,
    device="CPU", verbose=0))
assert len(res["rows"]) == 3
res = palace_torch.run(write_tem_line_case(
    os.path.join(sys.argv[1], "line_d"), 10.0, 2, 2, 1, problem="Driven",
    save_freqs=[15.0], postprocessing={
        "SurfaceFlux": [{"Index": 1, "Attributes": [2], "Type": "Power"}],
        "Dielectric": [{"Index": 1, "Attributes": [2], "Thickness": 0.01,
                        "Permittivity": 10.0, "LossTan": 0.01}]},
    device="CPU", verbose=0))
assert os.path.exists(os.path.join(res["post_dir"], "surface-Q.csv"))
res = palace_torch.run(write_dipole_case(
    os.path.join(sys.argv[1], "dipole"), 2, 1, device="CPU", verbose=0))
assert res["measurements"][(1, 0)].farfield.shape == (3, 3)
assert not any(k.split(".")[0] in REFUSED for k in sys.modules)
print("NOJAX-OK")
"""


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tests", "port", "sharded_worker.py")] + [
        os.path.join(REPO, "scripts", name) for name in (
            "profile_torch_slice.py", "mutate_kernels.py",
            "ab_kernel_core.py", "rehearse_smoke_cpu.py")]
    for d, _, files in os.walk(os.path.join(REPO, "palace_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    """(module name, line) of every import in the file, at any depth."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, node.lineno
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Name)
                    and node.func.id == "__import__")
                   or (isinstance(node.func, ast.Attribute)
                       and node.func.attr == "import_module"))):
            yield node.args[0].value, node.lineno


def test_port_sources_import_no_jax_package():
    found = [f"{os.path.relpath(path, REPO)}:{line} imports {mod}"
             for path in _sources()
             for mod, line in _imported_modules(path)
             if mod.split(".")[0] in REFUSED]
    assert len(_sources()) > 60
    assert not found, "\n".join(found)


#: Calls that load a module from a file path: what they load is not among
#: the scanned sources, so the scan could not see a JAX import there.
FILE_LOADERS = ("spec_from_file_location", "SourceFileLoader", "run_path",
                "exec_module")


def test_port_sources_load_no_file_past_the_scan():
    found = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else \
                    getattr(fn, "id", None)
                if name in FILE_LOADERS:
                    found.append(f"{os.path.relpath(path, REPO)}:"
                                 f"{node.lineno} calls {name}")
    assert not found, "\n".join(found)


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX-OK" in proc.stdout
