"""The import guard compares whole top-level names, and a run's modules
hold neither JAX nor the JAX package."""

import subprocess
import sys

from harness.importcheck import forbidden_modules
from tests_support import BENCH_DIR, REPO_DIR


def test_guard_names():
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client",
                              "flax.linen", "palace_tpu",
                              "palace_tpu.fem.nd"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "palace_tpu",
        "palace_tpu.fem.nd"]
    assert forbidden_modules(["palace_torch", "palace_torch.fem",
                              "palace_tpux", "jaxtyping", "numpy"]) == []


def test_harness_loads_no_jax():
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{BENCH_DIR!r}, {REPO_DIR!r}]\n"
        "import run\n"
        "from harness import cells, session, trace, counts, traffic\n"
        "from reference import check, control, driven, ndhex\n"
        "from palace_torch.drivers import driven as d\n"
        "from palace_torch.linalg import device_ksp\n"
        "from palace_torch.fem import estimators\n"
        "from palace_torch.models import spaceoperator, waveport\n"
        "b = cells.load_benchmark()\n"
        "[cells.metric_reader(m['name']) for m in b['end_to_end'] + "
        "b['per_layer']]\n"
        "from harness.importcheck import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
