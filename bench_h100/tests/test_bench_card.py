"""One short run of a cell on the card, as the benchmark's command runs it
(skipped without a CUDA card)."""

import json
import subprocess
import sys

import pytest

from tests_support import REPO_DIR


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.cuda
def test_card_run_correct(card):
    out = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", "cavity-p3.sweep",
         "--seed", str(2 ** 31 + 99), "--seconds", "1", "--trace", "0"],
        cwd=REPO_DIR, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
