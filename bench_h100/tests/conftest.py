"""The benchmark's own tests: `python -m pytest bench_h100/tests -q` from
the root of the repo (CPU, about a minute); the card test runs where
CUDA sees a card and skips elsewhere."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, REPO_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA; skipped without one")
