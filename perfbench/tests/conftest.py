"""The benchmark's own tests: `python -m pytest perfbench/tests`. Tests that
need the card are marked `cuda` and skip without one (decided inside the
test)."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")
