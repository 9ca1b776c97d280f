"""The benchmark's own CPU tests (``python -m pytest h100_bench/tests``).
A test that needs the card carries the ``card`` marker and skips
without one, deciding so inside the test."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")
