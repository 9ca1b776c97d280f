"""The PyTorch port imports torch and never jax or flax."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import importlib, pkgutil, sys
import rslo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rslo_tpu_torch.__path__,
                                               "rslo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names), sorted(m for m in ("jax", "flax") if m in sys.modules))
"""


def test_port_modules_import_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CODE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.split(" ", 1)
    # every subpackage and module of the slice is walked
    assert int(n) >= 20, out.stdout
    assert leaked.strip() == "[]", out.stdout
