"""Nothing the benchmark runs loads JAX or the JAX package, by each
module's whole top-level name; the reference loads nothing of the
program."""
import ast
import json
import subprocess
import sys

import tiny

BENCH = tiny.BENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "rslo_tpu", "bench"}

LOADER = """
import json, sys
sys.path.insert(0, {bench!r})
import run, calibrate
from harness import manifest, counts, judge, lower, peaks, scenes, trace
from harness import weights, record, guard
from harness.refpath import ref
ref()
man = manifest.Manifest({repo!r})
for w in man.data["workloads"]:
    cell = man.cell(w["name"])
    manifest.driver(cell.driver)
for m in man.metrics:
    manifest.reader(m.name)
import rslo_tpu_torch.eval.streaming, rslo_tpu_torch.train.loop
import rslo_tpu_torch.data.hdf5_store, rslo_tpu_torch.data.dataset
print(json.dumps(sorted(sys.modules)))
"""


def test_no_jax_in_the_process():
    code = LOADER.format(bench=str(BENCH), repo=str(tiny.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tiny.REPO),
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(tiny.REPO)})
    assert out.returncode == 0, out.stderr[-2000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in mods}
    assert not tops & FORBIDDEN
    assert "rslo_tpu_torch" in tops and "rslo_ref" in tops


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_no_forbidden_import_statement():
    for path in BENCH.rglob("*.py"):
        for top, level in _imports(path):
            if level == 0:
                assert top not in FORBIDDEN, (path, top)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        for top, level in _imports(path):
            if level == 0:
                assert top not in FORBIDDEN | {"rslo_tpu_torch"}, (path, top)


def test_guard_compares_whole_names():
    from harness import guard
    assert guard.forbidden_modules(["rslo_tpu_torch.models", "torch"]) == []
    assert guard.forbidden_modules(["rslo_tpu.models", "jax.numpy"]) == \
        ["jax", "rslo_tpu"]
