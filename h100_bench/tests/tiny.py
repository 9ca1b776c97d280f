"""A copy of the benchmark at a size the CPU runs in seconds: the
harness copied into a temporary checkout root with its manifest, each
configuration's pipeline cut to the tiny model and each cell's traffic
to a few thousand points, and one cell run there through ``run.main``
in a fresh interpreter, on the CPU (the program from this repository)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent


def tiny_pipeline(pipe: dict) -> dict:
    p = json.loads(json.dumps(pipe))
    p["voxelizer"].update(point_cloud_range=[-12.8, -12.8, -3.0, 12.8, 12.8,
                                             1.0],
                          voxel_size=[0.2, 0.2, 0.1], max_voxels=2048)
    p["middle"].update(level_capacities=[2048, 2048, 1024, 512],
                       channels=[8, 8, 16, 16])
    p["odom"].update(num_input_features=32, layer_nums=[1, 1, 1],
                     num_filters=[16, 16, 32], num_upsample_filters=[16, 16,
                                                                     16])
    p["loss"].update(max_loss_points=2048)
    p["data"].update(max_points=8192, num_workers=1)
    return p


TINY_TRAFFIC = {"n_points": 8000, "extent": 14.0, "n_scans": 6,
                "check_samples": 4, "trace_steps": 1, "trace_scans": 2}


def make_root(tmp: Path, limits=None) -> Path:
    """``tmp`` as a checkout root holding the tiny benchmark; ``limits``
    {cell: {number: limit}} replaces each cell's limits."""
    tmp = Path(tmp)
    shutil.copytree(BENCH, tmp / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for f in (tmp / "h100_bench" / "configs").glob("*.json"):
        d = json.loads(f.read_text())
        d["pipeline"] = tiny_pipeline(d["pipeline"])
        f.write_text(json.dumps(d))
    for f in (tmp / "h100_bench" / "workloads").glob("*.json"):
        d = json.loads(f.read_text())
        d["params"].update({k: v for k, v in TINY_TRAFFIC.items()
                            if k in d["params"] or k == "extent"})
        if limits is not None and f.stem in limits:
            d["limits"] = limits[f.stem]
        f.write_text(json.dumps(d))
    return tmp


RUNNER = """
import json, sys
sys.path.insert(0, {bench!r})
import run
plant = {plant!r}
if plant:
    import importlib.util
    spec = importlib.util.spec_from_file_location("plant", plant)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.install()
sys.exit(run.main({argv!r}, device="cpu", root={root!r}))
"""


def run_cell(root: Path, cell: str, seed: int = 7, seconds: float = 1.0,
             trace: int = 0, plant: str = "", timeout: int = 600):
    """(returncode, the result line as a dict or None, stderr) of one
    CPU run of ``cell`` in the tiny checkout ``root``; ``plant`` names a
    file whose ``install()`` runs first (a fault planted in the
    program)."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    code = RUNNER.format(bench=str(Path(root) / "h100_bench"), plant=plant,
                         argv=argv, root=str(root))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, line, proc.stderr
