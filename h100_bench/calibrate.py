"""Readings that the limits of ``correct`` are set from, for one cell,
on several seeds in one process (the benchmark's own runs do not run
this):

  * the program's: the cell's run with a short window, its compared
    numbers judged against the plain reference as in every run;
  * the control's: the reference computed in scaled fp8, one precision
    below the configuration's bf16, put in the program's place and
    judged the same way;
  * with ``--plant FILE``, the program's with a fault planted first
    (the file's ``install()``, as ``tests/faults/*.py``), in its own
    process, since a fault stays in the program once installed.

    python3 h100_bench/calibrate.py --workload CELL --seeds 1,2,3
        [--seconds 3] [--control 1] [--program 1] [--plant FILE]
        [--out FILE]

Each reading is printed as one JSON line, with what the judge names
beside the numbers (the worst leaves, the windows), and appended to
``--out``.  Without a CUDA card it exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402
from harness import manifest  # noqa: E402


def readings(cell_name, seeds, seconds, program=True, control=True,
             device=None, root=None, out=None, plant=None):
    root = Path(root or os.getcwd())
    run.fixed_caches(root)
    man = manifest.Manifest(root)
    cell = man.cell(cell_name)
    import torch
    if device is None:
        device, why = run.chip_device(torch, cell.chips)
        if device is None:
            run.RunContext.say(f"no readings: {why}")
            return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = manifest.driver(cell.driver)
    if plant:
        import importlib.util
        spec = importlib.util.spec_from_file_location("plant", plant)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.install()
    rows = []
    n_control = (cell.params.get("check_steps") or
                 cell.params.get("check_samples"))
    for seed in seeds:
        for kind in (("program",) if program else ()) + \
                (("control",) if control else ()):
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="h100_bench_") as tmp:
                ctx = run.RunContext(cell, seed, seconds, False,
                                     torch.device(device), Path(tmp))
                if kind == "program":
                    got = driver.run(ctx)
                    numbers, detail = got["numbers"], got.get("detail", {})
                else:
                    numbers, detail = driver.control(ctx, int(n_control))
            if plant and kind == "program":
                kind = "fault:" + Path(plant).stem
            row = {"cell": cell_name, "kind": kind, "seed": seed,
                   "numbers": numbers, "detail": detail,
                   "seconds": round(time.perf_counter() - t0, 1)}
            rows.append(row)
            print(json.dumps(row), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--program", type=int, default=1)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--plant", default="")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if a.plant and a.control:
        p.error("--plant plants a fault in the program: give --control 0")
    rows = readings(a.workload, [int(s) for s in a.seeds.split(",")],
                    a.seconds, bool(a.program), bool(a.control),
                    out=a.out or None, plant=a.plant or None)
    return 2 if rows is None else 0


if __name__ == "__main__":
    sys.exit(main())
