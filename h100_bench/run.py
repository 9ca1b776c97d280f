"""Run one cell of the benchmark once and print its result.

    python3 h100_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``.  The cell's
files are found by name (``harness/manifest.py``); its traffic driver
sets the program up from the seed, warms it up, measures for
``--seconds`` and checks what the timed path produced against the plain
reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard
error).  Without a CUDA card holding the cell's chips it prints no
result and exits 2.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
if str(ROOT) not in sys.path:
    sys.path.insert(1, str(ROOT))

from harness import guard, manifest  # noqa: E402


class RunContext:
    """What a traffic driver gets: the cell, the run's arguments, the
    device, a scratch directory and the printer of earlier lines."""

    def __init__(self, cell, seed, seconds, trace, device, tmpdir):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.tmpdir = tmpdir
        self.t_start = T_START

    @staticmethod
    def say(msg: str):
        print(f"[h100_bench] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fixed_caches(root: Path):
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into ``build/rslo_tpu_torch``)."""
    cache = root / "build" / "h100_bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def chip_device(torch, chips: int):
    """The card, or None (and the reason) where the cell cannot run."""
    if not torch.cuda.is_available():
        return None, "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return None, (f"the cell asks for {chips} cards, "
                      f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0), ""


def result_metrics(man, cell, record, trace: bool):
    out = {}
    for m in man.cell_metrics(cell.name, end_to_end=not trace):
        value = manifest.reader(m.name).read(record)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def main(argv=None, *, device=None, root=None) -> int:
    """``device`` given (the tests' CPU runs) skips the look for a card."""
    args = parse(argv)
    root = Path(root or os.getcwd())
    fixed_caches(root)
    man = manifest.Manifest(root)
    cell = man.cell(args.workload)

    import rslo_tpu_torch  # noqa: F401  the system under test
    import torch
    if device is None:
        device, why = chip_device(torch, cell.chips)
        if device is None:
            RunContext.say(f"no result: {why}")
            return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    driver = manifest.driver(cell.driver)
    with tempfile.TemporaryDirectory(prefix="h100_bench_") as tmp:
        ctx = RunContext(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device(device), Path(tmp))
        out = driver.run(ctx)
    record, correct, rows = out["record"], out["correct"], out["checks"]

    found = guard.forbidden_modules()
    if found:
        RunContext.say(f"no result: this process loaded {found}")
        return 3
    dev = torch.device(device)
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]),
            "metrics": result_metrics(man, cell, record, bool(args.trace)),
            "device": device_info(torch, dev, record, bool(args.trace))}
    if args.trace and record.trace is not None:
        line["breakdown"] = record.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def device_info(torch, dev, record, trace: bool) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(record.peak_bytes)
    if trace and record.trace is not None:
        info["busy_s"] = record.trace.busy_s
        info["window_s"] = record.trace.window_s
    return info


if __name__ == "__main__":
    sys.exit(main())
