"""The manifest (``BENCHMARK.json`` at the checkout's root) and the files
it names, found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``traffic/<driver>.py`` and
``metrics/<metric>.py`` under ``h100_bench/``.  Adding a configuration,
a cell or a metric adds files and entries; nothing here changes."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    workloads: Any = None      # list of cell names, or None
    moves: str = ""
    layer: str = ""
    bound: Any = None


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    driver: str
    params: Dict[str, Any]
    limits: Dict[str, float]
    pipeline: Dict[str, Any]       # the configuration as the program reads it
    config_file: Dict[str, Any]    # the whole file (with source, reduced, ...)


class Manifest:
    def __init__(self, root):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        self.data = json.loads(path.read_text())
        self.metrics = (
            [_metric(m, True) for m in self.data["end_to_end"]] +
            [_metric(m, False) for m in self.data["per_layer"]])

    def cell(self, name: str) -> Cell:
        entries = [w for w in self.data["workloads"] if w["name"] == name]
        if len(entries) != 1:
            raise KeyError(f"BENCHMARK.json has no cell {name!r}")
        w = entries[0]
        spec = json.loads((BENCH_DIR / "workloads" /
                           f"{name}.json").read_text())
        if (spec["config"], spec["traffic"]) != (w["config"], w["traffic"]):
            raise ValueError(
                f"workloads/{name}.json names ({spec['config']}, "
                f"{spec['traffic']}), BENCHMARK.json ({w['config']}, "
                f"{w['traffic']})")
        cfg_entry = [c for c in self.data["configs"]
                     if c["name"] == w["config"]]
        if len(cfg_entry) != 1:
            raise KeyError(f"BENCHMARK.json has no config {w['config']!r}")
        config_file = json.loads((self.root / cfg_entry[0]["file"])
                                 .read_text())
        return Cell(name=name, config_name=w["config"],
                    traffic=w["traffic"], chips=int(w["chips"]),
                    driver=spec["driver"], params=spec.get("params", {}),
                    limits=spec.get("limits", {}),
                    pipeline=config_file["pipeline"],
                    config_file=config_file)

    def cell_metrics(self, cell: str, end_to_end: bool) -> List[Metric]:
        """The metrics a cell reports: end-to-end ones without a
        ``workloads`` key in every cell, per-layer ones without it in
        every cell that reports the end-to-end metric they move."""
        e2e = [m for m in self.metrics if m.end_to_end and
               (m.workloads is None or cell in m.workloads)]
        if end_to_end:
            return e2e
        names = {m.name for m in e2e}
        return [m for m in self.metrics if not m.end_to_end and
                (cell in m.workloads if m.workloads is not None
                 else m.moves in names)]


def _metric(m: dict, end_to_end: bool) -> Metric:
    return Metric(name=m["name"], unit=m["unit"], better=m["better"],
                  source=m["source"], end_to_end=end_to_end,
                  workloads=m.get("workloads"), moves=m.get("moves", ""),
                  layer=m.get("layer", ""), bound=m.get("bound"))


def load_file_module(path: Path, name: str):
    """A module from its file, whatever characters its name holds."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return load_file_module(BENCH_DIR / "traffic" / f"{name}.py",
                            f"h100_bench_traffic_{name}")


def reader(metric: str):
    """``metrics/<metric>.py``; its ``read(record)`` returns the value,
    or None when the run holds nothing for it to read."""
    return load_file_module(BENCH_DIR / "metrics" / f"{metric}.py",
                            "h100_bench_metric_" +
                            metric.replace(".", "_").replace("-", "_"))
