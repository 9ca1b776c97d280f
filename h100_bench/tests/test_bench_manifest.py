"""The manifest keeps to the contract's shape, and every cell finds its
files by name; a cell added from files alone runs."""
import json
import re
import shutil
import subprocess
import sys

import tiny

REPO = tiny.REPO
BENCH = tiny.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def _line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_keys_names_units():
    b = manifest()
    assert set(b) == TOP_KEYS
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert all(PATH.match(p) for p in b["paths"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert c["file"].startswith(b["paths"][0] + "/")
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b).encode()) <= 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    sys.path.insert(0, str(BENCH))
    from harness import manifest as mf
    man = mf.Manifest(REPO)
    b = manifest()
    for w in b["workloads"]:
        e2e = {m.name for m in man.cell_metrics(w["name"], True)}
        layer = man.cell_metrics(w["name"], False)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m.moves in e2e, (w["name"], m.name)


def test_every_cell_finds_its_files_by_name():
    sys.path.insert(0, str(BENCH))
    from harness import manifest as mf
    man = mf.Manifest(REPO)
    b = manifest()
    for w in b["workloads"]:
        cell = man.cell(w["name"])
        assert cell.pipeline["voxelizer"] and cell.params
        assert hasattr(mf.driver(cell.driver), "run")
        assert hasattr(mf.driver(cell.driver), "control")
        for m in man.cell_metrics(w["name"], True) + \
                man.cell_metrics(w["name"], False):
            assert callable(mf.reader(m.name).read)
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert c["name"] in used
        d = json.loads((REPO / c["file"]).read_text())
        assert d["name"] == c["name"] and d["source"] == c["source"]
        assert d["reduced"] == c["reduced"]


def test_a_cell_added_from_files_alone_runs(tmp_path):
    """A new traffic mix (an open loop at 10 scans a second), a new cell
    and a new per-layer metric, each a new file or entry: nothing that
    is there changes, and the cell runs."""
    root = tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "h100_bench").rglob("*")
              if p.is_file()}
    spec = json.loads((root / "h100_bench/workloads/sparse-stream.json")
                      .read_text())
    spec["traffic"] = "stream-open"
    spec["params"]["rate_hz"] = 10
    (root / "h100_bench/workloads/sparse-stream-10hz.json").write_text(
        json.dumps(spec))
    (root / "h100_bench/metrics/late_ms.stream.py").write_text(
        "def read(rec):\n"
        "    return max(rec.latencies_ms) if rec.latencies_ms else None\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "sparse-stream-10hz",
                           "config": "rslo-sparse", "traffic": "stream-open",
                           "chips": 1, "why": "an open loop at the sensor's "
                           "10 Hz"})
    for m in b["end_to_end"]:
        if "workloads" in m and "sparse-stream" in m["workloads"]:
            m["workloads"].append("sparse-stream-10hz")
    b["per_layer"].append({"name": "late_ms.stream", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "host dispatch",
                           "moves": "device_ms_per_scan",
                           "workloads": ["sparse-stream-10hz"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    rc, line, err = tiny.run_cell(root, "sparse-stream-10hz", trace=1,
                                  seconds=1.0)
    assert rc == 0, err[-3000:]
    assert "late_ms.stream" in line["metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_no_result_without_the_program(tmp_path):
    """A directory that holds only the manifest and the benchmark's
    files cannot run: no result, and a code other than 0."""
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", "sparse-stream",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert not proc.stdout.strip()
