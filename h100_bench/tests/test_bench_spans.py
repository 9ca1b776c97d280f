"""The stretch of the program's own spans (``harness/spans.py``): the
attribution of device activities to spans on a hand-built event list,
the new metrics' entries and readers, a program without the tracing
switch reading nothing, and each stretch run at the tiny size on the
CPU (spans and counters recorded, no device time)."""
import json
from pathlib import Path

import pytest

import tiny
from harness import manifest as mf
from harness import spans
from harness.record import Record

E = spans.Event
MS = 1_000_000                 # ns


def _events():
    """Two steps on thread 1: train.step holding prepare (a kernel of
    2 ms), backward (whose 3 ms kernel the worker thread 2 launches)
    and, after the step, a kernel launched outside any span; the card's
    annotation ranges of each span, which must not count."""
    ev = []
    corr = [100]

    def kernel(name, tid, t_launch, t0, t1):
        corr[0] += 1
        ev.append(E("cudaLaunchKernel", False, False, tid, corr[0],
                    t_launch, t_launch + 10))
        ev.append(E(name, True, False, tid, corr[0], t0, t1))

    for k in range(2):
        o = k * 100 * MS
        ev.append(E("train.step", False, True, 1, 1, o, o + 50 * MS))
        ev.append(E("prepare", False, True, 1, 2, o + 1 * MS, o + 11 * MS))
        ev.append(E("aten::add", False, False, 1, 3, o + 2 * MS, o + 3 * MS))
        kernel("add_kernel", 1, o + 2 * MS, o + 4 * MS, o + 6 * MS)
        ev.append(E("backward", False, True, 1, 4, o + 20 * MS, o + 40 * MS))
        kernel("mm_kernel", 2, o + 21 * MS, o + 25 * MS, o + 28 * MS)
        kernel("late_kernel", 1, o + 60 * MS, o + 61 * MS, o + 62 * MS)
        # the card's annotation ranges: device type, user annotation
        ev.append(E("prepare", True, True, 1, 2, o + 4 * MS, o + 6 * MS))
        ev.append(E("train.step", True, True, 1, 1, o + 4 * MS, o + 28 * MS))
    return ev


def test_attribution_of_a_hand_built_trace():
    s = spans.attribute(_events(), 2)
    lay = s.layers
    assert set(lay) == {"train.step", "prepare", "backward"}
    assert lay["prepare"]["device_ms"] == pytest.approx(2.0)
    assert lay["prepare"]["activities"] == 1
    assert lay["prepare"]["calls"] == 1 and lay["train.step"]["calls"] == 1
    assert s.top["prepare"] == [("add_kernel", pytest.approx(2.0))]
    assert s.top[spans.UNATTRIBUTED] == [("late_kernel", pytest.approx(1.0))]
    # launched on the worker thread, inside backward on the main one
    assert lay["backward"]["device_ms"] == pytest.approx(3.0)
    assert lay["train.step"]["device_ms"] == 0.0
    assert s.unattributed_ms == pytest.approx(1.0)
    # the sum of every activity's time, annotations left out
    assert s.device_ms == pytest.approx(6.0)
    assert sum(v["device_ms"] for v in lay.values()) + s.unattributed_ms \
        == pytest.approx(s.device_ms)
    # self time: the step's 50 ms less prepare's 10 and backward's 20
    assert lay["train.step"]["host_self_ms"] == pytest.approx(20.0)
    assert lay["prepare"]["host_self_ms"] == pytest.approx(10.0)
    assert lay["backward"]["host_self_ms"] == pytest.approx(20.0)
    # idle: the card runs 4-6 ms inside prepare, 25-28 inside backward
    assert lay["prepare"]["idle_ms"] == pytest.approx(8.0)
    assert lay["backward"]["idle_ms"] == pytest.approx(17.0)
    assert lay["train.step"]["idle_ms"] == pytest.approx(20.0)


def test_innermost_prefers_the_launching_thread():
    import numpy as np
    st = np.array([0, 10, 10, 5], np.int64)
    en = np.array([100, 50, 20, 30], np.int64)
    th = np.array([1, 1, 1, 2], np.int64)
    got = spans._innermost(np.array([15, 15, 40, 200, 25]),
                           np.array([1, 2, 1, 1, 3]), st, en, th)
    # the shorter of two ranges that start together; thread 2's own
    # range; the outer range; nothing; another thread's innermost by time
    assert got.tolist() == [2, 3, 1, -1, 1]


def test_sites_dropped_share():
    s = spans.SpanSummary(1, {}, 0.0, 0.0, {
        "sites_found.L0": 300, "sites_kept.L0": 200,
        "sites_found.L1": 100, "sites_kept.L1": 100})
    assert s.sites_dropped_pct() == pytest.approx(25.0)
    assert spans.SpanSummary(1, {}, 0.0, 0.0, {}).sites_dropped_pct() is None
    assert any("found 300, kept 200" in line for line in s.lines())


NEW = [f"device_ms.{lv}.train" for lv in
       ("h2d", "prepare", "geometry", "middle", "bev_net", "objective",
        "backward", "optimizer")] + \
    [f"device_ms.{lv}.stream" for lv in
     ("h2d", "prepare", "geometry", "middle", "bev_net")] + \
    ["sites_dropped_pct.train", "sites_dropped_pct.stream"]


def test_the_new_metrics_and_their_readers():
    man = mf.Manifest(tiny.REPO)
    b = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in b["per_layer"]}
    assert [m["name"] for m in b["per_layer"][-len(NEW):]] == NEW
    for name in NEW:
        m = per_layer[name]
        kind = name.rsplit(".", 1)[1]
        assert m["source"] == ("program_counter" if "sites" in name
                               else "program_span")
        assert m["moves"] == ("device_ms_per_step" if kind == "train"
                              else "device_ms_per_scan")
        for cell in m["workloads"]:
            assert m["moves"] in {x.name for x in
                                  man.cell_metrics(cell, True)}
        pillar = [c for c in m["workloads"] if c.startswith("pillar")]
        assert bool(pillar) == ("geometry" not in name)
        # a record of a run not started as a traced run reads nothing
        assert mf.reader(name).read(Record(kind=kind)) is None


def test_a_program_without_the_switch_reads_nothing(monkeypatch, capsys):
    from rslo_tpu_torch.utils import timing
    args = spans.run_args(["--workload", "sparse-stream", "--seed", "3",
                           "--trace", "1"])
    monkeypatch.setattr(spans, "run_args", lambda: args)
    monkeypatch.delattr(timing, "tracing")
    rec = Record(kind="stream")
    assert spans.device_ms(rec, "stream", "middle") is None
    assert spans.sites_dropped_pct(rec, "stream") is None
    assert "no tracing switch" in capsys.readouterr().err


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("spans"))


def _on_the_cpu(monkeypatch, root, kind):
    """A traced run of the first cell of ``kind`` at the tiny root, its
    stretch taken on the CPU."""
    import torch
    cell = {"train": "sparse-train", "stream": "pillar-stream"}[kind]
    args = spans.run_args(["--workload", cell, "--seed", "5",
                           "--trace", "1"])
    monkeypatch.setattr(spans, "run_args", lambda: args)
    monkeypatch.setattr(spans, "_card", lambda t: torch.device("cpu"))
    monkeypatch.chdir(root)
    return Record(kind=kind)


def test_a_stretch_that_fails_fails_the_run(monkeypatch, root, capsys):
    rec = _on_the_cpu(monkeypatch, root, "stream")

    def broken(ctx, kind, timing):
        raise MemoryError("out of memory on the second set-up")

    monkeypatch.setattr(spans, "stretch", broken)
    with pytest.raises(MemoryError):
        spans.device_ms(rec, "stream", "middle")
    assert "the stretch failed" in capsys.readouterr().err


def test_a_stretch_that_loads_jax_fails_the_run(monkeypatch, root):
    import sys
    import types
    rec = _on_the_cpu(monkeypatch, root, "stream")
    real = spans.stretch

    def loads_jax(ctx, kind, timing):
        out = real(ctx, kind, timing)
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return out

    monkeypatch.setattr(spans, "stretch", loads_jax)
    with pytest.raises(RuntimeError, match="jax"):
        spans.sites_dropped_pct(rec, "stream")


@pytest.mark.parametrize("cell", ["sparse-train", "pillar-stream"])
def test_a_stretch_on_the_cpu(root, cell, tmp_path):
    import torch
    from types import SimpleNamespace
    from rslo_tpu_torch.utils import timing
    c = mf.Manifest(root).cell(cell)
    ctx = SimpleNamespace(cell=c, seed=2 ** 31 + 9, trace=True,
                          device=torch.device("cpu"), tmpdir=Path(tmp_path),
                          say=spans.say)
    s = spans.stretch(ctx, "train" if "train" in cell else "stream", timing)
    assert not timing.tracing_on()
    want = ({"data.wait", "h2d", "train.step", "prepare", "geometry",
             "middle", "bev_net", "objective", "backward", "optimizer"}
            if "train" in cell else
            {"stream.push", "h2d", "prepare", "middle", "bev_net", "pose"})
    assert set(s.layers) == want
    assert s.device_ms == 0.0                # no card, no device activity
    assert all(v["host_self_ms"] > 0 for v in s.layers.values())
    levels = {k.split(".")[1] for k in s.counters}
    assert levels == ({"L0", "L1", "L2", "L3"} if "sparse" in cell
                      else {"L0"})
    for lv in levels:
        assert 0 < s.counters[f"sites_kept.{lv}"] <= \
            s.counters[f"sites_found.{lv}"]
    assert s.sites_dropped_pct() is not None
