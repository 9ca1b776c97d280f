"""The port's spans and counters (rslo_tpu_torch/utils/timing.py): off
by default and then recording nothing; under ``tracing()`` the layers'
ranges nest inside a tiny CPU train step and a streamed scan, the
results stay bit-identical, the site counters match a numpy count of
what each capacity drops, and ``profile_trace`` writes the span names
into its trace."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_port_helpers import port_cfg, tiny_scans, to_port

from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
from rslo_tpu_torch.eval.streaming import StreamingOdometry
from rslo_tpu_torch.models.middle import DOWN_SPECS, build_geometry
from rslo_tpu_torch.models.net import OdomNet
from rslo_tpu_torch.ops import voxelize as vx
from rslo_tpu_torch.train.loop import make_optimizer
from rslo_tpu_torch.train.state import TrainState
from rslo_tpu_torch.train.step import train_step
from rslo_tpu_torch.utils import timing

L = 3
TRAIN_SPANS = {"train.step", "prepare", "geometry", "middle", "bev_net",
               "objective", "backward", "optimizer"}
STREAM_SPANS = {"stream.push", "h2d", "prepare", "geometry", "middle",
                "bev_net", "pose"}


def _cfg():
    return to_port(port_cfg("f32"))


def _state(cfg):
    net = OdomNet(cfg, torch.Generator().manual_seed(0)).train()
    opt = make_optimizer(cfg, net)
    return TrainState.create(net, opt, {"rot": -2.5, "trans": 0.0}), opt


def _batch():
    scans = tiny_scans(5, L)
    odom = np.zeros((L * (L - 1) // 2, 7), np.float32)
    odom[:, 3] = 1.0
    odom[:, 0] = 0.05
    return {"points": torch.from_numpy(np.stack(scans)),
            "point_mask": torch.ones((L, len(scans[0])), dtype=torch.bool),
            "odometry": torch.from_numpy(odom)}


def _step(cfg):
    state, opt = _state(cfg)
    state, _ = train_step(state, _batch(), cfg, opt, warmup=False)
    return state


def _ranges(prof):
    """(name, thread, start_ns, end_ns) of every user range recorded on
    the host."""
    return [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _inside(inner, outer):
    return (inner[1] == outer[1] and outer[2] <= inner[2]
            and inner[3] <= outer[3])


def test_tracing_is_off_by_default_and_records_nothing():
    cfg = _cfg()
    assert not timing.tracing_on()
    assert timing.span("prepare") is timing.span("middle")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(cfg)
    names = {n for n, *_ in _ranges(prof)}
    assert not names & (TRAIN_SPANS | STREAM_SPANS), names
    assert timing.read_counters() == {}
    x = torch.ones(3)
    assert timing.block_until_ready({"x": [x, (x,)]})["x"][0] is x


def test_tracing_switch_restores_what_it_found():
    with timing.tracing():
        assert timing.tracing_on()
        with timing.tracing(False):
            assert not timing.tracing_on()
            timing.count("c", 1)
        assert timing.tracing_on()
        timing.count("c", torch.tensor(2))
        timing.count("c", 3)
    assert not timing.tracing_on()
    assert timing.read_counters() == {"c": 5}
    assert timing.read_counters() == {}


def test_train_step_spans_nest_under_the_step():
    cfg = _cfg()
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            timing.tracing():
        _step(cfg)
    timing.read_counters()
    ranges = [r for r in _ranges(prof) if r[0] in TRAIN_SPANS]
    steps = [r for r in ranges if r[0] == "train.step"]
    assert len(steps) == 1
    names = [r[0] for r in ranges if r is not steps[0]]
    assert set(names) == TRAIN_SPANS - {"train.step"}
    assert all(_inside(r, steps[0]) for r in ranges)
    # one voxelizer call for the window, a geometry and a middle a frame
    assert names.count("prepare") == 1
    assert names.count("geometry") == L and names.count("middle") == L
    for r in ranges:
        if r[0] == "geometry":
            assert not any(_inside(r, m) for m in ranges
                           if m[0] == "middle")


def test_stream_push_spans_nest_under_the_push():
    cfg = _cfg()
    net = OdomNet(cfg, torch.Generator().manual_seed(0))
    stream = StreamingOdometry(net, cfg, "cpu")
    scans = tiny_scans(3, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            timing.tracing():
        for s in scans:
            stream.push(s)
    timing.read_counters()
    ranges = [r for r in _ranges(prof) if r[0] in STREAM_SPANS]
    pushes = [r for r in ranges if r[0] == "stream.push"]
    assert len(pushes) == 2
    for k, push in enumerate(pushes):
        kids = [r[0] for r in ranges if r is not push and _inside(r, push)]
        # the first scan only fills the cache: no pair, no pose
        want = STREAM_SPANS - {"stream.push"}
        assert set(kids) == (want if k else want - {"bev_net", "pose"})


def test_tracing_changes_no_result():
    cfg = _cfg()
    off = _step(cfg)
    with timing.tracing():
        on = _step(cfg)
    timing.read_counters()
    for (k, a), b in zip(off.trainable().items(), on.trainable().values()):
        assert torch.equal(a, b), k
    for (k, a), b in zip(off.model.state_dict().items(),
                         on.model.state_dict().values()):
        assert torch.equal(a, b), k

    scans = tiny_scans(3, 3)
    poses = []
    for on in (False, True):
        net = OdomNet(cfg, torch.Generator().manual_seed(1))
        stream = StreamingOdometry(net, cfg, "cpu")
        with timing.tracing(on):
            poses.append([stream.push(s) for s in scans])
    timing.read_counters()
    np.testing.assert_array_equal(np.stack(poses[0]), np.stack(poses[1]))


def _np_down(coords, shape, kernel, stride, padding):
    """The out sites (linear ids) of a strided conv over the in sites
    ``coords`` (zyx): o with s * o + d - p = c for some tap d."""
    shape = np.asarray(shape)
    k, s, p = (np.asarray(a) for a in (kernel, stride, padding))
    out_shape = (shape + 2 * p - k) // s + 1
    ids = set()
    for d in np.ndindex(*k):
        num = coords + p - np.asarray(d)
        o = num // s
        ok = np.all((num % s == 0) & (o >= 0) & (o < out_shape), axis=1)
        for z, y, x in o[ok]:
            ids.add((z * out_shape[1] + y) * out_shape[2] + x)
    return len(ids), tuple(int(v) for v in out_shape)


def _capped_cfg(capped=True):
    """The tiny config with capacities the tiny scan overflows at every
    level, or with ones it fills at none."""
    cfg = _cfg()
    vox, caps = (1500, (1500, 900, 250, 60)) if capped else \
        (4096, (4096, 12288, 8448, 1536))
    return cfg.replace(
        voxelizer=dataclasses.replace(cfg.voxelizer, max_voxels=vox),
        middle=dataclasses.replace(cfg.middle, level_capacities=caps))


@pytest.mark.parametrize("capped", [True, False])
def test_site_counters_count_what_each_capacity_drops(capped):
    cfg = _capped_cfg(capped)
    pts = torch.from_numpy(tiny_scans(4, 1)[0])
    mask = torch.ones(len(pts), dtype=torch.bool)
    vcfg = voxelizer_config(cfg)
    net = OdomNet(cfg)
    with timing.tracing():
        ex = prepare_example(pts[None], mask[None], vcfg, mean_mode=True)
        geo = build_geometry(ex["coords"][0], ex["voxel_mask"][0],
                             net.sparse_shape, cfg.middle.level_capacities,
                             inverse=False)
    got = timing.read_counters()

    lo = np.asarray(vcfg.point_cloud_range[:3], np.float32)
    vs = np.asarray(vcfg.voxel_size, np.float32)
    cells = np.floor((pts.numpy()[:, :3] - lo) / vs).astype(np.int64)
    inb = np.all((cells >= 0) & (cells < vcfg.grid_size), axis=1)
    want = {"L0": (len(np.unique(cells[inb], axis=0)), vcfg.max_voxels)}
    caps = cfg.middle.level_capacities
    for i in range(3):
        lv = geo.levels[i]
        kept = lv.coords[lv.mask].numpy().astype(np.int64)
        n, shape = _np_down(kept, lv.shape, *DOWN_SPECS[i])
        assert shape == geo.levels[i + 1].shape
        want[f"L{i + 1}"] = (n, caps[i + 1])
    for lvl, (found, cap) in want.items():
        # every capacity binds, or none does
        assert (found > cap) == capped, (lvl, found, cap)
        assert got[f"sites_found.{lvl}"] == found, lvl
        assert got[f"sites_kept.{lvl}"] == min(found, cap), lvl
    for i in range(1, 4):
        assert int(geo.levels[i].mask.sum()) == got[f"sites_kept.L{i}"]
    assert set(got) == {f"sites_{k}.L{i}" for k in ("found", "kept")
                        for i in range(4)}


@pytest.mark.parametrize("capped", [True, False])
@pytest.mark.parametrize("voxelizer", ["voxelize", "voxelize_sorted_mean"])
def test_voxelizer_counts_its_occupied_cells(voxelizer, capped):
    vcfg = voxelizer_config(_capped_cfg(capped))
    pts = torch.from_numpy(tiny_scans(6, 1)[0])
    mask = torch.ones(len(pts), dtype=torch.bool)
    mask[::7] = False
    with timing.tracing():
        out = getattr(vx, voxelizer)(pts, mask, vcfg)
    got = timing.read_counters()
    lo = np.asarray(vcfg.point_cloud_range[:3], np.float32)
    vs = np.asarray(vcfg.voxel_size, np.float32)
    cells = np.floor((pts.numpy()[:, :3] - lo) / vs).astype(np.int64)
    ok = np.all((cells >= 0) & (cells < vcfg.grid_size), axis=1)
    found = len(np.unique(cells[ok & mask.numpy()], axis=0))
    assert (found > vcfg.max_voxels) == capped
    kept = min(found, vcfg.max_voxels)
    assert got == {"sites_found.L0": found, "sites_kept.L0": kept}
    assert int(out.num_voxels) == kept


def test_profile_trace_carries_the_span_names(tmp_path):
    cfg = _cfg()
    net = OdomNet(cfg, torch.Generator().manual_seed(0))
    stream = StreamingOdometry(net, cfg, "cpu")
    scans = tiny_scans(3, 2)
    with timing.profile_trace(str(tmp_path)):
        assert timing.tracing_on()
        for s in scans:
            stream.push(s)
    assert not timing.tracing_on()
    timing.read_counters()
    files = list(Path(tmp_path).glob("*.pt.trace.json"))
    assert len(files) == 1, files
    names = {e.get("name") for e in
             json.loads(files[0].read_text())["traceEvents"]}
    assert STREAM_SPANS <= names, STREAM_SPANS - names


def test_profile_trace_keeps_no_counters(tmp_path):
    cfg = _capped_cfg()
    vcfg = voxelizer_config(cfg)
    pts = torch.from_numpy(tiny_scans(6, 1)[0])
    mask = torch.ones(len(pts), dtype=torch.bool)
    with timing.profile_trace(str(tmp_path / "alone")):
        vx.voxelize(pts, mask, vcfg)
    assert timing.read_counters() == {}
    # under a reader's own tracing the counters stay for it to read
    with timing.tracing():
        with timing.profile_trace(str(tmp_path / "inside")):
            vx.voxelize(pts, mask, vcfg)
        got = timing.read_counters()
    assert got["sites_kept.L0"] == vcfg.max_voxels
