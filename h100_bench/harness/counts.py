"""Operations and bytes of the work a step or a scan needs, counted by
the benchmark from the configuration and the input points, on the
reference's modules: the same count whatever implements the work.

  * sparse convs: the valid (site, tap) pairs of each conv, from the
    reference's own geometry of the input, times 2 Cin Cout;
  * dense convs, deconvs and dense layers: from their shapes
    (``torch.utils.flop_counter.FlopCounterMode`` over the reference's
    forward, the sparse convs stubbed out of it);
  * the nearest-neighbour search: 9 operations a (valid src, valid tgt)
    pair;
  * bytes: each input of a kernel call read once, each output written
    once.

Training is counted as three forwards; a recompute is not counted.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import torch

NN_OPS_PER_PAIR = 9.0


@dataclasses.dataclass
class ConvCall:
    v_in: int
    v_out: int
    taps: int
    cin: int
    cout: int
    pairs: int
    first: bool          # the frame's first conv: no feature gradient

    def flops(self) -> float:
        return 2.0 * self.pairs * self.cin * self.cout

    def fwd_bytes(self) -> float:
        """features f32, rulebook idx int32 + valid bool, weights f32,
        bias, out_mask, the f32 output."""
        return (self.v_in * self.cin * 4 + self.v_out * self.taps * 5 +
                self.taps * self.cin * self.cout * 4 + self.cout * 4 +
                self.v_out + self.v_out * self.cout * 4)

    def dgrad_bytes(self) -> float:
        """the f32 cotangent, the transposed rulebook, the weights, the
        f32 feature gradient."""
        return (self.v_out * self.cout * 4 + self.v_in * self.taps * 5 +
                self.taps * self.cin * self.cout * 4 +
                self.v_in * self.cin * 4)


@dataclasses.dataclass
class Counts:
    model_flops: float = 0.0         # a step or a scan
    conv_calls: List[ConvCall] = dataclasses.field(default_factory=list)
    nn_calls: List[tuple] = dataclasses.field(default_factory=list)
    train: bool = False
    per: int = 1                     # steps or scans the calls cover

    def gather_gemm_bound_s(self, peaks) -> float:
        """The least time of the gather-GEMM calls (forward, and in
        training each conv's feature gradient but the first's)."""
        t = 0.0
        for c in self.conv_calls:
            t += peaks.bound_s(c.fwd_bytes(), c.flops(), "bf16")
            if self.train and not c.first:
                t += peaks.bound_s(c.dgrad_bytes(), c.flops(), "bf16")
        return t

    def nn_search_bound_s(self, peaks) -> float:
        """(pairs of points, bytes) a call: f32 operations."""
        return sum(peaks.bound_s(b, NN_OPS_PER_PAIR * n, "f32")
                   for n, b in self.nn_calls)


@contextlib.contextmanager
def _stubbed_sparse_convs(ref, calls: List[ConvCall]):
    """Each reference SpConv records its call and returns zeros: the
    dense part's shapes do not depend on the sparse features."""
    SpConv = ref.models.middle.SpConv
    orig = SpConv.forward
    state = {"n": 0}

    def stub(self, feats, op, out_mask=None):
        taps, cin, cout = self.kernel.shape
        calls.append(ConvCall(
            v_in=int(feats.shape[0]), v_out=int(op.rb.idx.shape[0]),
            taps=int(taps), cin=int(cin), cout=int(cout),
            pairs=int(op.rb.valid.sum()), first=state["n"] == 0))
        state["n"] += 1
        return torch.zeros((op.rb.idx.shape[0], cout), device=feats.device)

    def frame_start():
        state["n"] = 0

    SpConv.forward = stub
    try:
        yield frame_start
    finally:
        SpConv.forward = orig


@contextlib.contextmanager
def _recorded_searches(ref, calls: list):
    mod = ref.losses.consistency
    orig = mod.nn_search

    def rec(src, src_mask, tgt, tgt_mask):
        pairs = float((src_mask.sum(1).double() *
                       tgt_mask.sum(1).double()).sum())
        n_bytes = (src.numel() * 4 + src_mask.numel() + tgt.numel() * 4 +
                   tgt_mask.numel() + src_mask.numel() * 8)
        calls.append((pairs, float(n_bytes)))
        return orig(src, src_mask, tgt, tgt_mask)

    mod.nn_search = rec
    try:
        yield
    finally:
        mod.nn_search = orig


def _frame_features(ref, net, cfg, pts, mask, with_cov, frame_start):
    prep = ref.data.prepare
    ex = prep.prepare_example(pts[None], mask[None],
                              prep.voxelizer_config(cfg),
                              mean_mode=prep.mean_vfe_ok(cfg))
    frame_start()
    return net.frame_features(ex["voxel_features"][0], ex["coords"][0],
                              ex["voxel_mask"][0], with_cov=with_cov)


@torch.no_grad()
def stream_counts(ref, net, cfg, pts, mask) -> Counts:
    """One scan of the stream: its frame through the middle without the
    covariance decoder, and one pair through the BEV net and vote."""
    from torch.utils.flop_counter import FlopCounterMode
    out = Counts(train=False)
    net.eval()
    with _stubbed_sparse_convs(ref, out.conv_calls) as frame_start, \
            FlopCounterMode(display=False) as fc:
        bev, _ = _frame_features(ref, net, cfg, pts, mask, False,
                                 frame_start)
        net.pair_predict(bev, bev)
    out.model_flops = float(fc.get_total_flops()) + sum(
        c.flops() for c in out.conv_calls)
    return out


@torch.no_grad()
def train_counts(ref, net, state_alphas, cfg, batch) -> Counts:
    """One train step on ``batch``: the forward of every frame with the
    covariance decoder and every pair, counted three times (forward and
    backward); the objective's searches."""
    from torch.utils.flop_counter import FlopCounterMode
    out = Counts(train=True)
    net.train()
    step = ref.train.step
    calls: List[ConvCall] = []
    with _stubbed_sparse_convs(ref, calls) as frame_start, \
            FlopCounterMode(display=False) as fc:
        example = step.prepare_batch(batch, cfg)
        orig_ff = type(net).frame_features

        def ff(self, *a, **kw):
            frame_start()
            return orig_ff(self, *a, **kw)

        type(net).frame_features = ff
        try:
            preds = net(example)
        finally:
            type(net).frame_features = orig_ff
    dense = float(fc.get_total_flops())
    out.conv_calls = calls
    out.model_flops = 3.0 * (dense + sum(c.flops() for c in calls))
    with _recorded_searches(ref, out.nn_calls):
        ref.losses.objective.compute_objective(
            preds, example, state_alphas, cfg.loss,
            cfg.voxelizer.point_cloud_range, warmup=False,
            self_supervised=True)
    return out


def mean_counts(items: List[Counts]) -> Counts:
    """The average step of several (model operations averaged; the
    calls of all, their bounds then divided by the count)."""
    out = Counts(train=items[0].train)
    out.model_flops = sum(c.model_flops for c in items) / len(items)
    for c in items:
        out.conv_calls += c.conv_calls
        out.nn_calls += c.nn_calls
    out.per = len(items)
    return out


@torch.no_grad()
def level_sites(ref, cfg, pts, mask) -> List[tuple]:
    """(level, sites, capacity) of one frame: the voxels the voxelizer
    finds against its ``max_voxels``, and each level's sites at ample
    capacities against the shipped ones."""
    prep = ref.data.prepare
    vcfg = prep.voxelizer_config(cfg)
    vs = torch.as_tensor(vcfg.voxel_size, device=pts.device)
    lo = torch.as_tensor(vcfg.point_cloud_range[:3], device=pts.device)
    hi = torch.as_tensor(vcfg.point_cloud_range[3:], device=pts.device)
    p = pts[mask][:, :3]
    p = p[torch.all((p >= lo) & (p < hi), dim=1)]
    n_vox = int(torch.unique(torch.floor((p - lo) / vs).long(),
                             dim=0).shape[0])
    rows = [("L0 voxels", n_vox, vcfg.max_voxels)]
    if cfg.middle.name != "SparseMiddleCov":
        return rows
    ex = prep.prepare_example(pts[None], mask[None], vcfg,
                              mean_mode=prep.mean_vfe_ok(cfg))
    nx, ny, nz = ref.config.schema.grid_size(cfg.voxelizer)
    ample = [8 * c for c in cfg.middle.level_capacities]
    geo = ref.models.middle.build_geometry(
        ex["coords"][0], ex["voxel_mask"][0], (nz + 1, ny, nx), ample,
        inverse=False)
    caps = list(cfg.middle.level_capacities) + \
        [cfg.middle.level_capacities[-1]]
    for i, lv in enumerate(geo.levels[1:], start=1):
        rows.append((f"L{i}", int(lv.mask.sum()), caps[i]))
    return rows


def report_sites(say, rows):
    """Print each level's sites against its capacity: what the shipped
    capacities drop of this traffic."""
    for lvl, sites, cap in rows:
        say(f"sites {lvl}: {sites} against a capacity of {cap}"
            + (f" (dropped {sites - cap})" if sites > cap else ""))
