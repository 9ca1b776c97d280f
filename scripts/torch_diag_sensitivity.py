"""Probe the net's sensitivity to true inter-frame motion, on the PyTorch
port (the twin of ``scripts/diag_sensitivity.py``, which drives the JAX
package).

Takes one proxy window, artificially shifts the SECOND frame's points
by known offsets, and reports how the predicted translation responds.
A healthy pair-correlation path must track the shift ~1:1; an
input-insensitive head (collapse to prior) won't.

    python scripts/torch_diag_sensitivity.py [middle] [--supervised]
        [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given.  The proxy
transfers int16-quantized points (``data.quantize_transfer``); the
shift is applied in metres to the dequantized points (the JAX script
adds it to the int16 array, which numpy refuses).
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from torch_accuracy_proxy import base_cfg, _model_dir  # noqa: E402
from torch_diag_net import add_device, forward  # noqa: E402

SHIFTS = (-1.0, -0.5, 0.5, 1.0)


def main(middle: str, supervised: bool, device="cuda"):
    from rslo_tpu_torch.data.dataset import KittiWindowDataset
    from rslo_tpu_torch.data.loader import collate, quant_scale
    from rslo_tpu_torch.train.loop import Trainer

    cfg = base_cfg(middle, 100)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, seq_length=2))
    ds = KittiWindowDataset(cfg.data, "val", seq_length=2)
    trainer = Trainer(cfg, _model_dir(middle, supervised), device=device)

    b0 = collate([ds[5]], cfg.data)
    pts = np.asarray(b0["points"][0])          # (L, N, F)
    if not np.issubdtype(pts.dtype, np.floating):
        pts = pts.astype(np.float32) * quant_scale(pts.shape[-1])
    pm = np.asarray(b0["point_mask"][0])
    state = trainer.init_state()
    trainer.logger.close()
    print("restored step:", int(state.step), flush=True)
    net = state.model

    gt = np.asarray(b0["odometry"][0][0])
    (base,) = forward(net, cfg, pts, pm, device)
    base = base[0]
    print("gt  :", np.round(gt[:3], 3))
    print("pred:", np.round(base[:3], 3))
    rows = []
    for dx in SHIFTS:
        p2 = pts.copy()
        # shifting frame-1 points by -dx along x INCREASES the relative
        # motion frame0->frame1 by +dx (points are in sensor frame)
        p2[1, :, 0] += -dx
        (o,) = forward(net, cfg, p2, pm, device)
        o = o[0]
        rows.append(o)
        print(f"shift dx={dx:+.1f}: pred {np.round(o[:3], 3)} "
              f"(delta {np.round(o[:3] - base[:3], 3)})")
    return base, np.stack(rows)


def cli(argv=None):
    p = add_device(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    p.add_argument("middle", nargs="?", default="PillarMiddleCov")
    p.add_argument("--supervised", action="store_true")
    a = p.parse_args(argv)
    return main(a.middle, a.supervised, a.device)


if __name__ == "__main__":
    cli()
