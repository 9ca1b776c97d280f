"""What the port's accuracy probes (``scripts/torch_diag_*.py``) share:
a proxy model dir's latest checkpoint restored into a fresh
``OdomNet``, and the eval-mode forward of one collated window.

The JAX package's probes restore ``raw["params"]`` and
``raw["batch_stats"]`` and jit ``prepare_example`` + ``net.apply(...,
train=False)``; the port's checkpoint holds the module's state dict
under ``raw["model"]``, and the forward runs under
``torch.inference_mode`` without the covariance decoder (no probe reads
it, so JAX's compiler drops it as well).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch


def restore_net(cfg, model_dir, device):
    """(``OdomNet`` in eval mode on ``device`` holding the latest
    checkpoint under ``model_dir``, that checkpoint's step)."""
    from rslo_tpu_torch.models.net import OdomNet
    from rslo_tpu_torch.train.checkpoint import CheckpointManager
    raw = CheckpointManager.restore_raw_from(model_dir)
    net = OdomNet(cfg)
    net.load_state_dict(raw["model"])
    return net.to(device).eval(), int(raw.get("step", -1))


def forward(net, cfg, points, point_mask, device, mean_mode=False,
            keys=("odometry",)):
    """Eval-mode forward of one window (``points`` (L, N, F), float or
    transfer-quantized, and ``point_mask`` (L, N), numpy): the
    prediction's ``keys`` as float32 numpy arrays, in that order."""
    from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
    net.eval()
    with torch.inference_mode():
        ex = prepare_example(torch.as_tensor(points).to(device),
                             torch.as_tensor(point_mask).to(device),
                             voxelizer_config(cfg), mean_mode=mean_mode)
        out = net(ex, with_cov=False)
        return [out[k].float().cpu().numpy() for k in keys]


def add_device(parser):
    """The probes' ``--device``: the card unless ``cpu`` is asked for."""
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser

