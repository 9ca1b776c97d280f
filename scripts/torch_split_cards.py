"""The BEV stage split over cards, one rank a card over NCCL, against the
unsplit forward on one card: the latency that spatial (SP) and tensor
(TP) parallelism (``rslo_tpu_torch/parallel/``) buy or cost.

    python scripts/torch_split_cards.py        # needs 4 CUDA cards

Builds the port's kernels, then runs ``chip_smoke.py``'s phase 24a-d
with ``backend="nccl"`` and rank r on card r: the two-frame forward at
``configs/kitti_eval_ours.json`` (bf16) and its float32 twin, with the
smoke run's seeded weights and scans, split as SP over 2 cards, TP over
2, SP x TP over 2 x 2 and SP over 4; every map against the unsplit
forward on card 0, each rank's launches against that forward's, and ms
a forward per rank (host clock) beside the unsplit forward's ms.  Needs
no network and no JAX; exits non-zero when a check fails or fewer than
4 cards are present.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main():
    import numpy as np
    import torch
    smi = "; ".join(cs.require_card(torch).splitlines())
    if torch.cuda.device_count() < cs.SPLIT_RANKS:
        cs.fail(f"{cs.SPLIT_RANKS} cards needed, "
                f"{torch.cuda.device_count()} present")
    from rslo_tpu_torch.config.schema import PipelineCfg
    from rslo_tpu_torch.data.prepare import prepare_example, voxelizer_config
    from rslo_tpu_torch.ops import _build
    from rslo_tpu_torch.utils.synthetic import synth_sequence
    counted = cs.kernel_wrappers()

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counted.items()}

    cs.build_kernels(_build)
    with open(cs.CONFIG) as fh:
        cfg = PipelineCfg.from_json(fh.read())
    dev = torch.device("cuda", 0)
    frames, _ = synth_sequence(seed=cs.SEED, n_frames=2,
                               n_points=cs.N_POINTS)
    pair = torch.as_tensor(np.stack(frames), device=dev)
    example = prepare_example(
        pair, torch.ones(pair.shape[:2], dtype=torch.bool, device=dev),
        voxelizer_config(cfg), mean_mode=True)
    cs.split_forward_phases(
        cfg, example, reset_counts, counts, dev, smi, np, torch,
        backend="nccl",
        rank_devices=[f"cuda:{r}" for r in range(cs.SPLIT_RANKS)])
    cs.say(smi)


if __name__ == "__main__":
    main()
