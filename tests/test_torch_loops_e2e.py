"""Loop closing on true revisits through the port's verbs (the twin of
tests/test_cli_loops_e2e.py, with the same world and sequence): a
looped raycast-world sequence rendered by the port's world, the store
built by the port's ``create_hdf5`` verb, then ``evaluate
--refine_loops --device cpu`` at the tiny config, which must detect a
loop from the scans themselves and give finite loop-closed metrics."""
import dataclasses
import json

import numpy as np

from torch_port_helpers import to_port
from test_model import tiny_cfg

from rslo_tpu_torch.cli import main
from rslo_tpu_torch.utils.world import write_kitti_tree


def test_cli_refine_loops(tmp_path):
    tree = tmp_path / "tree"
    # small world + slow closed circuit sized to the tiny pc range
    write_kitti_tree(
        tree, {0: (36, "loop", 3.0)}, world_seed=3,
        n_beams=16, n_azimuth=512,
        world_kwargs=dict(extent=10.0, n_walls=30, n_boxes=12,
                          n_cyl=14, corridor=2.5))
    h5 = tmp_path / "store.h5"
    main(["create_hdf5", "--kitti_root", str(tree), "--out", str(h5),
          "--sequences", "0"])

    cfg = to_port(tiny_cfg())
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, root=str(h5), val_sequences=(0,), num_workers=0,
        max_points=8192))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    mdir = tmp_path / "model"
    main(["evaluate", "--config", str(cfg_path), "--model_dir",
          str(mdir), "--refine_loops", "--loop_min_separation", "10",
          "--max_windows", "16", "--device", "cpu"])

    res = json.loads((mdir / "eval_results.json").read_text())
    seqs = [k for k in res if k.startswith("seq_")]
    assert seqs
    for k in seqs:
        assert res[k]["n_loops"] > 0, res[k]
        assert np.isfinite(res[k]["loop_closed"]["t_rel_pct"])
        assert np.isfinite(res[k]["chained"]["t_rel_pct"])
