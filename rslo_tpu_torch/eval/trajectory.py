"""Trajectory plots (matplotlib, host-side; counterpart of
``rslo_tpu/eval/trajectory.py``): BEV KITTI trajectory figures, returned
as HWC uint8 arrays and saved to PNG.  matplotlib is imported inside the
functions, so the package imports without it.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def draw_trajectories(variants: dict, gt_abs: np.ndarray | None = None,
                      title: str = "", save_path: str | None = None
                      ) -> np.ndarray:
    """Multi-variant trajectory figure (chained/refined/loop_closed on
    one axis vs gt) — the committed-results plot for the refined eval."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6), dpi=120)
    colors = {"chained": "#888888", "refined": "tab:blue",
              "loop_closed": "tab:green", "ba_refined": "tab:purple"}
    for i, (name, p) in enumerate(variants.items()):
        ax.plot(p[:, 0], p[:, 1], lw=1.2, label=name,
                color=colors.get(name, f"C{i}"))
    if gt_abs is not None:
        ax.plot(gt_abs[:, 0], gt_abs[:, 1], "r--", lw=1.0, label="gt")
        ax.scatter([gt_abs[0, 0]], [gt_abs[0, 1]], c="k", marker="s",
                   s=20)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    if title:
        ax.set_title(title, fontsize=9)
    fig.tight_layout()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path)
    plt.close(fig)
    return buf


def draw_trajectory(pred_abs: np.ndarray, gt_abs: np.ndarray | None = None,
                    title: str = "", save_path: str | None = None
                    ) -> np.ndarray:
    """pred/gt: (N, 7) absolute tq poses in the LiDAR frame.  Plots the
    ground-plane track (x forward, y left -> plotted as x vs y)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6), dpi=120)
    ax.plot(pred_abs[:, 0], pred_abs[:, 1], "b-", lw=1.2, label="pred")
    if gt_abs is not None:
        ax.plot(gt_abs[:, 0], gt_abs[:, 1], "r--", lw=1.0, label="gt")
    ax.scatter([pred_abs[0, 0]], [pred_abs[0, 1]], c="k", marker="s",
               s=20, label="start")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    if title:
        ax.set_title(title, fontsize=9)
    fig.tight_layout()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path)
    plt.close(fig)
    return buf
