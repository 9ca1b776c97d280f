"""Imports the plain reference (``h100_bench/reference/rslo_ref``) by
its own top-level name, whatever the caller's ``sys.path``."""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

REFERENCE_DIR = Path(__file__).resolve().parents[1] / "reference"


def ref():
    """The reference package with its submodules loaded."""
    if str(REFERENCE_DIR) not in sys.path:
        sys.path.insert(0, str(REFERENCE_DIR))
    pkg = importlib.import_module("rslo_ref")
    for name in ("config.schema", "geometry.transforms", "models.net",
                 "models.middle", "models.bev_net", "models.vfe",
                 "train.step", "train.optim", "train.state", "ops.chamfer",
                 "ops.sparse_conv", "ops.dma_gather", "losses.objective",
                 "losses.consistency", "data.prepare", "data.window"):
        importlib.import_module(f"rslo_ref.{name}")
    return pkg
