"""Parallel axes beyond data parallelism (counterpart of
``rslo_tpu/parallel/``): spatial partitioning of the dense BEV stage
(``spatial``) and its tensor parallelism (``tensor``), over the
"space" and "model" axes of a ``utils/mesh_axis.py::GridMesh``.
Sharded window refinement and sharded BA live in
:mod:`rslo_tpu_torch.pgo`.
"""
from .spatial import bev_constraint, make_spatial_forward  # noqa: F401
