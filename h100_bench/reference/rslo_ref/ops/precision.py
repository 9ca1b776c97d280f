"""Matrix-product and convolution precision policy shared by the sparse
convs and the refinement solvers."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_matmul():
    """Full-f32 matrix products (no TF32), as JAX's HIGHEST."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def f32_conv():
    """Full-f32 cuDNN convolutions (no TF32), as JAX's f32 convs."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved
