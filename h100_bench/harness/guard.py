"""The check that nothing in this process loaded JAX or the JAX package:
each module's top-level name (before the first dot) compared whole, so
the program's ``rslo_tpu_torch`` is not the JAX package ``rslo_tpu``.
``bench`` is the JAX package's root bench script."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "rslo_tpu", "bench")


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
