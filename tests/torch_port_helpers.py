"""Shared helpers for the parity tests of the PyTorch port
(tests/test_torch_*.py): the same seeded numpy inputs and the same
weights go through the JAX package and its port.

Weights: the JAX module's own ``init`` (jitted) makes the tree, numpy
perturbs every leaf (BN running statistics included, so no BN is the
identity), and ``rslo_tpu_torch.convert`` carries it into the port.
Configs: the JAX package's config goes to the JAX side and its
``to_port`` copy (the port's own schema) to the port.
"""
import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rslo_tpu_torch.config import schema as port_schema

sys.path.insert(0, "tests")
from test_model import tiny_cfg  # noqa: E402

torch.set_num_threads(1)


def to_port(jax_cfg):
    """The port's PipelineCfg with the same values as a JAX one."""
    return port_schema.PipelineCfg.from_json(jax_cfg.to_json())


def interpreted_pallas(monkeypatch):
    """Force pallas_call into interpret mode (no TPU here), as
    tests/test_band_conv.py does."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)


def port_cfg(precision: str, middle_bn: str = "none"):
    """The tiny test config of tests/test_model.py.  precision "f32"
    pins both the sparse convs and the BEV net to float32; "bf16" keeps
    the deployed bf16 compute."""
    cfg = tiny_cfg()
    middle = dataclasses.replace(
        cfg.middle, bn_type=middle_bn,
        conv_dtype="f32" if precision == "f32" else "bf16")
    odom = dataclasses.replace(
        cfg.odom, compute_dtype="fp32" if precision == "f32" else "bf16")
    return cfg.replace(middle=middle, odom=odom)


def tiny_scans(seed: int, L: int, n: int = 4000):
    """L (n, 7) float32 scans inside the tiny config's range: the same
    base cloud shifted a little per frame, fresh z/intensity/normals."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-6, 6, size=(n, 2)).astype(np.float32)
    scans = []
    for t in range(L):
        xy = base + t * 0.05
        z = rng.uniform(-0.7, 0.7, size=(n, 1)).astype(np.float32)
        inten = rng.uniform(0, 1, size=(n, 1)).astype(np.float32)
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        scans.append(np.concatenate([xy, z, inten, nrm], axis=1))
    return scans


def _perturb(path, leaf, rng):
    name = path[-1]
    a = np.asarray(leaf, np.float32)
    if name == "var":
        return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
    if name == "scale":
        return a * rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
    if name in ("mean", "bias"):
        return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
    return a * (1 + rng.normal(0, 0.1, a.shape)).astype(np.float32)


def jax_variables(module, seed: int, *args, **kwargs):
    """``module.init`` under jit, then every leaf perturbed with numpy;
    returned as nested dicts of numpy arrays."""
    init = jax.jit(lambda key, *a: module.init(key, *a, **kwargs))
    variables = init(jax.random.PRNGKey(seed), *args)
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        return {k: (walk(v, path + (k,)) if hasattr(v, "items")
                    else _perturb(path + (k,), v, rng))
                for k, v in tree.items()}
    return walk(variables)


def to_jax(variables):
    return jax.tree.map(jnp.asarray, variables)


def tt(x, dtype=None):
    """numpy/JAX array -> CPU torch tensor."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def assert_same(got, want, path="out"):
    """Nested dicts, lists, tuples, arrays and scalars: equal types and
    keys, values bit-equal with NaN equal to NaN."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want), (path, type(got), type(want))
        np.testing.assert_array_equal(got, want, err_msg=path)


def jax_native_normals():
    """Load the JAX package's native normals library, which it builds
    into native/libprep.so on first use.  Test processes running side
    by side may race on that build, and the loser's load fails once; a
    failed load is retried after the winner has published the
    library."""
    from rslo_tpu.data import normals as jnormals
    for _ in range(5):
        if jnormals._load_native():
            return jnormals._NATIVE
        jnormals._NATIVE = None
        time.sleep(2)
    raise AssertionError("the JAX package's native normals did not load")
