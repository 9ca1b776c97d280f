"""The port's mean-shift clustering (rslo_tpu_torch/geometry/
meanshift.py) against the JAX package's on the same seeded points: the
Euclidean and cosine forms, with and without confidences.  Modes to
MODE_TOL (f32 products, TF32 off, in another summation order than XLA's
CPU dot: observed <= 3.4e-6), labels bit for bit; and the JAX tests'
behaviour (blobs collapse to their centres)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rslo_tpu.geometry import meanshift as jms
from rslo_tpu_torch.geometry.meanshift import (label_modes, mean_shift,
                                               mean_shift_cluster)

MODE_TOL = dict(rtol=1e-4, atol=1e-5)


def _blobs(seed, centers, n=60, std=0.2):
    rng = np.random.default_rng(seed)
    return np.concatenate([c + std * rng.normal(size=(n, len(c)))
                           for c in centers]).astype(np.float32)


CASES = {
    "euclidean": dict(pts=_blobs(0, np.array([[0.0, 0.0, 0.0],
                                              [5.0, 0.0, 0.0],
                                              [0.0, 6.0, 0.0]])),
                      conf=None, kw=dict(bandwidth=1.0, iters=20), tol=0.5),
    "euclidean_conf": dict(pts=_blobs(1, np.array([[0.0, 0.0],
                                                   [2.0, 0.0]]), n=50,
                                      std=0.1),
                           conf=np.concatenate([np.ones(50), np.zeros(50)]),
                           kw=dict(bandwidth=3.0, iters=30), tol=0.5),
    "cosine": dict(pts=np.stack([[1, 0, 0], [0.99, 0.05, 0], [0, 1, 0],
                                 [0.03, 0.99, 0]]).astype(np.float32),
                   conf=None, kw=dict(bandwidth=0.2, iters=15,
                                      dist_type="cosine"), tol=0.3),
    "cosine_conf": dict(pts=_blobs(2, np.array([[1.0, 0.2, 0.0],
                                                [0.1, 1.0, 0.3]]), n=30,
                                   std=0.05),
                        conf=np.random.default_rng(3).uniform(0.2, 1.0, 60),
                        kw=dict(bandwidth=0.3, iters=10,
                                dist_type="cosine"), tol=0.3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_mean_shift_matches_jax(name):
    c = CASES[name]
    conf = None if c["conf"] is None else c["conf"].astype(np.float32)
    jm = jms.mean_shift(jnp.asarray(c["pts"]),
                        None if conf is None else jnp.asarray(conf),
                        **c["kw"])
    m = mean_shift(torch.tensor(c["pts"]),
                   None if conf is None else torch.tensor(conf), **c["kw"])
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **MODE_TOL)
    labels = label_modes(m, c["tol"])
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(),
                                  np.asarray(jms.label_modes(jm, c["tol"])))


def test_blobs_collapse_to_their_centres():
    centers = np.array([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0], [0.0, 6.0, 0.0]])
    modes, labels = mean_shift_cluster(torch.tensor(_blobs(4, centers)),
                                       bandwidth=1.0, iters=20, tol=0.5)
    modes, labels = modes.numpy(), labels.numpy()
    assert len(np.unique(labels)) == 3
    for k, c in enumerate(centers):
        grp = modes[labels == labels[k * 60]]
        assert len(grp) == 60
        np.testing.assert_allclose(grp.mean(0), c, atol=0.15)
