"""Port the chamfer NN search (rslo_tpu_torch.ops.chamfer) against the
JAX package's Pallas kernel ``nn_search_pallas`` run in interpret mode,
as tests/test_chamfer.py runs it, and against a numpy argmin, with ties
(lowest index wins), an all-invalid tgt, masked src rows, shapes that
are not tile multiples (the JAX side pads them to its tiles), and the
cases that the CUDA kernel's design rests on: tied copies that straddle
its 32-tgt chunks and its cluster's tgt shares, an invalid tgt (staged
there as +inf) on the same spot as a valid one, fewer tgts than the
cluster has blocks, and coordinates whose squares exceed BIG or
overflow.

Indices are bit-equal to both.  Distances are bit-equal to numpy's
evaluation of the contract, ((dx*dx + dy*dy) + dz*dz) + penalty, with
every operation rounded on its own, which is what the port's kernel
computes too.  XLA's CPU backend, which runs the interpret-mode
kernel, contracts that sum into fma(dz, dz, fma(dx, dx, dy*dy)), so its
distances may differ from the contract's by an ulp: they are held to
2 ulps here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import tt

from rslo_tpu.ops.chamfer import nn_search_pallas
from rslo_tpu_torch.ops.chamfer import BIG, nn_search, nn_search_plain

TILE = 64


def pallas(src, sm, tgt, tm):
    """Interpret-mode Pallas, padded to its tiles (padding tgt rows are
    invalid, padding src rows are cut off)."""
    N, M = len(src), len(tgt)
    pn, pm = (-N) % TILE, (-M) % TILE
    d, i = nn_search_pallas(
        jnp.asarray(np.pad(src, ((0, pn), (0, 0)))),
        jnp.asarray(np.pad(sm, (0, pn))),
        jnp.asarray(np.pad(tgt, ((0, pm), (0, 0)))),
        jnp.asarray(np.pad(tm, (0, pm))),
        src_tile=TILE, tgt_tile=TILE, interpret=True)
    return np.asarray(d)[:N], np.asarray(i)[:N]


def numpy_nn(src, sm, tgt, tm):
    """The contract in numpy f32: ((dx*dx + dy*dy) + dz*dz) + penalty,
    first index at the minimum, (BIG, 0) for masked src or no valid
    tgt."""
    diff = src[:, None, :] - tgt[None]
    with np.errstate(over="ignore"):       # squares past f32's range
        d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
        d = d + diff[..., 2] * diff[..., 2]
    d = d + np.where(tm, np.float32(0), np.float32(BIG))[None]
    d = np.minimum(d, np.float32(BIG)) if d.size else \
        np.full((len(src), 1), np.float32(BIG))
    i = np.argmin(d, axis=1).astype(np.int32)
    best = np.take_along_axis(d, i[:, None].astype(np.int64), 1)[:, 0]
    none = best >= np.float32(BIG)
    best = np.where(sm & ~none, best, np.float32(BIG))
    i = np.where(sm & ~none, i, 0)
    return np.maximum(best, 0).astype(np.float32), i.astype(np.int32)


def _case(name, rng):
    N, M = {"ragged": (333, 517), "square": (256, 256),
            "dup_chunks": (300, 700), "few_tgt": (100, 5)}.get(name,
                                                               (200, 150))
    src = (rng.normal(size=(N, 3)) * 4).astype(np.float32)
    tgt = (rng.normal(size=(M, 3)) * 4).astype(np.float32)
    sm = rng.random(N) < 0.9
    tm = rng.random(M) < 0.9
    if name == "ties":
        # duplicated tgt rows and src points on tgt points: several tgt
        # at exactly the same distance, so the lowest index must win
        tgt[M // 2:] = tgt[:M - M // 2]
        tm[:] = True
        src[:50] = tgt[rng.integers(0, M, 50)]
        src[50:80] = (tgt[10] + tgt[20]) / 2
    elif name == "all_invalid_tgt":
        tm[:] = False
    elif name == "masked_src":
        sm[::3] = False
    elif name == "dup_chunks":
        # every tgt point repeated each 97 rows, so its copies straddle
        # every 32-tgt chunk and every cluster share (96 tgts here) of
        # the kernel; src points on tgt points tie ~7 copies at 0
        tgt[:] = tgt[np.arange(M) % 97]
        tm[:] = True
        src[:100] = tgt[rng.integers(0, 97, 100)]
    elif name == "invalid_on_valid":
        # tgt 2k (invalid) and 2k+1 (valid) on one spot, src k there:
        # the valid one wins; src 50-79 sit on invalid tgts 100-129
        tm[:] = True
        tgt[1:100:2] = tgt[0:100:2]
        tm[0:100:2] = False
        src[:50] = tgt[0:100:2]
        tm[100:130] = False
        src[50:80] = tgt[100:130]
        sm[:80] = True
    elif name == "large":
        # squares near BIG (1e28-1e29), past it (src 0-19: every distance
        # >= BIG, so (BIG, 0)) and past f32's range (tgt 0-9: +inf)
        src *= np.float32(2.5e13)
        tgt *= np.float32(2.5e13)
        src[:20] = np.float32(3e15)
        tgt[:10] = np.float32(1e20)
        sm[:20] = True
    return src, sm, tgt, tm


CASES = ["ragged", "square", "ties", "all_invalid_tgt", "masked_src",
         "dup_chunks", "invalid_on_valid", "large", "few_tgt"]


@pytest.mark.parametrize("name", CASES)
def test_nn_search_matches_pallas_and_numpy(name):
    rng = np.random.default_rng(CASES.index(name))
    src, sm, tgt, tm = _case(name, rng)
    d, i = nn_search(tt(src[None]), tt(sm[None]), tt(tgt[None]),
                     tt(tm[None]))
    d, i = d[0], i[0]
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    rd, ri = pallas(src, sm, tgt, tm)
    nd, ni = numpy_nn(src, sm, tgt, tm)
    np.testing.assert_array_equal(i.numpy(), ri, "idx vs Pallas")
    np.testing.assert_array_max_ulp(d.numpy(), rd, maxulp=2)
    np.testing.assert_array_equal(i.numpy(), ni, "idx vs numpy")
    np.testing.assert_array_equal(d.numpy(), nd, "dist vs numpy")
    if name == "all_invalid_tgt":
        assert (d.numpy() == np.float32(BIG)).all() and (i.numpy() == 0).all()
    if name == "masked_src":
        assert (d.numpy()[~sm] == np.float32(BIG)).all()
        assert (i.numpy()[~sm] == 0).all()
    if name in ("ties", "dup_chunks"):
        assert (d.numpy()[:50][sm[:50]] == 0).all()
    if name == "dup_chunks":                     # the first copy wins
        assert (i.numpy()[:100][sm[:100]] < 97).all()
    if name == "invalid_on_valid":
        np.testing.assert_array_equal(i.numpy()[:50],
                                      np.arange(1, 100, 2))
        assert (d.numpy()[:50] == 0).all() and (d.numpy()[50:80] > 0).all()
    if name == "large":
        assert (d.numpy()[:20] == np.float32(BIG)).all()
        assert (i.numpy()[:20] == 0).all()
        assert (d.numpy()[20:][sm[20:]] < np.float32(BIG)).all()


def test_pair_batch_and_chunking():
    """The pair axis is one call: each pair's result equals its own
    search; the plain version's tgt chunking does not change it."""
    rng = np.random.default_rng(9)
    P, N, M = 3, 300, 700
    src = (rng.normal(size=(P, N, 3)) * 3).astype(np.float32)
    tgt = (rng.normal(size=(P, M, 3)) * 3).astype(np.float32)
    tgt[:, 400:] = tgt[:, :300]                  # ties across chunks
    sm = rng.random((P, N)) < 0.95
    tm = np.ones((P, M), bool)
    tm[1] = False                                # one pair with no tgt
    d, i = nn_search(tt(src), tt(sm), tt(tgt), tt(tm))
    assert d.shape == i.shape == (P, N)
    for p in range(P):
        dp, ip = nn_search(tt(src[p:p + 1]), tt(sm[p:p + 1]),
                           tt(tgt[p:p + 1]), tt(tm[p:p + 1]))
        np.testing.assert_array_equal(d[p].numpy(), dp[0].numpy())
        np.testing.assert_array_equal(i[p].numpy(), ip[0].numpy())
        nd, ni = numpy_nn(src[p], sm[p], tgt[p], tm[p])
        np.testing.assert_array_equal(i[p].numpy(), ni)
        np.testing.assert_array_equal(d[p].numpy(), nd)
    dc, ic = nn_search_plain(tt(src), tt(sm), tt(tgt), tt(tm), chunk=128)
    np.testing.assert_array_equal(dc.numpy(), d.numpy())
    np.testing.assert_array_equal(ic.numpy(), i.numpy())


def test_nn_search_rejects_bad_operands():
    x = torch.zeros(1, 4, 3)
    m = torch.ones(1, 4, dtype=torch.bool)
    with pytest.raises(ValueError):
        nn_search(x, m.float(), x, m)
    with pytest.raises(ValueError):
        nn_search(torch.zeros(1, 4, 2), m, x, m)
    with pytest.raises(ValueError):
        nn_search(x[0], m[0], x[0], m[0])
