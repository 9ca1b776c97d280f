"""Port the training losses and the geometry they use (rslo_tpu_torch.
geometry, losses) against the JAX package: quaternion and Kabsch
helpers, tq-map encoding, the adaptive L2 losses and ``l2_loss``, the
consistency loss with and without covariances, and the whole objective
in warmup, post-warmup and supervised modes, on the hier clouds (f32 and
int16) and with the cross-normal supervision normals (loss, aux terms,
ICP correction and gradients), plus a torch twin of each
numerical-landmine test of the JAX suite.

On the CPU the JAX consistency loss would search with the XLA scan,
which expands the distance and can pick another point at near-ties; the
tests swap in the interpret-mode Pallas kernel (padded to its tiles),
whose semantics the port follows, so both sides associate the same
points."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import np_, port_cfg, to_port, tt

import rslo_tpu.losses.consistency as jcons
from rslo_tpu import geometry as jgeo
from rslo_tpu.data.loader import quantize_points
from rslo_tpu.losses import adaptive as jadaptive
from rslo_tpu.losses.adaptive import adaptive_weighted_l2 as jax_adaptive
from rslo_tpu.losses.objective import compute_objective as jax_objective
from rslo_tpu.ops.chamfer import nn_search_pallas
from rslo_tpu_torch import geometry as geo
from rslo_tpu_torch.losses import consistency as cons
from rslo_tpu_torch.losses import adaptive
from rslo_tpu_torch.losses.adaptive import adaptive_weighted_l2
from rslo_tpu_torch.losses.objective import (compute_objective,
                                             resize_nearest)

# f32 throughout; elementwise formulas agree to a few ulps
GEO_TOL = dict(rtol=1e-5, atol=1e-6)
# losses: sums over ~2000 points and 3x3 inverses in other orders
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# gradients through the Mahalanobis term and the pose warp: ~1e-4 of
# the largest entry of each input's gradient
GRAD_REL = 1e-4
L = 3


def pallas_nn_search(src, src_mask, tgt, tgt_mask, tile=256):
    """The Pallas NN kernel in interpret mode, padded to tile multiples
    (padding tgt rows are invalid; padding src rows are cut off)."""
    N, M = src.shape[0], tgt.shape[0]
    pn, pm = (-N) % tile, (-M) % tile
    d, i = nn_search_pallas(
        jnp.pad(src, ((0, pn), (0, 0))), jnp.pad(src_mask, (0, pn)),
        jnp.pad(tgt, ((0, pm), (0, 0))), jnp.pad(tgt_mask, (0, pm)),
        src_tile=tile, tgt_tile=tile, interpret=True)
    return d[:N], i[:N]


@pytest.fixture
def pallas_nn(monkeypatch):
    monkeypatch.setattr(jcons, "nn_search", pallas_nn_search)


def _quats(rng, n, scale=0.1):
    q = np.concatenate([np.ones((n, 1)), rng.normal(0, scale, (n, 3))], 1)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _check_grad(got, want, what):
    got, want = np_(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= GRAD_REL * scale, (what, err, scale)


# -- geometry ----------------------------------------------------------------

def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[:4] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    q[4] = [-0.0, 0.3, 0.1, 0.2]                # zero scalar part
    for fn, jfn, args in (
            (geo.quat_to_matrix, jgeo.quat_to_matrix, (q,)),
            (geo.hemisphere, jgeo.hemisphere, (q,))):
        np.testing.assert_allclose(
            np_(fn(*map(tt, args))), np.asarray(jfn(*map(jnp.asarray,
                                                         args))),
            err_msg=fn.__name__, **GEO_TOL)
    # matrix_to_quat on rotations of every pivot branch (angles near pi
    # about each axis pick the x, y and z extractions)
    rots = np.asarray(jgeo.quat_to_matrix(jnp.asarray(np.concatenate([
        q, [[0.01, 1, 0, 0], [0.01, 0, 1, 0], [0.01, 0, 0, 1]]]))))
    np.testing.assert_allclose(
        np_(geo.matrix_to_quat(tt(rots))),
        np.asarray(jgeo.matrix_to_quat(jnp.asarray(rots))), **GEO_TOL)


def test_weighted_kabsch_matches_jax():
    rng = np.random.default_rng(1)
    B, N = 4, 300
    tgt = rng.normal(0, 5, (B, N, 3)).astype(np.float32)
    R = np.asarray(jgeo.quat_to_matrix(jnp.asarray(_quats(rng, B, 0.3))))
    src = (np.einsum("bij,bnj->bni", R, tgt) +
           rng.normal(0, 0.5, (B, 1, 3)) +
           rng.normal(0, 0.01, (B, N, 3))).astype(np.float32)
    w = rng.uniform(0, 1, (B, N)).astype(np.float32)
    w[:, ::7] = 0.0                                  # padded rows
    w[3] = 0.0                                       # no weight at all
    Rp, tp = geo.weighted_kabsch(tt(src), tt(tgt), tt(w))
    Rj, tj = jgeo.weighted_kabsch(jnp.asarray(src), jnp.asarray(tgt),
                                  jnp.asarray(w))
    np.testing.assert_allclose(np_(Rp[:3]), np.asarray(Rj)[:3], atol=1e-5)
    np.testing.assert_allclose(np_(tp[:3]), np.asarray(tj)[:3], atol=1e-4)
    # all-zero weights: the eps in wsum keeps it finite, det(R) = +1
    assert np.isfinite(np_(Rp)).all() and np.isfinite(np_(tp)).all()
    np.testing.assert_allclose(np.linalg.det(np_(Rp)), 1.0, atol=1e-5)
    # a reflection-inducing cross covariance is flipped to a rotation
    mirror = tgt * np.array([1, 1, -1], np.float32)
    Rm, _ = geo.weighted_kabsch(tt(mirror), tt(tgt))
    Rmj, _ = jgeo.weighted_kabsch(jnp.asarray(mirror), jnp.asarray(tgt))
    np.testing.assert_allclose(np.linalg.det(np_(Rm)), 1.0, atol=1e-5)
    # the flipped axis is the least-determined singular vector, so f32
    # rounding moves it more than a well-posed rotation
    np.testing.assert_allclose(np_(Rm), np.asarray(Rmj), atol=1e-4)


@pytest.mark.parametrize("size,small", [((16, 16), [(4, 4), (8, 8)]),
                                        ((96, 176), [(24, 44), (48, 88)]),
                                        ((12, 20), [(3, 5), (6, 10)])])
def test_generate_tq_map_and_nearest_downscale_match_jax(size, small):
    rng = np.random.default_rng(2)
    pc_range = (-6.4, -6.4, -0.8, 6.4, 6.4, 0.8)
    tq = np.concatenate([rng.normal(0, 0.3, (3, 3)), _quats(rng, 3)],
                        1).astype(np.float32)
    got = geo.generate_tq_map(tt(tq), size, pc_range)
    ref = jgeo.generate_tq_map(jnp.asarray(tq), size, pc_range)
    np.testing.assert_allclose(np_(got), np.asarray(ref), **GEO_TOL)
    for hw in small:
        want = jax.image.resize(ref, (3,) + hw + (7,), method="nearest")
        np.testing.assert_array_equal(np_(resize_nearest(tt(np.asarray(
            ref)), hw)), np.asarray(want), str(hw))
    # torch's "nearest" would pick other cells: 8 -> 4 takes rows
    # 1, 3, 5, 7 in JAX and "nearest-exact", rows 0, 2, 4, 6 in "nearest"
    rows = np.arange(8, dtype=np.float32).reshape(1, 8, 1, 1)
    picked = np_(resize_nearest(tt(rows), (4, 1)))[0, :, 0, 0]
    np.testing.assert_array_equal(picked, [1, 3, 5, 7])


@pytest.mark.parametrize("masked,gamma", [(False, 0.0), (True, 0.0),
                                          (True, 2.0)])
def test_adaptive_weighted_l2_matches_jax(masked, gamma):
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
    tgt = rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
    mask = (rng.random((3, 8, 8, 1)) < 0.6).astype(np.float32) \
        if masked else None
    alpha = np.float32(-0.7)

    def port(p, a):
        return adaptive_weighted_l2(p, tt(tgt), a, None if mask is None
                                    else tt(mask), focal_gamma=gamma,
                                    weight=1.5)
    p_t = tt(pred).requires_grad_()
    a_t = torch.tensor(alpha, requires_grad=True)
    out = port(p_t, a_t)
    out.backward()
    ref, (gp, ga) = jax.value_and_grad(
        lambda p, a: jax_adaptive(p, jnp.asarray(tgt), a,
                                  None if mask is None else
                                  jnp.asarray(mask), focal_gamma=gamma,
                                  weight=1.5), argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(alpha))
    np.testing.assert_allclose(float(out), float(ref), **LOSS_TOL)
    _check_grad(p_t.grad, gp, "pred")
    np.testing.assert_allclose(float(a_t.grad), float(ga), **LOSS_TOL)


@pytest.mark.parametrize("form", ["quat", "matrix"])
@pytest.mark.parametrize("masked,gamma", [(False, 0.0), (True, 2.0)])
def test_adaptive_weighted_l2_rmatrix_matches_jax(form, masked, gamma):
    rng = np.random.default_rng(9)
    pred = _quats(rng, 24, 0.3).reshape(3, 8, 4)
    tgt = _quats(rng, 24, 0.3).reshape(3, 8, 4)
    if form == "matrix":
        pred, tgt = (np.asarray(jgeo.quat_to_matrix(jnp.asarray(q)))
                     .reshape(3, 8, 9) for q in (pred, tgt))
    mask = (rng.random((3, 8)) < 0.6).astype(np.float32) if masked \
        else None
    kw = dict(focal_gamma=gamma, weight=0.7)
    p_t = tt(pred).requires_grad_()
    a_t = torch.tensor(np.float32(0.4), requires_grad=True)
    out = adaptive.adaptive_weighted_l2_rmatrix(
        p_t, tt(tgt), a_t, None if mask is None else tt(mask), **kw)
    out.backward()
    ref, (gp, ga) = jax.jit(jax.value_and_grad(
        lambda p, a: jadaptive.adaptive_weighted_l2_rmatrix(
            p, jnp.asarray(tgt), a, None if mask is None else
            jnp.asarray(mask), **kw), argnums=(0, 1)))(
        jnp.asarray(pred), jnp.float32(0.4))
    np.testing.assert_allclose(float(out), float(ref), **LOSS_TOL)
    _check_grad(p_t.grad, gp, "pred")
    np.testing.assert_allclose(float(a_t.grad), float(ga), **LOSS_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_l2_loss_matches_jax(masked):
    rng = np.random.default_rng(10)
    pred = rng.normal(size=(4, 6, 3)).astype(np.float32)
    tgt = rng.normal(size=(4, 6, 3)).astype(np.float32)
    mask = (rng.random((4, 6, 1)) < 0.5).astype(np.float32) if masked \
        else None
    p_t = tt(pred).requires_grad_()
    out = adaptive.l2_loss(p_t, tt(tgt), None if mask is None else
                           tt(mask), weight=2.5)
    out.backward()
    ref, gp = jax.jit(jax.value_and_grad(lambda p: jadaptive.l2_loss(
        p, jnp.asarray(tgt), None if mask is None else jnp.asarray(mask),
        weight=2.5)))(jnp.asarray(pred))
    np.testing.assert_allclose(float(out), float(ref), **LOSS_TOL)
    _check_grad(p_t.grad, gp, "pred")


# -- consistency and the objective -------------------------------------------

def _cloud(rng, n, shift):
    """A cloud with duplicate-free points, normals and covariances; the
    second half of the points is a shifted copy plus noise."""
    pts = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    pts[:, 2] *= 0.1
    pts = pts + shift
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, nrm


def _preds(seed, n=600, P=3):
    """An OdomNet-shaped prediction dict for L = 3 frames of n voxels
    (feature rows xyz, intensity, normal) and three pyramid levels."""
    rng = np.random.default_rng(seed)
    base, _ = _cloud(rng, n, 0.0)
    feats, covs, masks = [], [], []
    for t in range(L):
        pts = base + rng.normal(0, 0.03, base.shape).astype(np.float32) + \
            np.float32(0.1 * t)
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        f = np.concatenate([pts, rng.uniform(0, 1, (n, 1)), nrm], 1)
        m = rng.random(n) < 0.9
        f[~m] = 0.0
        c = np.concatenate([rng.uniform(0.05, 0.5, (n, 3)),
                            rng.normal(size=(n, 4))], 1)
        c[~m] = 0.0                                   # padded covs
        feats.append(f.astype(np.float32))
        covs.append(c.astype(np.float32))
        masks.append(m)
    odom = np.concatenate([rng.normal(0, 0.1, (P, 3)), _quats(rng, P, 0.05)],
                          1).astype(np.float32)
    pyramid = []
    for hw in ((4, 4), (8, 8), (16, 16)):
        pm = rng.normal(0, 0.5, (P,) + hw + (7,)).astype(np.float32)
        mk = rng.uniform(0, 1, (P,) + hw + (2,)).astype(np.float32)
        pyramid.append((pm, mk))
    return {"odometry": odom, "pyramid": pyramid, "voxel_features": feats,
            "voxel_covs": covs, "voxel_masks": masks, "seq_length": L}


def _example(seed, P=3):
    rng = np.random.default_rng(seed + 100)
    gt = np.concatenate([rng.normal(0, 0.1, (P, 3)),
                         _quats(rng, P, 0.05)], 1).astype(np.float32)
    gt[0, 3:] *= -1                                  # q_w < 0: hemisphere
    return {"odometry": gt}


def _split(preds):
    """The differentiable leaves of a prediction dict: odometry, the
    pyramid maps and the covariances."""
    return (preds["odometry"], [p for p, _ in preds["pyramid"]],
            preds["voxel_covs"])


def _join(preds, odom, pmaps, covs):
    out = dict(preds)
    out["odometry"] = odom
    out["pyramid"] = [(pm, mk) for pm, (_, mk) in zip(pmaps,
                                                       preds["pyramid"])]
    out["voxel_covs"] = covs
    return out


def _hier(seed, quantized, n=700):
    """Offline hier clouds of L frames (xyz + unit normals) and their
    masks, f32 or int16 as the loader's transfer quantization ships
    them."""
    rng = np.random.default_rng(seed + 200)
    base, _ = _cloud(rng, n, 0.0)
    pts, masks = [], []
    for t in range(L):
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        p = base + rng.normal(0, 0.03, base.shape).astype(np.float32) + \
            np.float32(0.1 * t)
        pts.append(np.concatenate([p, nrm], 1))
        masks.append(np.arange(n) < n - 37 * t)        # ragged counts
    pts = np.stack(pts).astype(np.float32)
    return {"hier_points": quantize_points(pts) if quantized else pts,
            "hier_mask": np.stack(masks)}


@pytest.mark.parametrize("mode", ["warmup", "post_warmup", "supervised",
                                  "hier_f32", "hier_int16", "normal_gt"])
def test_objective_matches_jax(pallas_nn, mode):
    cfg = port_cfg("f32")
    loss_cfg = cfg.loss.__class__(**{
        **cfg.loss.__dict__, "max_loss_points": 256,
        "use_hier_points": mode.startswith("hier")})
    pc_range = cfg.voxelizer.point_cloud_range
    preds = _preds(4)
    example = _example(4)
    if mode.startswith("hier"):
        example.update(_hier(4, mode == "hier_int16"))
        assert example["hier_points"].dtype == (
            np.int16 if mode == "hier_int16" else np.float32)
    if mode == "normal_gt":
        rng = np.random.default_rng(44)
        preds["normal_gt"] = [
            (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(
                np.float32) for g in rng.normal(size=(L, 600, 3))]
    warmup = mode == "warmup"
    selfsup = mode != "supervised"
    alphas = {"rot": np.float32(-2.5), "trans": np.float32(0.3)}

    def jax_fn(leaves, a):
        jp = {k: v if k == "seq_length" else jax.tree.map(jnp.asarray, v)
              for k, v in preds.items()}
        out = jax_objective(_join(jp, *leaves), jax.tree.map(
            jnp.asarray, example), a, loss_cfg, pc_range, warmup=warmup,
            self_supervised=selfsup)
        return out.total, out.aux
    (ref, ref_aux), (jgrads, jga) = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, _split(preds)),
        jax.tree.map(jnp.asarray, alphas))

    leaves = jax.tree.map(lambda a: tt(a).requires_grad_(), _split(preds))
    tp = jax.tree.map(lambda a: tt(a) if isinstance(a, np.ndarray) else a,
                      preds)
    ta = {k: torch.tensor(v, requires_grad=True) for k, v in alphas.items()}
    out = compute_objective(_join(tp, *leaves), {k: tt(v) for k, v in
                                                 example.items()},
                            ta, to_port(cfg.replace(loss=loss_cfg)).loss,
                            pc_range, warmup=warmup,
                            self_supervised=selfsup)
    out.total.backward()
    np.testing.assert_allclose(float(out.total), float(ref), **LOSS_TOL)
    assert set(out.aux) == set(ref_aux)
    for k, v in ref_aux.items():
        np.testing.assert_allclose(float(out.aux[k]), float(v), err_msg=k,
                                   **LOSS_TOL)
    for got, want, what in zip(jax.tree.leaves(leaves),
                               jax.tree.leaves(jgrads),
                               ["odometry", "pyr0", "pyr1", "pyr2",
                                "cov0", "cov1", "cov2"]):
        if not what.startswith("cov"):
            _check_grad(got.grad, want, f"{mode} d{what}")
        elif selfsup:
            # the hier-cloud consistency takes no covariances: JAX's
            # gradient is zero where the port's never reaches them
            grad = torch.zeros_like(got) if got.grad is None else got.grad
            assert (got.grad is None) == mode.startswith("hier"), what
            _check_grad(grad, want, f"{mode} d{what}")
    for k in alphas:
        np.testing.assert_allclose(float(ta[k].grad), float(jga[k]),
                                   err_msg=k, **LOSS_TOL)
    if mode == "warmup":     # identity R: no consistency grad to odom
        assert float(ref_aux["consistency_loss"]) > 0
    if mode.startswith("hier"):
        assert not np.abs(np.asarray(jgrads[2][0])).any()


@pytest.mark.parametrize("icp_iter", [1, 3])
def test_consistency_pairs_match_jax(pallas_nn, icp_iter):
    """Loss, ICP correction (res_R, res_t) and gradients of the pair
    batch, with a predicted rotation."""
    preds = _preds(6, n=500)
    rng = np.random.default_rng(6)
    P = 3
    src = np.stack([preds["voxel_features"][i][:, :3] for i in (0, 0, 1)])
    nrm = np.stack([preds["voxel_features"][i][:, 4:7] for i in (0, 0, 1)])
    tgt = np.stack([preds["voxel_features"][j][:, :3] for j in (1, 2, 2)])
    sm = np.stack([preds["voxel_masks"][i] for i in (0, 0, 1)])
    tm = np.stack([preds["voxel_masks"][j] for j in (1, 2, 2)])
    cs = np.stack([preds["voxel_covs"][i] for i in (0, 0, 1)])
    ct = np.stack([preds["voxel_covs"][j] for j in (1, 2, 2)])
    R = np.asarray(jgeo.quat_to_matrix(jnp.asarray(_quats(rng, P, 0.05))))
    kw = dict(penalize_ratio=0.97, reg_weight=0.005, icp_iter=icp_iter)

    def jax_fn(cs, ct, tgt):
        return jcons.consistency_loss_pairs(
            jnp.asarray(src), jnp.asarray(sm), jnp.asarray(nrm), cs,
            tgt, jnp.asarray(tm), ct, jnp.asarray(R),
            jnp.zeros((P, 3)), **kw)
    (jl, jR, jt), vjp = jax.vjp(jax.jit(jax_fn),
                                *map(jnp.asarray, (cs, ct, tgt)))
    jg = vjp((jnp.float32(1.0), jnp.zeros_like(jR), jnp.zeros_like(jt)))

    args = [tt(a).requires_grad_() for a in (cs, ct, tgt)]
    loss, res_R, res_t = cons.consistency_loss_pairs(
        tt(src), tt(sm), tt(nrm), args[0], args[2], tt(tm), args[1],
        tt(R), **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(np_(res_R), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(np_(res_t), np.asarray(jt), atol=1e-5)
    for a, g, what in zip(args, jg, ("cov_src", "cov_tgt", "tgt")):
        _check_grad(a.grad, g, what)


@pytest.mark.parametrize("icp_iter", [1, 3])
def test_consistency_without_covariances_matches_jax(pallas_nn, icp_iter):
    """The hier-points data term: the masked squared distance with no
    log-det regularizer (cov_src and cov_tgt None)."""
    preds = _preds(7, n=500)
    rng = np.random.default_rng(7)
    P = 3
    src = np.stack([preds["voxel_features"][i][:, :3] for i in (0, 0, 1)])
    nrm = np.stack([preds["voxel_features"][i][:, 4:7] for i in (0, 0, 1)])
    tgt = np.stack([preds["voxel_features"][j][:, :3] for j in (1, 2, 2)])
    sm = np.stack([preds["voxel_masks"][i] for i in (0, 0, 1)])
    tm = np.stack([preds["voxel_masks"][j] for j in (1, 2, 2)])
    R = np.asarray(jgeo.quat_to_matrix(jnp.asarray(_quats(rng, P, 0.05))))
    kw = dict(penalize_ratio=0.97, reg_weight=0.005, icp_iter=icp_iter)

    def jax_fn(tgt):
        return jcons.consistency_loss_pairs(
            jnp.asarray(src), jnp.asarray(sm), jnp.asarray(nrm), None,
            tgt, jnp.asarray(tm), None, jnp.asarray(R), jnp.zeros((P, 3)),
            **kw)
    (jl, jR, jt), vjp = jax.vjp(jax.jit(jax_fn), jnp.asarray(tgt))
    (jg,) = vjp((jnp.float32(1.0), jnp.zeros_like(jR), jnp.zeros_like(jt)))

    t_tgt = tt(tgt).requires_grad_()
    loss, res_R, res_t = cons.consistency_loss_pairs(
        tt(src), tt(sm), tt(nrm), None, t_tgt, tt(tm), None, tt(R), **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(np_(res_R), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(np_(res_t), np.asarray(jt), atol=1e-5)
    _check_grad(t_tgt.grad, jg, "tgt")
    # no regularizer: the loss is a mean of squared distances
    assert float(loss) > 0


# -- torch twins of the JAX suite's numerical-landmine tests -----------------

def test_zero_norms_give_finite_grads():
    """safe_norm / qnormalize / cos-weight at exactly zero vectors."""
    z = torch.zeros(4, 4, requires_grad=True)
    geo.qnormalize(z).sum().backward()
    assert torch.isfinite(z.grad).all()
    v = torch.zeros(5, 3, requires_grad=True)
    n = torch.zeros(5, 3, requires_grad=True)
    cons._cos_weight(n, v).sum().backward()
    assert torch.isfinite(v.grad).all() and torch.isfinite(n.grad).all()
    c = torch.zeros(6, 7, requires_grad=True)         # padded cov params
    cons.span_cov(c).sum().backward()
    assert torch.isfinite(c.grad).all()


def test_padded_rows_give_finite_consistency_grads(pallas_nn):
    """Padded rows carry zero covariance; the identity swap before the
    3x3 inverse keeps the backward finite, as in JAX."""
    preds = _preds(8, n=300)
    cs = np.stack([preds["voxel_covs"][0]])
    ct = np.stack([preds["voxel_covs"][1]])
    sm = np.stack([preds["voxel_masks"][0]])
    tm = np.stack([preds["voxel_masks"][1]])
    assert (~sm).any() and (~tm).any() and (cs[~sm] == 0).all()
    args = [tt(a).requires_grad_() for a in (cs, ct)]
    loss, _, _ = cons.consistency_loss_pairs(
        tt(preds["voxel_features"][0][None, :, :3]), tt(sm),
        tt(preds["voxel_features"][0][None, :, 4:7]), args[0],
        tt(preds["voxel_features"][1][None, :, :3]), tt(tm), args[1],
        torch.eye(3)[None], penalize_ratio=0.97, reg_weight=0.005,
        icp_iter=1)
    loss.backward()
    assert torch.isfinite(loss)
    for a in args:
        assert torch.isfinite(a.grad).all()
    # the inverse of an all-zero matrix stays finite too
    inv, det = cons.inv3x3(torch.zeros(2, 3, 3))
    assert torch.isfinite(inv).all() and torch.isfinite(det).all()


def test_identity_quaternions_are_exact():
    """Identity rotations survive the quaternion/matrix round trip and
    the tq-map encode/decode, and the identity hemisphere is a no-op."""
    q = torch.tensor([[1.0, 0, 0, 0]])
    np.testing.assert_array_equal(np_(geo.quat_to_matrix(q))[0], np.eye(3))
    np.testing.assert_array_equal(np_(geo.matrix_to_quat(torch.eye(3)[None])),
                                  np_(q))
    np.testing.assert_array_equal(np_(geo.hemisphere(q)), np_(q))
    tq = torch.tensor([[0.5, -0.2, 0.1, 1.0, 0, 0, 0]])
    pc_range = (-6.4, -6.4, -0.8, 6.4, 6.4, 0.8)
    g = geo.decode_tq_map(geo.generate_tq_map(tq, (4, 4), pc_range),
                          pc_range)
    np.testing.assert_allclose(np_(g)[0], np.broadcast_to(np_(tq)[0],
                                                          (4, 4, 7)),
                               atol=1e-6)
