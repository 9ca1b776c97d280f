"""The port's host normals (rslo_tpu_torch.data.normals) against the JAX
package's: the native build of native/prep.cpp bit-equal to JAX's
native library, the plain (scipy) version bit-equal to JAX's scipy
path, ``voxel_downsample`` bit-equal; the library named by the hash of
its source and flags, under build/rslo_tpu_torch/; and a failed build
raising rather than falling back to scipy.  On a raycast scan of the
port's world (32 x 1024 beams)."""
import shutil

import numpy as np
import pytest
import scipy.spatial

from rslo_tpu.data import normals as jnormals
from rslo_tpu_torch.data import normals
from rslo_tpu_torch.ops import _build
from rslo_tpu_torch.utils.world import SynthWorld, synth_trajectory

from torch_port_helpers import jax_native_normals


@pytest.fixture(scope="module")
def scan():
    pose = synth_trajectory(seed=1, n_frames=1, pattern="curve")[0]
    pts = SynthWorld(seed=1, extent=40.0).scan(
        pose, np.random.default_rng(1), n_beams=32, n_azimuth=1024)
    assert len(pts) > 5000
    return pts[:, :4]


@pytest.mark.parametrize("radius,k", [(0.6, 30), (1.5, 30), (0.6, 8)])
def test_native_normals_bit_equal_to_jax(scan, radius, k):
    jax_native_normals()
    want = jnormals.estimate_normals(scan[:, :3], radius, k)
    got = normals.estimate_normals(scan[:, :3], radius, k)
    assert got.dtype == np.float32 and got.shape == (len(scan), 3)
    np.testing.assert_array_equal(got, want)
    assert normals.library_path().exists()
    assert normals.library_path().parent == _build.BUILD_DIR


def test_plain_normals_bit_equal_to_jax_scipy_path(scan, monkeypatch):
    monkeypatch.setattr(jnormals, "_NATIVE", False)   # JAX's fallback
    want = jnormals.estimate_normals(scan[:, :3], 0.6, 30)
    got = normals.estimate_normals_plain(scan[:, :3], 0.6, 30)
    np.testing.assert_array_equal(got, want)
    # the two versions are different estimators: most rows agree
    native = normals.estimate_normals(scan[:, :3], 0.6, 30)
    agree = np.abs(np.sum(native * got, axis=1)) > 0.99
    assert 0.5 < agree.mean() < 1.0


@pytest.mark.parametrize("voxel", [0.1, 0.5])
def test_voxel_downsample_bit_equal_to_jax(scan, voxel):
    pn = np.concatenate([scan[:, :3], normals.estimate_normals(scan)], 1)
    want = jnormals.voxel_downsample(pn, voxel)
    got = normals.voxel_downsample(pn, voxel)
    assert got.dtype == np.float32 and len(got) < len(pn)
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def src_copy(tmp_path, monkeypatch):
    """A copy of native/prep.cpp that the build reads, and a build
    directory of its own."""
    copy = tmp_path / "prep.cpp"
    shutil.copy(normals._SRC, copy)
    monkeypatch.setattr(normals, "_SRC", copy)
    monkeypatch.setattr(normals, "BUILD_DIR", tmp_path / "build")
    return copy


def test_library_path_follows_the_source_and_flags(src_copy, monkeypatch):
    before = normals.library_path()
    assert before == normals.library_path()
    assert before.name.startswith("libprep-") and before.suffix == ".so"
    src_copy.write_text(src_copy.read_text() + "\n// edited\n")
    edited = normals.library_path()
    assert edited != before
    monkeypatch.setattr(normals, "GXX_FLAGS", normals.GXX_FLAGS + ("-g",))
    assert normals.library_path() not in (before, edited)


def test_a_failed_build_raises_and_does_not_fall_back(src_copy, scan,
                                                      monkeypatch):
    src_copy.write_text(src_copy.read_text() + "\nnot C++ at all\n")
    used = []
    monkeypatch.setattr(scipy.spatial, "cKDTree",
                        lambda *a, **k: used.append(a))
    with pytest.raises(RuntimeError, match="g.. failed"):
        normals.estimate_normals(scan[:, :3])
    assert not used
    assert not normals.library_path().exists()
    assert not list(normals.BUILD_DIR.glob("*.tmp"))
