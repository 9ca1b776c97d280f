"""The port's raycast world (rslo_tpu_torch.utils.world) against the JAX
package's: both are numpy, so scans, trajectories and the written KITTI
tree must be bit-equal and byte-equal for the same seeds.  At a 16 x
512 beam grid over a shrunken world (tests/test_cli_loops_e2e.py's)."""
import numpy as np
import pytest

from rslo_tpu.utils import world as jworld
from rslo_tpu_torch.utils import world

SMALL = dict(extent=10.0, n_walls=30, n_boxes=12, n_cyl=14, corridor=2.5)
BEAMS = dict(n_beams=16, n_azimuth=512)


@pytest.mark.parametrize("seed", [0, 3])
def test_scan_is_bit_equal(seed):
    poses = jworld.synth_trajectory(seed=seed, n_frames=3, pattern="loop",
                                    speed=3.0)
    jw = jworld.SynthWorld(seed=seed, **SMALL)
    pw = world.SynthWorld(seed=seed, **SMALL)
    jrng, prng = (np.random.default_rng(seed + 1234) for _ in range(2))
    for p in poses:
        want = jw.scan(p, jrng, **BEAMS)
        got = pw.scan(p, prng, **BEAMS)
        assert got.dtype == want.dtype == np.float32
        assert len(want) > 500
        np.testing.assert_array_equal(got, want)
    # both rngs drew the same numbers, in the same order
    assert prng.uniform() == jrng.uniform()


@pytest.mark.parametrize("pattern", ["curve", "loop", "loop_cw"])
@pytest.mark.parametrize("profile", ["walk", "varied", "urban"])
def test_synth_trajectory_is_bit_equal(pattern, profile):
    kw = dict(seed=7, n_frames=120, pattern=pattern, speed=6.0,
              speed_profile=profile)
    want = jworld.synth_trajectory(**kw)
    got = world.synth_trajectory(**kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_render_sequence_is_bit_equal():
    poses = jworld.synth_trajectory(seed=2, n_frames=3, pattern="curve",
                                    speed=4.0)
    jf, jo = jworld.render_sequence(jworld.SynthWorld(seed=2, **SMALL),
                                    poses, seed=2, **BEAMS)
    pf, po = world.render_sequence(world.SynthWorld(seed=2, **SMALL),
                                   poses, seed=2, **BEAMS)
    np.testing.assert_array_equal(po, jo)
    for got, want in zip(pf, jf):
        np.testing.assert_array_equal(got, want)


def test_write_kitti_tree_is_byte_equal(tmp_path):
    seqs = {0: (4, "loop", 3.0), 2: (3, "curve", 4.0)}
    kw = dict(world_seed=3, world_kwargs=SMALL, **BEAMS)
    want = jworld.write_kitti_tree(tmp_path / "jax", seqs, **kw)
    got = world.write_kitti_tree(tmp_path / "port", seqs, **kw)
    assert list(got) == list(want)
    for s in seqs:
        for g, w in zip(got[s], want[s]):
            np.testing.assert_array_equal(g, w)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 2 * 2 + 4 + 3      # calib + poses, .bin files
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
