"""The port's kernel build names each library by the hash of everything
that goes into it: an edited source or an edited shared header must not
be served from a stale library.  CPU only; nothing is compiled."""
import shutil
from pathlib import Path

import pytest

from rslo_tpu_torch.ops import _build

KERNELS = ("gather_matmul", "band_conv", "row_gather", "nn_search")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that the build reads instead of the
    package's own."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy)
    monkeypatch.setattr(_build, "_CSRC", copy)
    return copy


def _edit(path):
    path.write_text(path.read_text() + "\n// edited\n")


@pytest.mark.parametrize("name", KERNELS)
def test_library_path_is_stable(csrc, name):
    assert _build.library_path(name) == _build.library_path(name)
    assert _build.library_path(name).parent == _build.BUILD_DIR
    assert _build.library_path(name).name.startswith(f"lib{name}-")


@pytest.mark.parametrize("name", KERNELS)
def test_library_path_follows_the_source(csrc, name):
    before = _build.library_path(name)
    _edit(csrc / f"{name}.cu")
    assert _build.library_path(name) != before


@pytest.mark.parametrize("name", ("gather_matmul", "band_conv"))
def test_library_path_follows_the_shared_header(csrc, name):
    assert '#include "gather_gemm.cuh"' in (csrc / f"{name}.cu").read_text()
    before = {k: _build.library_path(k) for k in KERNELS}
    _edit(csrc / "gather_gemm.cuh")
    assert _build.library_path(name) != before[name]
    # the other source's library moves too: every header is hashed
    assert all(_build.library_path(k) != before[k] for k in KERNELS)


def test_library_path_follows_a_new_header(csrc):
    before = _build.library_path("gather_matmul")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("gather_matmul") != before


def test_library_path_follows_the_flags(csrc, monkeypatch):
    before = _build.library_path("gather_matmul")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("gather_matmul") != before


def test_the_package_sources_are_untouched(csrc):
    real = Path(__file__).resolve().parents[1] / "rslo_tpu_torch" / "csrc"
    header = (real / "gather_gemm.cuh").read_bytes()
    _edit(csrc / "gather_gemm.cuh")
    assert csrc != real
    assert (real / "gather_gemm.cuh").read_bytes() == header
