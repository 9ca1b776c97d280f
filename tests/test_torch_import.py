"""The PyTorch port imports torch and never jax, flax or the JAX package
(``rslo_tpu``), and neither does ``chip_smoke.py``.  h5py and matplotlib
(absent on the card's machine) are imported only where a store is
opened or a plot drawn."""
import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import importlib, pkgutil, sys
import rslo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rslo_tpu_torch.__path__,
                                               "rslo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "rslo_tpu", "h5py",
                                       "matplotlib"))
print(len(names), leaked)
"""


def test_port_modules_import_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CODE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.split(" ", 1)
    # every subpackage and module of the port is walked, the CLI and the
    # eval, data and logging modules among them, and the training data
    # path, the pillar middle and the parameter surgery, and the
    # refinement package (pgo/) with geometry/warp.py and the shared
    # matmul precision policy (ops/precision.py), and the data build
    # (utils/world.py, data/normals.py) with the VFEs (models/vfe.py),
    # and the rest of the model layer: attention, layers, the semi-global
    # BN, the spatial-grouped norm, the learned VFE and the dense middle,
    # and the data-parallel modules (utils/mesh_axis.py,
    # train/distributed.py, pgo/sharded.py), and the BEV stage's spatial
    # and tensor parallelism (parallel/), the bench, mean shift and the
    # timing harness, and the tiled engine (ops/tiled_conv.py)
    assert int(n) >= 75, out.stdout
    assert leaked.strip() == "[]", out.stdout


def test_port_cli_imports_without_jax():
    """``python -m rslo_tpu_torch.cli`` loads no JAX, h5py or
    matplotlib, and shows its ``create_hdf5``, ``train``, ``evaluate``
    and ``bench`` verbs."""
    env = dict(os.environ, PYTHONPATH=REPO)
    code = ("import sys, rslo_tpu_torch.cli; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'flax', 'rslo_tpu', "
            "'h5py', 'matplotlib')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    usage = subprocess.run([sys.executable, "-m", "rslo_tpu_torch.cli",
                            "--help"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
    assert usage.returncode == 0 and "evaluate" in usage.stdout
    assert "train" in usage.stdout and "create_hdf5" in usage.stdout
    assert "bench" in usage.stdout


def _imported_roots(path):
    """Top-level module names of every import statement in a file."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax():
    roots = _imported_roots(os.path.join(REPO, "chip_smoke.py"))
    assert "rslo_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "flax", "rslo_tpu"}, sorted(roots)


@pytest.mark.parametrize("script", sorted(
    os.path.basename(p)
    for p in glob.glob(os.path.join(REPO, "scripts", "torch_*.py"))))
def test_port_scripts_import_no_jax(script):
    """No import statement of the port's scripts (``scripts/torch_*.py``,
    the accuracy proxy among them) names jax, flax or the JAX package."""
    roots = _imported_roots(os.path.join(REPO, "scripts", script))
    assert not roots & {"jax", "flax", "rslo_tpu"}, sorted(roots)


# the twins of the JAX repo's scripts that drive the card; the other two
# (torch_diag_target_consistency.py, torch_eval_trend.py) work on the
# host alone, as JAX's do, and take no --device
CARD_TWINS = ("torch_diag_icp_closure", "torch_diag_preds",
              "torch_diag_pairtypes", "torch_diag_sensitivity",
              "torch_diag_yaw_head", "torch_diag_pseudo",
              "torch_eval_gen_world", "torch_scaling_bench")


@pytest.mark.parametrize("script", CARD_TWINS)
def test_twins_default_to_the_card(script, monkeypatch):
    """Each twin's command line hands its stages ``cuda`` unless given
    ``--device cpu``; none falls back to the CPU by itself."""
    import importlib.util
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    path = os.path.join(REPO, "scripts", f"{script}.py")
    spec = importlib.util.spec_from_file_location(f"_{script}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = []
    monkeypatch.setattr(mod, "main",
                        lambda *a, **kw: seen.append(a + tuple(kw.values())))
    mod.cli([])
    mod.cli(["--device", "cpu"])
    assert "cuda" in seen[0] and "cpu" not in seen[0]
    assert "cpu" in seen[1] and "cuda" not in seen[1]
    with open(path) as fh:
        text = fh.read()
    assert "is_available" not in text and "RSLO_CPU" not in text


def test_port_sources_import_no_jax():
    """No import statement of the port names the JAX package, jax or
    flax, including ones inside functions that the import walk above
    does not run."""
    bad = {}
    for root, _, files in os.walk(os.path.join(REPO, "rslo_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                hit = _imported_roots(path) & {"jax", "flax", "rslo_tpu"}
                if hit:
                    bad[os.path.relpath(path, REPO)] = sorted(hit)
    assert not bad, bad


_NEW_MODULES = ("rslo_tpu_torch.models.middle_pillar",
                "rslo_tpu_torch.data.augment",
                "rslo_tpu_torch.data.loader",
                "rslo_tpu_torch.utils.param_surgery",
                "rslo_tpu_torch.train.checkpoint")


def test_training_modules_import_without_jax():
    """The training entry point's modules, each in a fresh process:
    no jax, flax, rslo_tpu, h5py or matplotlib loaded, and no import
    statement of theirs names jax, flax or rslo_tpu."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for name in _NEW_MODULES:
        code = (f"import sys, {name}; print(sorted(m for m in sys.modules "
                f"if m.split('.')[0] in ('jax', 'flax', 'rslo_tpu', "
                f"'h5py', 'matplotlib')))")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]", (name, out.stdout)
        path = os.path.join(REPO, *name.split(".")) + ".py"
        assert not _imported_roots(path) & {"jax", "flax", "rslo_tpu"}


_REFINEMENT_MODULES = ("rslo_tpu_torch.geometry.warp",
                       "rslo_tpu_torch.pgo.pose_graph",
                       "rslo_tpu_torch.pgo.refine",
                       "rslo_tpu_torch.pgo.ba",
                       "rslo_tpu_torch.pgo.ba_bridge",
                       "rslo_tpu_torch.pgo.loop_closure",
                       "rslo_tpu_torch.ops.precision",
                       "rslo_tpu_torch.eval.runner")


def test_refinement_modules_import_without_jax():
    """The refined evaluation's modules (warp, pose graph, windowed
    refinement, BA and its bridge, loop closing, the runner), in one
    fresh process each: no jax, flax, rslo_tpu, h5py or matplotlib
    loaded, and no import statement of theirs names jax, flax or
    rslo_tpu."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for name in _REFINEMENT_MODULES:
        code = (f"import sys, {name}; print(sorted(m for m in sys.modules "
                f"if m.split('.')[0] in ('jax', 'flax', 'rslo_tpu', "
                f"'h5py', 'matplotlib')))")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]", (name, out.stdout)
        path = os.path.join(REPO, *name.split(".")) + ".py"
        assert not _imported_roots(path) & {"jax", "flax", "rslo_tpu"}


_DATA_BUILD_MODULES = ("rslo_tpu_torch.utils.world",
                       "rslo_tpu_torch.data.normals",
                       "rslo_tpu_torch.data.hdf5_store",
                       "rslo_tpu_torch.models.vfe")


def test_data_build_modules_import_without_jax():
    """The data build's modules (the raycast world, the normals and their
    native build, the store writer) and the VFEs, in one fresh process
    each: no jax, flax, rslo_tpu, h5py, matplotlib or scipy loaded (h5py
    only once a store is built or opened, scipy only by the plain
    normals), and no import statement of theirs names jax, flax or
    rslo_tpu."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for name in _DATA_BUILD_MODULES:
        code = (f"import sys, {name}; print(sorted(m for m in sys.modules "
                f"if m.split('.')[0] in ('jax', 'flax', 'rslo_tpu', "
                f"'h5py', 'matplotlib', 'scipy')))")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]", (name, out.stdout)
        path = os.path.join(REPO, *name.split(".")) + ".py"
        assert not _imported_roots(path) & {"jax", "flax", "rslo_tpu"}


_DATA_PARALLEL_MODULES = ("rslo_tpu_torch.utils.mesh_axis",
                          "rslo_tpu_torch.train.distributed",
                          "rslo_tpu_torch.pgo.sharded",
                          "rslo_tpu_torch.train.step",
                          "rslo_tpu_torch.pgo.ba",
                          "torch_dist_workers")


def test_data_parallel_modules_import_without_jax():
    """The data-parallel modules and the rank processes' module of the
    tests (tests/torch_dist_workers.py: the spawned ranks load it and
    must not load JAX), in one fresh process: no jax, flax, rslo_tpu,
    h5py or matplotlib loaded, and no import statement of theirs names
    jax, flax or rslo_tpu."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    code = (f"import sys, {', '.join(_DATA_PARALLEL_MODULES)}; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"('jax', 'flax', 'rslo_tpu', 'h5py', 'matplotlib')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    for name in _DATA_PARALLEL_MODULES:
        path = (os.path.join(REPO, "tests", name + ".py")
                if "." not in name else
                os.path.join(REPO, *name.split(".")) + ".py")
        assert not _imported_roots(path) & {"jax", "flax", "rslo_tpu"}, \
            name


_SPLIT_AND_BENCH_MODULES = ("rslo_tpu_torch.parallel",
                            "rslo_tpu_torch.parallel.spatial",
                            "rslo_tpu_torch.parallel.tensor",
                            "rslo_tpu_torch.bench",
                            "rslo_tpu_torch.geometry.meanshift",
                            "rslo_tpu_torch.utils.timing")


def test_split_bench_and_utility_modules_import_without_jax():
    """The BEV stage's spatial and tensor parallelism, the bench, mean
    shift and the timing harness, in one fresh process: no jax, flax,
    rslo_tpu, h5py or matplotlib loaded, and no import statement of
    theirs names jax, flax or rslo_tpu."""
    env = dict(os.environ, PYTHONPATH=REPO)
    code = (f"import sys, {', '.join(_SPLIT_AND_BENCH_MODULES)}; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"('jax', 'flax', 'rslo_tpu', 'h5py', 'matplotlib')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    for name in _SPLIT_AND_BENCH_MODULES:
        path = os.path.join(REPO, *name.split("."))
        path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
                else path + ".py")
        assert not _imported_roots(path) & {"jax", "flax", "rslo_tpu"}, \
            name


def test_kitti_e2e_script_builds_a_store_without_jax_or_h5py(tmp_path):
    """``scripts/torch_kitti_e2e_smoke.py`` in a fresh process: its tree
    and the directory store built from it load no jax, flax, rslo_tpu,
    h5py or matplotlib, and no import statement of the script names
    jax, flax or rslo_tpu."""
    script = os.path.join(REPO, "scripts", "torch_kitti_e2e_smoke.py")
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('twin', {script!r})\n"
        "twin = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(twin)\n"
        f"tree = twin.build_tree({str(tmp_path / 'tree')!r}, n_points=500,"
        " n_frames=2)\n"
        f"twin.create_store(tree, {str(tmp_path / 'store')!r})\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'rslo_tpu', 'h5py', 'matplotlib')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    assert sorted(os.listdir(tmp_path / "store")) == ["00", "01"]
    assert not _imported_roots(script) & {"jax", "flax", "rslo_tpu"}
