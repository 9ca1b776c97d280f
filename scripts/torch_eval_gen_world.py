"""Scene-generalization eval on the PyTorch port (the twin of
``scripts/eval_gen_world.sh``, which drives the JAX package): score an
aug-trained proxy checkpoint against a val sequence rendered from an
UNSEEN world (``world_seed`` 1): the same trajectory family, different
scene content.

    python scripts/torch_eval_gen_world.py [middle] [ckpt_step]
        [--tag T] [--train_root DIR] [--device cpu]

Defaults: ``PillarMiddleCov``, ``best``, tag ``aug`` (JAX's script
hard-codes it), the trained model dir under ``--train_root`` (default:
``scripts/torch_accuracy_proxy.py``'s ``ROOT``).  Stages, each through
the proxy script run with its root at ``GEN``
(``$TMPDIR/rslo_proxy_torch_gen``):

  1. ``build --seqs 7 --world_seed 1``: render seq 7 from world 1 and
     store it, unless ``GEN``'s store already holds it (JAX's script
     copies a store built by that command);
  2. copy ``model_<middle>_<tag>`` from the train root into ``GEN``;
  3. ``eval --middle M --tag T --ckpt_step C`` (on the CUDA card unless
     ``--device cpu`` is given), then ``report``.

Each stage is a function (``build``, ``copy_model``, ``evaluate``), so a
caller can run them one by one.
"""
import argparse
import importlib.util
import os
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
PROXY_SCRIPT = HERE / "torch_accuracy_proxy.py"
GEN = Path(tempfile.gettempdir()) / "rslo_proxy_torch_gen"
VAL_SEQ = 7
WORLD_SEED = 1


def load_proxy(root):
    """``scripts/torch_accuracy_proxy.py`` as a fresh module whose
    artifacts go under ``root`` (its ``RSLO_PROXY_ROOT``)."""
    old = os.environ.get("RSLO_PROXY_ROOT")
    os.environ["RSLO_PROXY_ROOT"] = str(root)
    try:
        spec = importlib.util.spec_from_file_location(
            "torch_accuracy_proxy_gen", PROXY_SCRIPT)
        proxy = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(proxy)
    finally:
        if old is None:
            del os.environ["RSLO_PROXY_ROOT"]
        else:
            os.environ["RSLO_PROXY_ROOT"] = old
    return proxy


def build(gen_root=GEN):
    """Stage 1: the proxy's ``build --seqs 7 --world_seed 1`` under
    ``gen_root``, unless its store holds seq 7.  Returns the argv run,
    or None."""
    proxy = load_proxy(gen_root)
    if (proxy.STORE / f"{VAL_SEQ:02d}").exists():
        return None
    argv = ["build", "--seqs", str(VAL_SEQ), "--world_seed",
            str(WORLD_SEED)]
    proxy.main(argv)
    return argv


def copy_model(middle, tag="aug", train_root=None, gen_root=GEN):
    """Stage 2: ``model_<middle>_<tag>`` of the train root (the proxy's
    default root when None) copied into ``gen_root``, replacing any
    earlier copy.  Returns the copy's path."""
    if train_root is None:
        sys.path.insert(0, str(HERE))
        from torch_accuracy_proxy import ROOT as train_root
    name = Path(load_proxy(gen_root)._model_dir(middle, False, tag)).name
    dst = Path(gen_root) / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(Path(train_root) / name, dst)
    return dst


def evaluate(middle, ckpt_step="best", tag="aug", gen_root=GEN,
             device="cuda"):
    """Stage 3: ``eval --middle M --tag T --ckpt_step C`` then
    ``report`` under ``gen_root``.  Returns (the eval's result, the
    report's rows, the argv of both)."""
    proxy = load_proxy(gen_root)
    argvs = [["eval", "--middle", middle, "--tag", tag, "--ckpt_step",
              str(ckpt_step), "--device", device], ["report"]]
    res = proxy.main(argvs[0])
    rows = proxy.main(argvs[1])
    return res, rows, argvs


def main(middle="PillarMiddleCov", ckpt_step="best", tag="aug",
         train_root=None, gen_root=GEN, device="cuda"):
    Path(gen_root).mkdir(parents=True, exist_ok=True)
    build(gen_root)
    copy_model(middle, tag, train_root, gen_root)
    return evaluate(middle, ckpt_step, tag, gen_root, device)


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("middle", nargs="?", default="PillarMiddleCov")
    p.add_argument("ckpt_step", nargs="?", default="best")
    p.add_argument("--tag", default="aug")
    p.add_argument("--train_root", default=None,
                   help="root of the trained model dir (default: the "
                        "proxy's RSLO_PROXY_ROOT)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    return main(a.middle, a.ckpt_step, a.tag, a.train_root, GEN, a.device)


if __name__ == "__main__":
    cli()
