"""Where the time of the port's chamfer NN search (B3) goes, on the card.

    python3 scripts/torch_nn_search_variants.py [--parent DIR]

Builds copies of ``rslo_tpu_torch/csrc/nn_search.cu`` with one constant
or one part of the work changed, into ``build/variants_nn/``, and times
each against the unchanged one, in turns (CUDA graphs,
``chip_smoke.graph_us``), at the deployed call: the 3 frame pairs of a
``configs/kitti_train_ours.json`` window of synthetic 100k-point scans,
20000 loss points a frame (as ``chip_smoke.py`` phase 7 builds them).

  base       the kernel as it is (128 threads, 8 src points a thread, a
             cluster of 8 blocks, 32-tgt chunks, 8 tgts unrolled, at
             least 6 blocks an SM)
  t256       256 threads (at least 3 blocks an SM)
  t512       512 threads (at least 1 block an SM)
  t256c4     256 threads, a cluster of 4 blocks
  t256r4     256 threads, 4 src points a thread (at least 4 blocks an SM)
  t256u4     256 threads, 4 tgts unrolled
  r4         4 src points a thread (at least 8 blocks an SM)
  norescan   no second scan of the chunk that set the minimum (wrong
             indices)
  fma        the distance contracted into FMAs by the compiler (3 sub, 1
             mul, 2 FMA: 2 instructions a pair fewer; not bit-equal)
  parent     with ``--parent DIR``: DIR's nn_search.cu as it is

Each copy is held against the plain version (indices and distances that
differ are counted).  The card's SM clock, power draw and limit are read
with ``nvidia-smi`` while the base kernel runs.  Needs one CUDA card.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from rslo_tpu_torch.config.schema import PipelineCfg  # noqa: E402
from rslo_tpu_torch.data.prepare import (prepare_example,  # noqa: E402
                                         voxelizer_config)
from rslo_tpu_torch.ops import _build  # noqa: E402
from rslo_tpu_torch.ops.chamfer import nn_search_plain  # noqa: E402

SOURCE = os.path.join(REPO, "rslo_tpu_torch", "csrc", "nn_search.cu")
OUT = os.path.join(REPO, "build", "variants_nn")
BOUNDS = "__launch_bounds__(THREADS, 6)"
UNROLL = "#pragma unroll 8\n      for (int j = 0; j < CHUNK; ++j)"
T256 = [("constexpr int THREADS = 128;", "constexpr int THREADS = 256;"),
        (BOUNDS, "__launch_bounds__(THREADS, 3)")]
VARIANTS = {
    "base": [],
    "t256": T256,
    "t512": [("constexpr int THREADS = 128;",
              "constexpr int THREADS = 512;"),
             (BOUNDS, "__launch_bounds__(THREADS, 1)")],
    "t256c4": T256 + [("constexpr int CLUSTER = 8;",
                       "constexpr int CLUSTER = 4;")],
    "t256r4": [T256[0], ("constexpr int R = 8;", "constexpr int R = 4;"),
               (BOUNDS, "__launch_bounds__(THREADS, 4)")],
    "t256u4": T256 + [(UNROLL, UNROLL.replace("unroll 8", "unroll 4"))],
    "r4": [("constexpr int R = 8;", "constexpr int R = 4;"),
           (BOUNDS, "__launch_bounds__(THREADS, 8)")],
    "norescan": [("    if (f >= 0 && n < N) {", "    if (f < -1 && n < N) {")],
    "fma": [("  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), "
             "__fmul_rn(dy, dy)),\n                   __fmul_rn(dz, dz));",
             "  return dx * dx + dy * dy + dz * dz;")],
}


def build(name, parent):
    os.makedirs(OUT, exist_ok=True)
    if name == "parent":
        path = os.path.join(parent, "rslo_tpu_torch", "csrc", "nn_search.cu")
    else:
        text = open(SOURCE).read()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in "
                                 f"nn_search.cu any more")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"nn_search_{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
    lib = os.path.join(OUT, f"libnn_search_{name}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           path], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on variant {name}:\n{proc.stderr}")
    regs = [ln.split(":", 1)[-1].strip() for ln in
            (proc.stdout + proc.stderr).splitlines() if "registers" in ln]
    return lib, regs


def loss_points(dev):
    """(src, src_mask, tgt, tgt_mask) of the 3 pairs of one train window,
    as chip_smoke.py phase 7 builds them."""
    import numpy as np
    with open(cs.TRAIN_CONFIG) as fh:
        cfg = PipelineCfg.from_json(fh.read())
    L = cfg.data.seq_length
    batch = cs.train_batches(cfg.data.max_points, L, 1, cs.SEED + 1, np)[0]
    ex = prepare_example(torch.as_tensor(batch["points"], device=dev),
                         torch.as_tensor(batch["point_mask"], device=dev),
                         voxelizer_config(cfg), mean_mode=True)
    V0 = ex["voxel_features"].shape[1]
    stride = max(1, -(-V0 // cfg.loss.max_loss_points))
    pts = ex["voxel_features"][:, ::stride, :3].contiguous()
    mask = ex["voxel_mask"][:, ::stride].contiguous()
    pairs = [(i, j) for i in range(L) for j in range(i + 1, L)]
    return (torch.stack([pts[i] for i, _ in pairs]),
            torch.stack([mask[i] for i, _ in pairs]),
            torch.stack([pts[j] for _, j in pairs]),
            torch.stack([mask[j] for _, j in pairs]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose nn_search.cu is "
                    "timed beside the variants")
    opts = ap.parse_args()
    smi = cs.require_card(torch)
    dev = torch.device("cuda", 0)
    names = list(VARIANTS) + (["parent"] if opts.parent else [])
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: build(n, opts.parent),
                                         names)))
    src, sm, tgt, tm = loss_points(dev)
    P, N, _ = src.shape
    M = tgt.shape[1]
    ref_d, ref_i = nn_search_plain(src, sm, tgt, tm)
    fns = {}
    for name in names:
        lib = ctypes.CDLL(built[name][0])
        lib.nn_search_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.nn_search_launch.restype = ctypes.c_int

        def run(lib=lib):
            dist = torch.empty((P, N), dtype=torch.float32, device=dev)
            idx = torch.empty((P, N), dtype=torch.int32, device=dev)
            err = lib.nn_search_launch(
                src.data_ptr(), sm.data_ptr(), tgt.data_ptr(), tm.data_ptr(),
                dist.data_ptr(), idx.data_ptr(), P, N, M,
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return dist, idx
        fns[name] = run
        d, i = run()
        torch.cuda.synchronize()
        bad_i = int((i != ref_i).sum())
        bad_d = int((d.view(torch.int32) != ref_d.view(torch.int32)).sum())
        print(f"[variant] {name:9s} {'; '.join(built[name][1])}; vs plain: "
              f"{bad_i} indices, {bad_d} distances differ", flush=True)
    us = cs.graph_us(list(fns.items()), 10, torch)
    pairs = P * N * M
    for name in names:
        print(f"[time] {name:9s} {us[name]:8.2f} us "
              f"({us[name] / us['base']:.3f} of base), "
              f"{pairs / (us[name] * 1e-6) / 1e9:.1f} G pairs/s", flush=True)
    # the clocks while the base kernel runs: ~2 s of launches queued
    samples = []

    def sample():
        for _ in range(4):
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "power.draw,power.limit,temperature.gpu",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip())
    for _ in range(4000):
        fns["base"]()
    reader = threading.Thread(target=sample)
    reader.start()
    reader.join()
    torch.cuda.synchronize()
    print(f"[clocks] while base runs (sm, max sm, draw, limit, temp): "
          f"{' | '.join(samples)}", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
