"""Where the time of the port's gather-GEMM goes, on the card.

    python3 scripts/torch_gather_gemm_variants.py

Builds copies of ``rslo_tpu_torch/csrc/gather_matmul.cu`` whose shared
kernel body (``gather_gemm.cuh``) is patched to leave one part of the
work out, into ``build/variants/``, and times each copy against the
unpatched one, in turns (CUDA graphs, ``chip_smoke.graph_us``), at a few
of the 20 sparse convs of a KITTI-scale synthetic frame: the forward in
bf16 and f32, and the bf16 feature gradient over the frame's transposed
rulebooks (train mode):

  base       the kernel as it is
  nocompute  no math (the rows and W[k] are still gathered)
  noloads    no gathers after the first stages (the math runs on stale
             rows)
  notaps     no tap at all: the index fill, the tap list, the epilogue
             and the launch
  nofixup    (feature gradient only) no entry is checked against a
             bf16 rounding tie nor summed again as the in-order chain
  modstage   each tap's stage found as i % nstage (a division per tap)
  nolo       (feature gradient only) no MMA for the lo pieces

The patched copies compute wrong results; they measure, nothing else.
``base`` is held against the plain version (max |err|); for the feature
gradient the entries that differ from the plain version are counted for
``base`` and ``nofixup``.  Needs one CUDA card.
"""
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from rslo_tpu_torch.config.schema import PipelineCfg  # noqa: E402
from rslo_tpu_torch.data.prepare import (prepare_example,  # noqa: E402
                                         voxelizer_config)
from rslo_tpu_torch.models.net import OdomNet  # noqa: E402
from rslo_tpu_torch.ops import _build, dma_gather  # noqa: E402
from rslo_tpu_torch.ops.sparse_conv import (sparse_conv_apply,  # noqa: E402
                                            sparse_conv_dgrad)
from rslo_tpu_torch.utils.synthetic import synth_sequence  # noqa: E402

CSRC = os.path.join(REPO, "rslo_tpu_torch", "csrc")
OUT = os.path.join(REPO, "build", "variants")
CONVS = (0, 1, 6, 10, 13, 19)
DGRAD_CONVS = (1, 6, 10, 16, 19)
VARIANTS = {
    "base": [],
    "nocompute": [("    const bool v_lo = src_k[r_lo] >= 0;",
                   "    if (Cin > 0) continue;\n"
                   "    const bool v_lo = src_k[r_lo] >= 0;")],
    "noloads": [("    if (nxt < n_used) {   // into the stage",
                 "    if (nxt < 0) {   // into the stage")],
    "notaps": [("  const int n_used = *n_used_s;",
                "  const int n_used = 0 * *n_used_s;")],
    "nofixup": [("if (__any_sync(0xffffffffu, fix != 0)) {",
                 "if (fix != fix) {")],
    "modstage": [("    const float* g = smem + stage_of(i, nstage) * L.stage;",
                  "    const float* g = smem + (i % nstage) * L.stage;"),
                 ("smem + stage_of(nxt, nstage) * L.stage;",
                  "smem + (nxt % nstage) * L.stage;")],
    "nolo": [("mma_bf16(d, lo, b0, b1);   // smallest pieces first\n"
              "          mma_bf16_acc(d, mid, b0, b1);",
              "mma_bf16(d, mid, b0, b1);")],
}
FORWARD = ("base", "nocompute", "noloads", "notaps", "modstage")


def build(name):
    header = open(os.path.join(CSRC, "gather_gemm.cuh")).read()
    for old, new in VARIANTS[name]:
        if old not in header:
            sys.exit(f"variant {name}: the header no longer has {old!r}")
        header = header.replace(old, new)
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "gather_gemm.cuh"), "w") as fh:
        fh.write(header)
    with open(os.path.join(d, "gather_matmul.cu"), "w") as fh:
        fh.write(open(os.path.join(CSRC, "gather_matmul.cu")).read())
    lib = os.path.join(d, "libgather_matmul.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(d, "gather_matmul.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.exit(f"nvcc failed on variant {name}:\n{proc.stderr[-3000:]}")
    if name == "base":   # ptxas -v: the registers of each instantiation
        fn = ""
        for line in (proc.stdout + proc.stderr).splitlines():
            m = re.search(r"gather_gemm_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
            if "entry function" in line:
                fn = f"mode {m[1]} KS {m[2]} NT {m[3]}" if m else ""
            elif fn and ("registers" in line or "spill" in line):
                print(f"base {fn}: {line.split(':', 1)[-1].strip()}")
    return lib


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    ours = dma_gather._library()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        lib.gather_matmul_launch.argtypes = ours.gather_matmul_launch.argtypes
        lib.gather_matmul_launch.restype = ctypes.c_int
        lib.gather_matmul_max_channels.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    cfg = PipelineCfg.from_json(open(cs.CONFIG).read())
    gen = torch.Generator().manual_seed(cs.SEED)
    net = OdomNet(cfg, gen)
    cs.randomize_bn(net, gen)
    net = net.to(dev).eval()
    frames, _ = synth_sequence(seed=cs.SEED, n_frames=1,
                               n_points=cs.N_POINTS)
    pts = torch.as_tensor(frames[0], device=dev)
    ex = prepare_example(pts[None], torch.ones(1, len(frames[0]),
                                               dtype=bool, device=dev),
                         voxelizer_config(cfg), mean_mode=True)
    with torch.no_grad():
        calls = cs.capture_conv_calls(net, lambda: net.frame_features(
            ex["voxel_features"][0], ex["coords"][0], ex["voxel_mask"][0]))
    tcfg = PipelineCfg.from_json(open(cs.TRAIN_CONFIG).read())
    tnet = OdomNet(tcfg, torch.Generator().manual_seed(cs.SEED)).to(dev)
    tnet.train()      # with autograd on: the geometry carries rb_t
    train_calls = cs.capture_conv_calls(tnet, lambda: tnet.frame_features(
        ex["voxel_features"][0], ex["coords"][0], ex["voxel_mask"][0]))
    calls = [(f, op.rb, w, b, om) for f, op, w, b, om in calls]
    saved = dma_gather._library

    def on(lib, fn, *args):
        dma_gather._library = lambda: lib
        try:
            return fn(*args)
        finally:
            dma_gather._library = saved

    with torch.no_grad():
        for ci in CONVS:
            f, rb, w, b, om = calls[ci]
            for dt in (torch.bfloat16, torch.float32):
                args = (f, rb.idx, rb.valid, w, b, om, dt)
                ref = sparse_conv_apply(f, rb, w, b, om, dt)
                err = (on(libs["base"], dma_gather.gather_matmul, *args)
                       - ref).abs()
                torch.cuda.synchronize()
                us = cs.graph_us(
                    [(n, lambda lib=libs[n]: on(
                        lib, dma_gather.gather_matmul, *args))
                     for n in FORWARD], 20, torch)
                V, K = rb.idx.shape
                print(f"conv {ci:2d} V={V} K={K} {f.shape[1]}->{w.shape[2]} "
                      f"{str(dt)[6:]}: base max |err| {err.max().item():.2e}"
                      f"; " + ", ".join(f"{n} {u:.2f} us"
                                        for n, u in us.items()), flush=True)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        for ci in DGRAD_CONVS:
            _, op, w, _, _ = train_calls[ci]
            w_t = w.to(torch.bfloat16).float()
            w_t = (w_t.flip(0) if op.flip_taps else w_t).transpose(1, 2)
            ct = torch.randn(op.rb.idx.shape[0], w.shape[2], device=dev,
                             generator=gen)
            args = (ct, op.rb_t.idx, op.rb_t.valid, w_t.contiguous(),
                    torch.bfloat16)
            ref = sparse_conv_dgrad(ct, op.rb_t, args[3], torch.bfloat16)
            differ = {n: int((on(libs[n], dma_gather.gather_matmul_dgrad,
                                 *args) != ref).sum())
                      for n in ("base", "nofixup")}
            err = (on(libs["base"], dma_gather.gather_matmul_dgrad, *args)
                   - ref).abs()
            us = cs.graph_us(
                [(n, lambda lib=lib: on(
                    lib, dma_gather.gather_matmul_dgrad, *args))
                 for n, lib in libs.items()], 20, torch)
            V, K = op.rb_t.idx.shape
            print(f"dgrad conv {ci:2d} Vin={V} K={K} {w.shape[2]}->"
                  f"{w.shape[1]} bf16: base max |err| {err.max().item():.2e}"
                  f", entries differing from the plain version of "
                  f"{ref.numel()}: base {differ['base']}, nofixup "
                  f"{differ['nofixup']}; " + ", ".join(
                      f"{n} {u:.2f} us" for n, u in us.items()), flush=True)


if __name__ == "__main__":
    main()
