"""Where the time of the band engine's im2col (B5) goes, on the card.

    python3 scripts/torch_band_gather_variants.py [--parent DIR]

Builds copies of ``rslo_tpu_torch/csrc/band_conv.cu`` with one constant
of B5 changed, into ``build/variants_band/``, checks each bit-equal to
the plain versions in both modes, and times each against the unchanged
one, in turns (CUDA graphs, ``chip_smoke.graph_us``), at the band plans
of a synthetic 100k-point scan at ``configs/kitti_eval_ours.json``
(``middle.engine="band"``, as ``chip_smoke.py`` phase 6 builds them):
the submanifold convs 0 (7 channels), 1 (16, L0), 6 (32) and 10 (64),
the plain contract (bf16) and the fused d_W mode (bf16, f32 out):

  base       the kernel as it is (32 rows a block, 4 segments a thread
             in flight)
  rows16     16 rows a block
  rows64     64 rows a block
  rows128    128 rows a block
  unroll2    2 segments a thread in flight
  unroll8    8 segments a thread in flight
  parent     with ``--parent DIR``: DIR's band_conv.cu (plain contract
             only, if it has no fused mode)

Beside them: ``torch.index_select`` of the plan's sources from a bf16
copy of the features with a zero row appended, the one PyTorch call
that computes the same bf16 im2col, and each case's bytes bound.  Needs
one CUDA card.
"""
import argparse
import ctypes
import dataclasses
import os
import shutil
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
from rslo_tpu_torch.ops import _build  # noqa: E402
from rslo_tpu_torch.ops import band_conv as bc  # noqa: E402
from rslo_tpu_torch.utils.synthetic import synth_sequence  # noqa: E402

CSRC = os.path.join(REPO, "rslo_tpu_torch", "csrc")
OUT = os.path.join(REPO, "build", "variants_band")
CONVS = (0, 1, 6, 10)
ROWS = "constexpr int GATHER_ROWS = 32;"
UNROLL = "constexpr int UNROLL = 4; "
VARIANTS = {
    "base": [],
    "rows16": [(ROWS, ROWS.replace("32", "16"))],
    "rows64": [(ROWS, ROWS.replace("32", "64"))],
    "rows128": [(ROWS, ROWS.replace("32", "128"))],
    "unroll2": [(UNROLL, UNROLL.replace("4", "2"))],
    "unroll8": [(UNROLL, UNROLL.replace("4", "8"))],
}


def build(name, parent):
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    src_dir = (os.path.join(parent, "rslo_tpu_torch", "csrc")
               if name == "parent" else CSRC)
    text = open(os.path.join(src_dir, "band_conv.cu")).read()
    for old, new in VARIANTS.get(name, []):
        if old not in text:
            sys.exit(f"variant {name}: band_conv.cu no longer has {old!r}")
        text = text.replace(old, new)
    with open(os.path.join(d, "band_conv.cu"), "w") as fh:
        fh.write(text)
    shutil.copy(os.path.join(src_dir, "gather_gemm.cuh"), d)
    lib = os.path.join(d, "libband_conv.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(d, "band_conv.cu")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        sys.exit(f"nvcc failed on variant {name}:\n{proc.stderr[-3000:]}")
    if name == "base":   # ptxas -v: B5's instantiations
        fn = ""
        for line in (proc.stdout + proc.stderr).splitlines():
            if "entry function" in line:
                fn = line.split("'")[1] if "band_" in line else ""
            elif fn and ("registers" in line or "spill" in line):
                print(f"base {fn[:60]}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose band_conv.cu is "
                    "timed beside the variants")
    opts = ap.parse_args()
    smi = cs.require_card(torch)
    ours = bc._library()
    names = list(VARIANTS) + (["parent"] if opts.parent else [])
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(lambda n: build(n, opts.parent),
                                          names)))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        for fn in ("band_gather_launch", "band_gather_fused_launch",
                   "band_matmul_launch", "band_matmul_max_channels"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
                getattr(lib, fn).restype = getattr(ours, fn).restype
        libs[name] = lib
    saved = bc._library

    def on(lib, *args, **kwargs):
        bc._library = lambda: lib
        try:
            return bc.band_gather(*args, **kwargs)
        finally:
            bc._library = saved

    dev = torch.device("cuda", 0)
    cfg = PipelineCfg.from_json(open(cs.CONFIG).read())
    cfg = cfg.replace(middle=dataclasses.replace(cfg.middle, engine="band"))
    net = OdomNet(cfg, torch.Generator().manual_seed(cs.SEED)).to(dev).eval()
    frames, _ = synth_sequence(seed=cs.SEED, n_frames=1,
                               n_points=cs.N_POINTS)
    pts = torch.as_tensor(frames[0], device=dev)
    ex = prepare_example(pts[None], torch.ones(1, len(frames[0]),
                                               dtype=bool, device=dev),
                         voxelizer_config(cfg), mean_mode=True)
    bf16 = torch.bfloat16
    with torch.no_grad():
        calls = cs.capture_conv_calls(net, lambda: net.frame_features(
            ex["voxel_features"][0], ex["coords"][0], ex["voxel_mask"][0]))
        for ci in CONVS:
            f, op = calls[ci][:2]
            p = op.plan
            if not p.self_transpose:
                sys.exit(f"conv {ci} is not a submanifold conv")
            fp = bc.pad_rows(f, p.v_in).contiguous()
            ov = (p.ov_out, p.ov_in, p.ov_tap)
            nB, K, B = p.sel.shape
            Cin = fp.shape[1]
            ref = bc.band_gather_plain(fp, p.base, p.sel, bf16)
            ref_dw = bc.band_gather_dw_plain(fp, p.base, p.sel, bf16, ov)
            src, valid = bc._sources(p.base, p.sel)
            idx_lib = torch.where(valid[:, 0], src, fp.shape[0])
            f_lib = torch.cat([fp, fp.new_zeros(1, Cin)]).to(bf16)
            named = [("index_select",
                      lambda: torch.index_select(f_lib, 0, idx_lib))]
            fused = []
            bad = []
            for n, lib in libs.items():
                g = on(lib, fp, p.base, p.sel, bf16)
                if not torch.equal(g.view(torch.int16),
                                   ref.view(torch.int16)):
                    bad.append(f"{n} plain")
                named.append((n, lambda lib=lib: on(lib, fp, p.base, p.sel,
                                                    bf16)))
                if hasattr(lib, "band_gather_fused_launch"):
                    dw = on(lib, fp, p.base, p.sel, bf16, overflow=ov)
                    if not torch.equal(dw.view(torch.int32),
                                       ref_dw.view(torch.int32)):
                        bad.append(f"{n} fused")
                    fused.append((f"{n} fused", lambda lib=lib: on(
                        lib, fp, p.base, p.sel, bf16, overflow=ov)))
            torch.cuda.synchronize()
            if bad:
                sys.exit(f"conv {ci}: not bit-equal to the plain version: "
                         f"{bad}")
            us = cs.graph_us(named + fused, 20, torch)
            inputs = cs.nbytes(fp, p.base, p.sel)
            bnd = cs.bound_ms(inputs + nB * B * K * Cin * 2)[0] * 1e3
            bnd_dw = cs.bound_ms(inputs + cs.nbytes(*ov) +
                                 nB * B * K * Cin * 4)[0] * 1e3
            print(f"conv {ci:2d} nB={nB} K={K} B={B} Cin={Cin} "
                  f"({int((p.sel >= 0).sum())} in-window pairs, "
                  f"{int(p.ov_count)} overflow), all bit-equal; bound "
                  f"{bnd:.2f} us, fused {bnd_dw:.2f} us: " + ", ".join(
                      f"{n} {u:.2f}" for n, u in us.items()) + " us",
                  flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
