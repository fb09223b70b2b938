"""Micro: K7 (the int8 fused 3x3 conv) at the two trunk shapes of the int8
serving mode, by ring depth and by phase.

  python -m cobevt_tpu_torch.tools.micro_k7
  python -m cobevt_tpu_torch.tools.micro_k7 --phases

Times the kernel alone, on the card alone (launches queued behind a sleep
kernel), on its input's |max| slot, for the weight ring depths the wgmma
kernel takes (2 to 4 boxes: three keep two blocks on an SM at both shapes,
four leave one) and for the mma.sync kernel (depth 0), and checks that all
of them give the same output bit for bit.  ``--phases`` builds copies of the
wgmma kernel's source with global-timer stamps (block start, after the first
halo tile, after the products, end) into the build directory, as it is,
without its products and without its halo loads, and prints each phase's
mean time a block, which says where a block's time goes.  One JSON line at
the end.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import subprocess
import sys

import numpy as np
import torch

from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.conv2d import (
    _int8_lib,
    int8_absmax,
    int8_tile_plan,
    new_amax_slots,
    pack_int8_weight,
)
from cobevt_tpu_torch.tools.timing import device_ms

# (N, H, W, C = O, calls an int8 frame): layer3's and layer4's stride-1 convs
SHAPES = [(20, 32, 32, 256, 10), (20, 16, 16, 512, 4)]
DEPTHS = (0, 2, 3, 4)
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def operands(shape, residual, gen):
    N, H, W, C, _ = shape
    x = torch.randn(N, H, W, C, generator=gen, device="cuda").relu()
    w = torch.randn(3, 3, C, C, generator=gen, device="cuda") * (
        2 / (9 * C)) ** 0.5
    p = pack_int8_weight(w, torch.randn(C, generator=gen, device="cuda")
                         * 0.1)
    r = (torch.randn(N, H, W, C, generator=gen, device="cuda").bfloat16()
         if residual else None)
    x = x.bfloat16()
    return x, p, r, int8_absmax(x, new_amax_slots(1, x.device))


def launcher(fn, shape, x, p, r, slot, out, stages):
    N, H, W, C, _ = shape
    rows = int8_tile_plan(H, W, C).rows

    def run():
        err = fn(x.data_ptr(), p.wt.data_ptr(), p.s_w.data_ptr(),
                 p.shift.data_ptr(), slot.data_ptr(),
                 None if r is None else r.data_ptr(), out.data_ptr(), None,
                 N, H, W, C, C, 1, 1, rows, stages, x.device.index,
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, f"K7 at ring depth {stages}")
    return run


def depths(gen, iters):
    fn = _int8_lib()[0]
    rows = []
    for shape in SHAPES:
        for residual in (False, True):
            x, p, r, slot = operands(shape, residual, gen)
            out, first = torch.empty_like(x), None
            for stages in DEPTHS:
                run = launcher(fn, shape, x, p, r, slot, out, stages)
                ms = device_ms(run, iters)
                first = out.clone() if first is None else first
                rows.append({"shape": shape[:4], "residual": residual,
                             "depth": stages, "alone_ms": ms,
                             "per_frame": shape[4],
                             "equal": bool(torch.equal(out, first))})
                print(f"K7 {shape[:4]} residual={residual} depth={stages}: "
                      f"{ms * 1e3:.1f} us alone, equal={rows[-1]['equal']}",
                      flush=True)
    return rows


def _stamp(i):
    return ("  if (threadIdx.x == 0) { unsigned long long t_; asm volatile("
            "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); g_stamps[(blockIdx"
            f".y * gridDim.x + blockIdx.x) * 4 + {i}] = t_; }}\n")


def _timed_source(src, variant):
    """K7's source with four stamps a block; ``variant`` "no_products"
    skips the wgmma calls, "no_halo_loads" fills the halo from registers."""
    edits = [
        ("  const int tid = threadIdx.x, grp = tid >> 7;\n", _stamp(0)),
        ("    quantize_halo(As, x, n, y0, H, W, C, c0, CG, TR, inv, tid);\n"
         "    __syncthreads();\n", "    if (c0 == 0) {\n" + _stamp(1)
         + "    }\n"),
        ("  // epilogue: accumulator rows 16 warp + g (+ 8), columns 8 j + "
         "2 t (+ 1)\n", None),
        ("  if (out_amax != nullptr) fold_amax(amax, out_amax);\n}", None),
    ]
    for anchor, after in edits:
        if anchor not in src:
            raise RuntimeError(f"the K7 source changed: {anchor!r}")
        if after is not None:
            src = src.replace(anchor, anchor + after, 1)
    src = src.replace(edits[2][0], _stamp(2) + edits[2][0], 1)
    src = src.replace(edits[3][0], edits[3][0][:-1] + _stamp(3) + "}", 1)
    if variant == "no_products":
        src = src.replace("        wgmma_m64n128k32_s8_rs(acc, a[k],",
                          "        if (H < 0) wgmma_m64n128k32_s8_rs(acc, "
                          "a[k],", 1)
    if variant == "no_halo_loads":
        src = src.replace("raw[b][k] = inside ? src[k] : make_uint4(0u, 0u, "
                          "0u, 0u);", "raw[b][k] = make_uint4(0x3f803f80u, "
                          "0u, 0u, (unsigned)pix);", 1)
    src = src.replace("namespace {", "__device__ unsigned long long "
                      "g_stamps[4096 * 4];\nnamespace {", 1)
    return src + ('\nextern "C" int micro_k7_stamps(void* host) {\n  return '
                  '(int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));'
                  '\n}\n')


def phases(gen, iters):
    out_dir = os.path.join(_build.BUILD_DIR, "micro_k7")
    os.makedirs(out_dir, exist_ok=True)
    for h in glob.glob(os.path.join(_build.CSRC_DIR, "*.cuh")):
        with open(h) as f, open(os.path.join(out_dir, os.path.basename(h)),
                                "w") as g:
            g.write(f.read())
    with open(_build.source_path("conv3x3_int8")) as f:
        src = f.read()
    rows = []
    for variant in ("as_is", "no_products", "no_halo_loads"):
        path = os.path.join(out_dir, f"k7_{variant}.cu")
        with open(path, "w") as f:
            f.write(_timed_source(src, variant))
        lib_path = path[:-3] + ".so"
        proc = subprocess.run(
            [_build.nvcc(), *[a for a in _build.NVCC_FLAGS
                              if a != "-Xptxas=-v"], "-o", lib_path, path],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
        lib = ctypes.CDLL(lib_path)
        fn = lib.cobevt_conv3x3_int8
        fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
        for shape in SHAPES:
            N, H, W, C, _ = shape
            x, p, r, slot = operands(shape, False, gen)
            plan = int8_tile_plan(H, W, C)
            run = launcher(fn, shape, x, p, r, slot, torch.empty_like(x),
                           plan.stages)
            ms = device_ms(run, iters)
            run()
            torch.cuda.synchronize()
            host = (ctypes.c_ulonglong * (4096 * 4))()
            _build.check(lib.micro_k7_stamps(host), "micro_k7 stamps")
            blocks = N * -(-H // plan.rows) * -(-C // 128)
            t = np.frombuffer(host, np.uint64).reshape(4096, 4)[:blocks]
            t = t.astype(np.int64) - int(t[:, 0].min())
            row = {"variant": variant, "shape": shape[:4], "alone_ms": ms,
                   "blocks": blocks, "span_us": float(t[:, 3].max()) / 1e3,
                   "prologue_us": float((t[:, 1] - t[:, 0]).mean()) / 1e3,
                   "products_us": float((t[:, 2] - t[:, 1]).mean()) / 1e3,
                   "epilogue_us": float((t[:, 3] - t[:, 2]).mean()) / 1e3}
            rows.append(row)
            print(f"K7 phases {shape[:4]} {variant:>13}: {ms * 1e3:.1f} us "
                  f"a launch, {blocks} blocks; a block: first halo tile "
                  f"{row['prologue_us']:.1f} us, products "
                  f"{row['products_us']:.1f}, epilogue "
                  f"{row['epilogue_us']:.1f}", flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", action="store_true",
                   help="also time each phase of a block in timer builds")
    p.add_argument("--iters", type=int, default=20)
    opt = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("micro_k7: needs a CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"depths": depths(gen, opt.iters),
              "device": torch.cuda.get_device_name(0)}
    if opt.phases:
        result["phases"] = phases(gen, opt.iters)
    print(json.dumps(result))
    bad = [r for r in result["depths"] if not r["equal"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
