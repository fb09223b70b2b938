"""Micro: the int8 chain's conv (``ops/int8_chain.py:conv3x3_s8``) at the
three layer1 convs of an int8 frame, by phase of a block.

  python -m cobevt_tpu_torch.tools.micro_s8

Times each conv on the card alone (launches queued behind a sleep kernel)
on the kernel the wrapper picks (the strip kernel at layer1), then builds a
copy of its source into the build directory whose blocks stamp the global
timer (``S8_PHASES_BEGIN`` / ``S8_MARK`` / ``S8_PHASES_END`` of
``csrc/conv3x3_int8.cu``) and prints the mean time a block spends waiting
for its halo and residual rows (and, first, its weight), in products
(ldmatrix and wgmma) and in the epilogue (rescale, residual, ReLU,
requantize or cast, the staged store), beside the block's span; the copy's
output must equal the wrapper's bit for bit.  One JSON line at the end.
Needs a CUDA card.
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
from cobevt_tpu_torch.ops.int8_chain import (
    _OUT_KINDS,
    conv3x3_s8,
    pack_s8_weight,
    quantize_dynamic,
    s8_plan,
)
from cobevt_tpu_torch.tools.timing import device_ms

SHAPE = (20, 128, 128, 64)
# (name, residual, exit, convs an int8 frame)
CASES = [("conv1", False, False, 3), ("conv2", True, False, 2),
         ("conv2_exit", True, True, 1)]
MAX_BLOCKS = 4096
TIMERS = f"""
__device__ unsigned long long g_s8_phases[{MAX_BLOCKS} * 4];
__device__ __forceinline__ unsigned long long s8_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define S8_PHASES_BEGIN                                   \\
  unsigned long long s8_acc[3] = {{0ull, 0ull, 0ull}};    \\
  const unsigned long long s8_t0 = s8_now();              \\
  unsigned long long s8_last = s8_t0;
#define S8_MARK(phase)                                    \\
  {{                                                      \\
    const unsigned long long t_ = s8_now();               \\
    s8_acc[phase] += t_ - s8_last;                        \\
    s8_last = t_;                                         \\
  }}
#define S8_PHASES_END                                     \\
  if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) {{   \\
    unsigned long long* g_ = g_s8_phases + blockIdx.x * 4; \\
    g_[0] = s8_acc[0];                                    \\
    g_[1] = s8_acc[1];                                    \\
    g_[2] = s8_acc[2];                                    \\
    g_[3] = s8_last - s8_t0;                              \\
  }}
"""


def operands(gen):
    N, H, W, C = SHAPE
    xq, sx = quantize_dynamic(
        torch.randn(N, H, W, C, generator=gen, device="cuda").relu())
    rq, rs = quantize_dynamic(
        torch.randn(N, H, W, C, generator=gen, device="cuda").relu())
    w = torch.randn(3, 3, C, C, generator=gen, device="cuda") * (
        2 / (9 * C)) ** 0.5
    p = pack_s8_weight(w, torch.randn(C, generator=gen, device="cuda") * 0.1)
    return xq, sx, rq, rs, p


def timed_library():
    """The chain conv's source with the phase timers, built beside the
    library; returns (its C entry, the stamps reader)."""
    out_dir = os.path.join(_build.BUILD_DIR, "micro_s8")
    os.makedirs(out_dir, exist_ok=True)
    for h in glob.glob(os.path.join(_build.CSRC_DIR, "*.cuh")):
        with open(h) as f, open(os.path.join(out_dir, os.path.basename(h)),
                                "w") as g:
            g.write(f.read())
    with open(_build.source_path("conv3x3_int8")) as f:
        src = f.read()
    path = os.path.join(out_dir, "s8_phases.cu")
    with open(path, "w") as f:
        f.write(TIMERS + src + '\nextern "C" int micro_s8_stamps(void* host) '
                '{\n  return (int)cudaMemcpyFromSymbol(host, g_s8_phases, '
                'sizeof(g_s8_phases));\n}\n')
    lib_path = path[:-3] + ".so"
    proc = subprocess.run(
        [_build.nvcc(), *[a for a in _build.NVCC_FLAGS if a != "-Xptxas=-v"],
         "-o", lib_path, path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    fn = lib.cobevt_conv3x3_s8
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, lib.micro_s8_stamps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    opt = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("micro_s8: needs a CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    xq, sx, rq, rs, pk = operands(gen)
    N, H, W, C = SHAPE
    dev = xq.device
    plan = s8_plan(N, H, W, C, C, torch.cuda.get_device_properties(dev)
                   .multi_processor_count)
    fn, stamps = timed_library()
    rows = []
    for name, residual, leaves, per_frame in CASES:
        kwargs = {"out_dtype": torch.bfloat16}
        if residual:
            kwargs.update(residual_q=rq, residual_scale=rs)
        if not leaves:
            kwargs["out_scale"] = sx * 2.0

        def wrapped():
            return conv3x3_s8(xq, sx, pk.w_q, pk.s_w, pk.shift, wt=pk.wt,
                              **kwargs)

        want = wrapped()
        ms = device_ms(wrapped, opt.iters)
        # the timed copy on the same operands, as the wrapper calls it
        out = torch.empty_like(want)
        scale = (sx * pk.s_w).float().contiguous()
        res_s = rs.reshape(1).float() if residual else None
        out_s = (sx * 2.0).reshape(1).float() if not leaves else None
        err = fn(xq.data_ptr(), pk.wt.data_ptr(), scale.data_ptr(),
                 pk.shift.data_ptr(), rq.data_ptr() if residual else None,
                 None if res_s is None else res_s.data_ptr(), out.data_ptr(),
                 None if out_s is None else out_s.data_ptr(), None, N, H, W,
                 C, C, 1, _OUT_KINDS[out.dtype], plan.rows, plan.blocks,
                 dev.index, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "micro_s8 timed conv")
        torch.cuda.synchronize()
        host = (ctypes.c_ulonglong * (MAX_BLOCKS * 4))()
        _build.check(stamps(host), "micro_s8 stamps")
        t = np.frombuffer(host, np.uint64).reshape(MAX_BLOCKS, 4)[
            :plan.blocks].astype(np.float64) / 1e3
        row = {"case": name, "per_frame": per_frame, "alone_ms": ms,
               "blocks": plan.blocks, "strip_rows": plan.rows,
               "wait_us": float(t[:, 0].mean()),
               "products_us": float(t[:, 1].mean()),
               "epilogue_us": float(t[:, 2].mean()),
               "span_us": float(t[:, 3].mean()),
               "equal": bool(torch.equal(out, want))}
        rows.append(row)
        print(f"S8 {name:>10}: {ms * 1e3:.1f} us alone, {plan.blocks} "
              f"blocks of {plan.rows} rows; a block: waiting for rows "
              f"{row['wait_us']:.1f} us, products {row['products_us']:.1f}, "
              f"epilogue {row['epilogue_us']:.1f}, span {row['span_us']:.1f}"
              f"; timed copy equal={row['equal']}", flush=True)
    frame = sum(r["alone_ms"] * r["per_frame"] for r in rows)
    print(json.dumps({"cases": rows, "frame_alone_ms": frame,
                      "device": torch.cuda.get_device_name(0)}))
    return 0 if all(r["equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
