"""Micro: the fused PreNorm feed-forward pair, K11 + K12, against autograd.

Counterpart of ``cobevt_tpu/tools/micro_ffd_fused.py``: the feed-forward
sublayer of FuseBEVT (LN -> W1 -> GELU -> W2 -> + residual) at the
cooperative-LiDAR fusion token count (84480 x 256, hidden 512, bf16), as the
fused forward with its recompute backward (``ops/ffd_fused.py``) and as
PyTorch autograd over the plain chain of library calls.

  python -m cobevt_tpu_torch.tools.micro_ffd_fused
  python -m cobevt_tpu_torch.tools.micro_ffd_fused --device cpu

Operands are the JAX tool's: ``numpy.random.RandomState(0)``, the same draws
in the same order.  Prints the parity of the fused pair against the erf
oracle (``ref_ffd``: exact erf, library products) as the JAX tool does: the
forward's largest relative error, then the relative L2 error of each of the
seven gradients of ``sum(out ** 2)``; then, on a card, the forward + backward
time of both (CUDA events after warmup, fused, autograd, autograd, fused in
one call), and one JSON line; ``--profile_steps N`` adds the device time of
N fused passes by kernel (``torch.profiler``).  Exits non-zero when a parity figure leaves its
tolerance.  In f32: 2e-3 for the forward's largest relative error (its
denominator is |out| + 1e-3, so the polynomial's 1.5e-7 and f32 sums in
another order show as ~5e-4 where out passes zero), 1e-4 for the forward's
and every gradient's relative L2 error.  In bf16 the oracle rounds h to bf16
where the fused body keeps it in f32 and every cast is a rounding of 2^-9:
3e-2 relative L2 for the forward and each gradient; the largest relative
error is printed and not held (an output that passes zero makes it
arbitrary).  Needs a CUDA card unless ``--device cpu`` is given; a CPU run
checks the plain versions at 1024 x 256 x 512 in f32 and reports no time.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from cobevt_tpu_torch.ops.ffd_fused import EPS, fused_ffd

CHIP_SHAPE = (84480, 256, 512)      # 5 x 96 x 176 fusion tokens
CPU_SHAPE = (1024, 256, 512)
GRAD_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
# (forward max rel or None, relative L2 of the forward and each gradient)
TOLERANCE = {torch.float32: (2e-3, 1e-4), torch.bfloat16: (None, 3e-2)}


def make_operands(N, D, M, dtype, device):
    """x, gamma, beta, w1, b1, w2, b2 of the JAX tool."""
    rng = np.random.RandomState(0)
    draws = (
        (rng.randn(N, D) * 0.3, dtype), (rng.rand(D) + 0.5, torch.float32),
        (rng.randn(D) * 0.1, torch.float32), (rng.randn(D, M) * 0.05, dtype),
        (rng.randn(M) * 0.1, torch.float32), (rng.randn(M, D) * 0.05, dtype),
        (rng.randn(D) * 0.1, torch.float32))
    return tuple(torch.as_tensor(a, dtype=torch.float32).to(dt).to(device)
                 for a, dt in draws)


def ref_ffd(x, gamma, beta, w1, b1, w2, b2):
    """The oracle and the timing baseline: the same sublayer from library
    calls (exact erf; products in x's dtype with the library's
    accumulation), ``ref_ffd`` of the JAX tool."""
    t = F.layer_norm(x.float(), x.shape[-1:], gamma, beta, EPS).to(x.dtype)
    h = (t @ w1).float() + b1
    a = F.gelu(h).to(x.dtype)
    y = (a @ w2).float() + b2
    return (x.float() + y).to(x.dtype)


def loss_and_grads(fn, operands):
    leaves = [t.detach().clone().requires_grad_(True) for t in operands]
    out = fn(*leaves)
    (out.float() ** 2).sum().backward()
    return out.detach(), [t.grad for t in leaves]


def parity(operands, impl=None):
    """{"fwd_max_rel", "dx", ...}: the fused pair against the oracle."""
    of, gf = loss_and_grads(lambda *a: fused_ffd(*a, impl=impl), operands)
    orf, gr = loss_and_grads(ref_ffd, operands)
    of, orf = of.float(), orf.float()
    figures = {"fwd_max_rel": float(((of - orf).abs()
                                     / (orf.abs() + 1e-3)).max()),
               "fwd_rel_l2": float(torch.linalg.norm(of - orf)
                                   / (torch.linalg.norm(orf) + 1e-9))}
    for name, a, b in zip(GRAD_NAMES, gf, gr):
        a, b = a.float(), b.float()
        figures[name] = float(torch.linalg.norm(a - b)
                              / (torch.linalg.norm(b) + 1e-9))
    return figures


def time_fwd_bwd(fn, operands, dy, iters, warmup=3):
    """ms of one forward + backward (all seven gradients), CUDA events."""
    leaves = [t.detach().clone().requires_grad_(True) for t in operands]

    def once():
        for t in leaves:
            t.grad = None
        fn(*leaves).backward(dy)

    for _ in range(warmup):
        once()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        once()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--rows", type=int, default=None,
                   help="token rows instead of the shape's own")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="also trace this many fused forward + backward "
                        "passes with torch.profiler")
    p.add_argument("--device", default=None,
                   help="cuda (default; required unless this says cpu)")
    opt = p.parse_args(argv)
    if opt.device is None:
        if not torch.cuda.is_available():
            print("micro_ffd_fused: no CUDA device; pass --device cpu to "
                  "check the plain versions on the CPU", file=sys.stderr)
            return 1
        opt.device = "cuda"
    device = torch.device(opt.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    on_card = device.type == "cuda"
    N, D, M = CHIP_SHAPE if on_card else CPU_SHAPE
    N = N if opt.rows is None else opt.rows
    dtype = torch.bfloat16 if on_card else torch.float32
    operands = make_operands(N, D, M, dtype, device)

    figures = parity(operands)
    print(f"fwd max rel: {figures['fwd_max_rel']:.3e}  "
          f"(rel L2 {figures['fwd_rel_l2']:.2e})")
    for name in GRAD_NAMES:
        print(f"  {name:7s} rel {figures[name]:.2e}")
    tol_max, tol_l2 = TOLERANCE[dtype]
    ok = all(figures[n] <= tol_l2 for n in ("fwd_rel_l2",) + GRAD_NAMES)
    if tol_max is not None:
        ok = ok and figures["fwd_max_rel"] <= tol_max
    row = {"ok": ok, "shape": [N, D, M],
           "dtype": str(dtype).replace("torch.", ""),
           "tolerance": {"fwd_max_rel": tol_max, "rel_l2": tol_l2},
           "parity": figures,
           "device": torch.cuda.get_device_name(device) if on_card else "cpu",
           "clock": "CUDA events" if on_card else None}
    if on_card:
        dy = torch.randn(N, D, device=device,
                         generator=torch.Generator(device).manual_seed(1)
                         ).to(dtype)
        order = (("fused", fused_ffd), ("autograd", ref_ffd),
                 ("autograd", ref_ffd), ("fused", fused_ffd))
        times = {"fused": [], "autograd": []}
        for name, fn in order:
            times[name].append(time_fwd_bwd(fn, operands, dy, opt.iters))
        row["fused_fwd_bwd_ms"] = times["fused"]
        row["autograd_fwd_bwd_ms"] = times["autograd"]
        fused, auto = min(times["fused"]), min(times["autograd"])
        print(f"autograd fwd+bwd: {auto:.3f} ms")
        print(f"fused    fwd+bwd: {fused:.3f} ms  ({auto / fused:.2f}x)")
        if opt.profile_steps:
            from cobevt_tpu_torch.tools.benchmark import profile_steps
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in operands]
            row["profile"] = profile_steps(
                lambda: fused_ffd(*leaves).backward(dy), opt.profile_steps,
                fused)
    print(json.dumps(row))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
