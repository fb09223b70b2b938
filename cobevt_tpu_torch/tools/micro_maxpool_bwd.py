"""Micro: the ResNet stem's maxpool backward, ATen's against argmax routing.

Counterpart of ``cobevt_tpu/tools/micro_maxpool_bwd.py``, at its shape: the
stem pool of a CorpBEVT frame, (20, 256, 256, 64) in bf16 NHWC pooled 3x3,
stride 2, padding 1 to (20, 128, 128, 64).

  python -m cobevt_tpu_torch.tools.micro_maxpool_bwd [--iters 10]
  python -m cobevt_tpu_torch.tools.micro_maxpool_bwd --device cpu \\
      --shape 2,16,16,8

  * ``pool_plain``: ``F.max_pool2d(3, 2, 1)`` under autograd on the
    channels-last view, as the port's stem runs it (``nn/resnet.py``); its
    backward is ATen's max-pool backward, routed by the indices the forward
    saved (the JAX tool's ``pool_xla`` :31, select-and-scatter there).
  * ``pool_routed``: the JAX tool's ``pool_routed`` (:57-83) as a
    ``torch.autograd.Function``: the forward takes the max and the winning
    tap over the 9 shifted slices of the -inf-padded input (the first tap in
    row-major order on a tie, as both ATen and select-and-scatter pick), the
    backward routes ``dy`` to that tap with 9 masked adds into strided views
    of a padded gradient (the pad-adds of :66-80; no scatter), accumulated
    in f32 and cast once, as ATen's backward accumulates.  Its shapes come
    from the input.

Prints the largest |difference| between the two input gradients of the
JAX tool's loss ``sum(f32(pool(x))^2)`` (they must be equal) and each
version's forward + backward ms on the card alone
(``tools/timing.py:device_ms``, after one warmup call; the JAX tool's
scan-chain differencing has no counterpart here), then one JSON line.
Exits non-zero when the gradients differ.  ``--device cpu`` checks the
parity at ``--shape`` and reports no time.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

SHAPE = (20, 256, 256, 64)


def pool_plain(x):
    """The stem's pool of an NHWC tensor (``nn/resnet.py``)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def _taps(x):
    """The 9 (dy, dx) taps of every 3x3 stride-2 window of the -inf-padded
    NHWC ``x``, each (B, Ho, Wo, C), in row-major tap order."""
    _, H, W, _ = x.shape
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=float("-inf"))
    return [xp[:, dy:dy + 2 * Ho - 1:2, dx:dx + 2 * Wo - 1:2]
            for dy in range(3) for dx in range(3)]


class _RoutedPool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        stack = torch.stack(_taps(x))                     # (9, B, Ho, Wo, C)
        out = stack.amax(dim=0)
        # the first tap that holds the maximum
        win = (stack == out).to(torch.uint8).argmax(dim=0).to(torch.int8)
        ctx.save_for_backward(win)
        ctx.x_shape = x.shape
        return out

    @staticmethod
    def backward(ctx, g):
        (win,) = ctx.saved_tensors
        B, H, W, C = ctx.x_shape
        Ho, Wo = win.shape[1:3]
        dxp = torch.zeros((B, H + 2, W + 2, C), dtype=torch.float32,
                          device=g.device)
        gf = g.float()
        for t in range(9):
            dy, dx = divmod(t, 3)
            dxp[:, dy:dy + 2 * Ho - 1:2, dx:dx + 2 * Wo - 1:2] += torch.where(
                win == t, gf, 0.0)
        return dxp[:, 1:H + 1, 1:W + 1].to(g.dtype)


def pool_routed(x):
    return _RoutedPool.apply(x)


def loss(pool, x):
    """The JAX tool's loss: sum of the squared pool in f32."""
    return (pool(x).float() ** 2).sum()


def grad(pool, x):
    x = x.detach().requires_grad_(True)
    return torch.autograd.grad(loss(pool, x), x)[0]


def run(device, shape=SHAPE, dtype=torch.bfloat16, iters=10) -> dict:
    """The gradient parity and, on a card, each version's fwd + bwd ms."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device,
                                                                  dtype)
    ga, gb = grad(pool_plain, x), grad(pool_routed, x)
    diff = (ga.float() - gb.float()).abs()
    out = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "grad_max_abs": float(diff.max()),
           "grad_values_differing": int((diff > 0).sum()),
           "grad_equal": bool(torch.equal(ga, gb)),
           "forward_equal": bool(torch.equal(pool_plain(x), pool_routed(x)))}
    if device.type == "cuda" and iters:
        from cobevt_tpu_torch.tools.timing import device_ms
        out["plain_ms"] = device_ms(lambda: grad(pool_plain, x), iters)
        out["routed_ms"] = device_ms(lambda: grad(pool_routed, x), iters)
        out["routed_over_plain"] = out["routed_ms"] / out["plain_ms"]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--shape", default=",".join(map(str, SHAPE)),
                   help="B,H,W,C of the pooled input")
    opt = p.parse_args(argv)
    shape = tuple(int(v) for v in opt.shape.split(","))
    out = run(torch.device(opt.device), shape, iters=opt.iters)
    print(f"grad parity max abs: {out['grad_max_abs']}")
    for name in ("plain", "routed"):
        if f"{name}_ms" in out:
            print(f"{name:8s} {out[f'{name}_ms']:8.3f} ms fwd+bwd")
    print(json.dumps(out))
    return 0 if out["grad_equal"] and out["forward_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
