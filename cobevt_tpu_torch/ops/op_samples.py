"""Small operands for every ``cobevt::`` custom op, for
``torch.library.opcheck``: one shape each that the plain version and the
CUDA kernel both take (f32, so the kernels' scalar and row routes), drawn
from a seeded ``torch.Generator`` on the given device.

  from torch.library import opcheck
  for name, args in sample_args("cpu").items():
      opcheck(KERNEL_OPS[name].custom_op, args)
"""

from __future__ import annotations

import torch

from cobevt_tpu_torch.ops.conv2d import fold_amax_, pack_int8_weight
from cobevt_tpu_torch.ops.fused_cross_attention import (
    flat_params,
    pack_params,
)
from cobevt_tpu_torch.ops.fused_swap_fusion import HEAD_KEYS, flat_layers
from cobevt_tpu_torch.ops.fused_swap_fusion import pack as pack_fusion
from cobevt_tpu_torch.ops.int8_chain import pack_s8_weight, quantize_dynamic


def sample_args(device, seed: int = 0) -> dict:
    """{op name: its positional arguments} on ``device``."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    def ln(d):
        return (torch.rand(d, generator=gen).to(device) + 0.5,
                randn(d, scale=0.1))

    out = {}
    # K1: 2 windows x 16 queries and keys, 2 heads of 16, bias and mask
    G, T, H, D = 2, 16, 2, 16
    mask = (torch.rand((G, T), generator=gen) > 0.3).float().to(device)
    mask[:, 0] = 1.0
    out["window_attention_packed"] = (
        randn(G, T, H * D, scale=0.25), randn(G, T, H * D),
        randn(G, T, H * D), H, randn(T, H * T), mask, None, None)
    # K5: its backward at the same shapes (the output's gradient g and the
    # output drawn; the kernel takes its own row statistics)
    out["window_attention_packed_bwd"] = (
        randn(G, T, H * D, scale=0.25), randn(G, T, H * D),
        randn(G, T, H * D), randn(G, T, H * D), randn(G, T, H * D), H,
        randn(T, H * T), mask, None)
    # K8: the same shapes head-major
    out["window_attention"] = (
        randn(G, H, T, D, scale=0.25), randn(G, H, T, D), randn(G, H, T, D),
        randn(H, T, T), mask)

    # K2: B 1, 2 cameras, BEV 4 x 4 of width 32 in 2 x 2 windows, 2 heads of
    # 16, keys 4 x 4 in 2 x 2 windows (8 keys a window), MLP and post-LN
    B, n, S, Dm, C = 1, 2, 4, 32, 32

    def dense(i, o):
        return randn(i, o, scale=0.1)

    params = dict(ln_q=ln(Dm), ln_k=ln(Dm), ln_v=ln(Dm), wq=dense(Dm, C),
                  bq=randn(C, scale=0.1), wk=dense(Dm, C),
                  bk=randn(C, scale=0.1), wv=dense(Dm, C),
                  bv=randn(C, scale=0.1), wo=dense(C, Dm),
                  bo=randn(Dm, scale=0.1))
    mlp = {"ln": ln(Dm), "w1": dense(Dm, 2 * Dm), "b1": randn(2 * Dm),
           "w2": dense(2 * Dm, Dm), "b2": randn(Dm)}
    packed = pack_params(params, mlp, ln(Dm), torch.float32)
    out["cross_view_attention"] = (
        randn(B, S, S, Dm), randn(S, S, Dm), randn(B, n, Dm),
        randn(B, n, S, S, Dm), randn(B, n, S, S, Dm), flat_params(packed),
        [2, 2], [2, 2], 2, 16.0 ** -0.5, True, False)

    # K3: 16 -> 8 channels on a 4 x 4 map with a residual
    out["conv3x3"] = (randn(1, 4, 4, 16), randn(3, 3, 16, 8, scale=0.1), None,
                      randn(8, scale=0.1), randn(1, 4, 4, 8), True)

    # K4 (width 32, heads of 16) and K6 (width 64): 2 agents on 4 x 4 maps,
    # windows of 2, one block, mlp 64
    def fusion(Df, heads, bias_dtype):
        T = 2 * 2 * 2

        def sub():
            return {"ln_a": ln(Df), "wqkv": dense(Df, 3 * Df),
                    "wout": dense(Df, Df), "ln_f": ln(Df),
                    "w1": dense(Df, 64), "b1": randn(64, scale=0.1),
                    "w2": dense(64, Df), "b2": randn(Df, scale=0.1)}

        p = pack_fusion([(sub(), sub())], randn(1, 2, T, heads * T),
                        {"ln": ln(Df), "w": dense(Df, Df), "b": randn(Df)},
                        torch.float32, bias_dtype)
        fmask = (torch.rand((1, 2, 4, 4), generator=gen) > 0.3).float()
        fmask[:, 0] = 1.0
        return randn(1, 2, 4, 4, Df), fmask.to(device), p

    x, fmask, p = fusion(32, 2, torch.float32)
    out["swap_fusion"] = (x, fmask, torch.ones((1, 2), device=device), p.bias,
                          flat_layers(p.layers),
                          [p.head[k] for k in HEAD_KEYS], 2, 2, True)
    x, fmask, p = fusion(64, 4, torch.float32)
    out["swap_fusion_streaming"] = (x, fmask, p.bias, flat_layers(p.layers),
                                    2, 4)

    # K7 and the absmax: 64 -> 8 channels on a 4 x 4 map, the input's |max|
    # in a slot, the output's folded into another
    x = randn(1, 4, 4, 64)
    w8 = pack_int8_weight(randn(3, 3, 64, 8, scale=0.1), randn(8, scale=0.1))
    slot = fold_amax_(torch.zeros(1, dtype=torch.int32, device=device), x)
    out["conv3x3_int8"] = (x, w8.wt, w8.s_w, w8.shift, slot,
                           randn(1, 4, 4, 8), True,
                           torch.zeros(1, dtype=torch.int32, device=device))
    out["int8_absmax"] = (x, torch.zeros(1, dtype=torch.int32, device=device))

    # the int8 chain's conv: int8 in and out at given scales, a residual
    xq, sx = quantize_dynamic(x)
    s8 = pack_s8_weight(randn(3, 3, 64, 8, scale=0.1), randn(8, scale=0.1))
    rq, rs = quantize_dynamic(randn(1, 4, 4, 8))
    out["conv3x3_s8"] = (xq, sx, s8.wt, s8.s_w, s8.shift, True, sx * 2.0, rq,
                         rs, torch.int8, True)
    return out
