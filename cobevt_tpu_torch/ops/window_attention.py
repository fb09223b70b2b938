"""Packed window attention (K1): wrapper, plain version and CUDA launch.

Counterpart of ``cobevt_tpu/ops/window_attention.py:
fused_window_attention_packed``.  One kernel serves the three attention
flavours of the CorpBEVT forward:

  * ``CrossWinAttention`` (no bias, no mask)   -- models/fax.py
  * ``SelfAttention``     (2D rel-pos bias)    -- models/fax.py
  * ``FusionAttention``   (3D bias + key mask) -- models/fusion/swap_fusion.py

The TPU kernel groups heads into 128-channel chunks to fill the MXU
(``_fwa_packed_jit``); that is the same math and has no counterpart here:
the CUDA kernel (``csrc/window_attention.cu``) runs one block per
(window, head, query tile).
"""

from __future__ import annotations

import ctypes

import torch

from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.dispatch import check_operand, resolve_impl

NEG_INF = -1e9

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_HEAD_DIMS = (16, 32)


def _packed_to_4d(t, n_heads):
    G, T, C = t.shape
    return t.reshape(G, T, n_heads, C // n_heads).permute(0, 2, 1, 3)


def _packed_from_4d(t):
    G, H, T, D = t.shape
    return t.permute(0, 2, 1, 3).reshape(G, T, H * D)


def _flat_to_heads(bias_flat, n_heads):
    """(Tq, H*Tk) flat bias -> (H, Tq, Tk)."""
    Tq, HTk = bias_flat.shape
    return bias_flat.reshape(Tq, n_heads, HTk // n_heads).permute(1, 0, 2)


def _weight_to_4d(weight, n_heads):
    """(G, Tq, H*Tk) flat post-softmax weights -> (G, H, Tq, Tk)."""
    G, Tq, HTk = weight.shape
    return weight.reshape(G, Tq, n_heads,
                          HTk // n_heads).permute(0, 2, 1, 3)


def packed_attention_reference(q, k, v, n_heads, bias_flat=None, mask=None,
                               weight=None):
    """Plain PyTorch version of K1 (the JAX ``_xla_packed_reference``):
    products and softmax in f32 from the inputs' values, output in q's
    dtype."""
    q4, k4, v4 = (_packed_to_4d(t, n_heads).float() for t in (q, k, v))
    sim = torch.einsum("ghqd,ghkd->ghqk", q4, k4)
    if bias_flat is not None:
        sim = sim + _flat_to_heads(bias_flat.float(), n_heads)[None]
    if mask is not None:
        sim = sim + torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF)
    attn = torch.softmax(sim, dim=-1)
    if weight is not None:
        attn = attn * _weight_to_4d(weight, n_heads).float()
    out = torch.einsum("ghqk,ghkd->ghqd", attn, v4)
    return _packed_from_4d(out).to(q.dtype)


def _lib():
    lib = _build.load("window_attention")
    fn = lib.cobevt_window_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_kernel(q, k, v, n_heads, bias_flat, mask, weight):
    G, Tq, C = q.shape
    Tk = k.shape[1]
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"K1 takes {_KERNEL_DTYPES}, got {q.dtype}")
    if C % n_heads or C // n_heads not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"K1 takes head dims {_KERNEL_HEAD_DIMS}; got "
                         f"C={C} over {n_heads} heads")
    if Tq % 8 or Tk % 8:
        raise ValueError(f"K1 takes Tq, Tk multiples of 8; got {Tq}, {Tk}")
    dev = q.device
    check_operand("q", q, (G, Tq, C), q.dtype, dev)
    check_operand("k", k, (G, Tk, C), q.dtype, dev)
    check_operand("v", v, (G, Tk, C), q.dtype, dev)
    HTk = n_heads * Tk
    if bias_flat is not None:
        check_operand("bias_flat", bias_flat, (Tq, HTk), torch.float32, dev)
    if mask is not None:
        check_operand("mask", mask, (G, Tk), torch.float32, dev)
    if weight is not None:
        check_operand("weight", weight, (G, Tq, HTk), q.dtype, dev)
    out = torch.empty_like(q)
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias_flat is None else bias_flat.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if weight is None else weight.data_ptr(),
        out.data_ptr(), G, Tq, Tk, n_heads, C // n_heads,
        int(q.dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "window_attention")
    fused_window_attention_packed.launches += 1
    return out


def fused_window_attention_packed(q, k, v, n_heads: int, bias_flat=None,
                                  mask=None, weight=None, impl=None):
    """Packed-layout attention: q (G, Tq, H*D) pre-scaled, k/v
    (G, Tk, H*D) with heads interleaved in the channel axis; bias_flat
    (Tq, H*Tk) f32 with column block h holding head h's bias, or None;
    mask (G, Tk) (keys with mask <= 0 get -1e9 added), or None; weight
    (G, Tq, H*Tk) post-softmax multiplicative weights that scale the
    numerator only (attention dropout), or None.  Returns (G, Tq, H*D) in
    q's dtype.

    ``impl``: None (kernel for CUDA tensors, plain version for CPU
    tensors), "kernel" or "torch".  The kernel path takes contiguous
    tensors, casts bias and mask to f32 and weight to q's dtype."""
    if weight is not None and mask is not None:
        raise ValueError("weight+mask combination not implemented")
    if resolve_impl(impl, q) == "torch":
        return packed_attention_reference(q, k, v, n_heads, bias_flat, mask,
                                          weight)
    if bias_flat is not None:
        bias_flat = bias_flat.float().contiguous()
    if mask is not None:
        mask = mask.float().contiguous()
    if weight is not None:
        weight = weight.to(q.dtype).contiguous()
    return _launch_kernel(q, k, v, n_heads, bias_flat, mask, weight)


# kernel launches since the last reset (plain-version calls do not count)
fused_window_attention_packed.launches = 0
