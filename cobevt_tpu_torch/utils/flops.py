"""FLOPs / bytes / MFU / HBM share for the benchmark rows, and every hand
kernel's work formula.

Counterpart of ``cobevt_tpu/utils/flops.py``, with its public names:
``device_peak_flops``, ``device_peak_hbm`` (and the ``COBEVT_PEAK_TFLOPS``
/ ``COBEVT_PEAK_HBM_GBS`` overrides), ``mfu``, ``hbm_util`` and
``utilization`` with its ``hbm_flag``.  MFU is achieved FLOP/s over the
card's peak bf16 FLOP/s; hbm_util achieved bytes/s over its peak memory
rate.

The JAX package reads both numerators from XLA's cost analysis of the
compiled program (``compiled_costs``).  Eager PyTorch has no compiled
program, so :func:`costs` counts one untimed call at the dispatcher:

* the products of aten ops through ``torch.utils.flop_counter.
  FlopCounterMode`` (a multiply-add is 2 FLOPs, as XLA counts);
* each ``cobevt::`` kernel op through the formula registered on it
  (``ops/dispatch.py:KernelOp``, ``register_flop_formula``): the products of
  its plain version, from the operands' shapes.  The plain version inside
  the op runs below the counter and is never counted on top of it;
* bytes: the logical operand and output bytes of every op that launches
  work (views and allocations excluded), and a kernel op's bytes from its
  formula (each input read once, each output written once).

So a call counts the same FLOPs on the card and on the CPU, and on the
kernel path and the plain path (``forced_impl("torch")``): the work does
not change with what implements a kernel.  Bytes do: the plain path writes
every intermediate that a kernel keeps on chip.  As XLA counts them,
``flops`` holds every product, the int8 ones too; ``int8_ops`` is the part
of it that a kernel computes in int8 (K7, the int8 chain's conv).  Like
XLA's logical bytes, ``bytes`` can exceed what the bus moved (an operand
read from L2 counts again), so ``utilization`` flags an ``hbm_util`` above
1; ``tools/parse_trace.py --bandwidth`` is the trace's meter.

The same formulas give ``chip_smoke.py``'s bounds (:func:`bound`): the
least time the card could take for a kernel's work, the larger of its bytes
over the memory rate and its operations over the peak rate of their type.
"""

from __future__ import annotations

import os
from typing import Optional

# Published peaks of the NVIDIA H100 SXM (NVIDIA's data sheet: dense rates,
# at the 700 W power limit), keyed by torch.cuda.get_device_name.  Dense
# bf16 products (f32 accumulate), and int8 products (about 2x, as for the
# JAX package's TPUs).
H100 = "NVIDIA H100 80GB HBM3"
_PEAK_BF16 = {H100: 989e12}
_PEAK_INT8 = {H100: 1979e12}
# Peak device-memory bandwidth (bytes/s) by device name.
_PEAK_HBM = {H100: 3.35e12}

# The bounds' peaks (the H100 SXM): memory rate, and operations a second by
# the type of the operands (67 TFLOP/s: f32 outside the tensor cores)
PEAK_BYTES_PER_S = _PEAK_HBM[H100]
PEAK_FLOPS = {"bfloat16": _PEAK_BF16[H100], "float32": 67e12,
              "int8": _PEAK_INT8[H100]}


def _device_name(device) -> Optional[str]:
    """The card's name for ``device``: None (the first CUDA device, if
    any), an index, a ``torch.device`` or its string; None off CUDA."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = 0
    if not isinstance(device, int):
        device = torch.device(device)
        if device.type != "cuda":
            return None
    return torch.cuda.get_device_name(device)


def device_peak_flops(device=None, int8: bool = False) -> Optional[float]:
    """Peak matmul FLOP/s for `device` (default: first CUDA device), or None
    if unknown (the CPU too).  Override with COBEVT_PEAK_TFLOPS (bf16
    TFLOP/s; int8 twice that)."""
    env = os.environ.get("COBEVT_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12 * (2.0 if int8 else 1.0)
    return (_PEAK_INT8 if int8 else _PEAK_BF16).get(_device_name(device))


def device_peak_hbm(device=None) -> Optional[float]:
    """Peak HBM bandwidth (bytes/s) for `device`, or None if unknown.
    Override with COBEVT_PEAK_HBM_GBS (GB/s)."""
    env = os.environ.get("COBEVT_PEAK_HBM_GBS")
    if env:
        return float(env) * 1e9
    return _PEAK_HBM.get(_device_name(device))


def mfu(flops_per_call: Optional[float], seconds_per_call: float,
        device=None) -> Optional[float]:
    """Model FLOPs utilization in [0, 1], or None if unknown."""
    peak = device_peak_flops(device)
    if flops_per_call is None or peak is None or seconds_per_call <= 0:
        return None
    return flops_per_call / seconds_per_call / peak


def hbm_util(bytes_per_call: Optional[float], seconds_per_call: float,
             device=None) -> Optional[float]:
    """Achieved HBM bandwidth over peak, in [0, ~1], or None if unknown.
    >1 means the logical byte count exceeds what the bus can move: operands
    read from L2 again count again."""
    peak = device_peak_hbm(device)
    if bytes_per_call is None or peak is None or seconds_per_call <= 0:
        return None
    return bytes_per_call / seconds_per_call / peak


def utilization(costs: dict, seconds_per_call: float, device=None) -> dict:
    """{'mfu': m, 'hbm_util': h, 'hbm_gbs': g} rounded for artifacts."""
    m = mfu(costs.get("flops"), seconds_per_call, device)
    h = hbm_util(costs.get("bytes"), seconds_per_call, device)
    g = (costs["bytes"] / seconds_per_call / 1e9
         if costs.get("bytes") and seconds_per_call > 0 else None)
    out = {
        "mfu": round(m, 4) if m is not None else None,
        "hbm_util": round(h, 4) if h is not None else None,
        "hbm_gbs": round(g, 1) if g is not None else None,
    }
    if h is not None and h > 1.0:
        # >100% of the bus is physically impossible: the logical byte count
        # exceeds what actually moved.  Flag inline so no artifact ships an
        # impossible bandwidth unmarked (the JAX package's words); the
        # trace's GB/s (tools/parse_trace.py --bandwidth) is the meter
        out["hbm_flag"] = ("cost-model logical bytes > physical peak; "
                           "not achieved bandwidth — see trace_gbs")
    return out


def bound(flops, bytes_, peak: str) -> dict:
    """The least time (ms) the card could take: the larger of the bytes
    (each input read once, each output written once) over the memory rate
    and the operations over the peak rate of their type (``peak``: a key of
    :data:`PEAK_FLOPS`)."""
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
            "ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------------------------
# Work formulas: (operations, bytes) of one call from its operands' shapes
# and dtypes.  An operand is anything with ``shape`` and ``dtype`` (a tensor,
# a fake or meta tensor), or None.  Operations are the products of the plain
# version (2 a multiply-add) for every kernel but A7, K9 and K10, which do
# none: theirs are the elementwise operations their bounds divide by the f32
# rate, and their registered FLOPs are 0.
# ---------------------------------------------------------------------------

def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def nbytes(*tensors) -> int:
    """Bytes of the operands given (None skipped)."""
    return sum(_numel(t.shape) * t.dtype.itemsize for t in tensors
               if t is not None)


def attention_work(G: int, Tq: int, Tk: int, C: int, products: int) -> float:
    """Operations of ``products`` (Tq x Tk x C) products over G windows, C
    the width of all heads: 2 for a forward, 5 for the flash backward (the
    recomputed scores, dv, the probabilities' gradient, dq, dk)."""
    return 2.0 * products * G * Tq * Tk * C


def k1_work(q, k, v, n_heads=None, bias_flat=None, mask=None, weight=None,
            stats=None):
    """K1, packed attention: q (G, Tq, C), k and v (G, Tk, C), the output
    like q; with ``stats`` (K5's scratch) the two planes of row statistics
    it writes."""
    G, Tq, C = q.shape
    written = 2 * _numel(stats.shape[1:]) * 4 if stats is not None else 0
    return (attention_work(G, Tq, Tk=k.shape[1], C=C, products=2),
            nbytes(q, k, v, bias_flat, mask, weight) + nbytes(q) + written)


def k5_work(q, k, v, g, out, n_heads=None, bias_flat=None, mask=None,
            stats=None):
    """K5, the flash backward of K1: reads q, k, v, g, out, the bias and
    mask (and K1's two planes of statistics), writes dq, dk, dv and an f32
    dbias like the bias."""
    G, Tq, C = q.shape
    read = 2 * _numel(stats.shape[1:]) * 4 if stats is not None else 0
    dbias = _numel(bias_flat.shape) * 4 if bias_flat is not None else 0
    return (attention_work(G, Tq, k.shape[1], C, 5),
            nbytes(q, k, v, g, out, bias_flat, mask) + nbytes(q, k, v)
            + dbias + read)


def k8_work(q, k, v, bias=None, mask=None):
    """K8, head-major attention: q (G, H, Tq, D), k and v (G, H, Tk, D)."""
    G, H, Tq, D = q.shape
    return (attention_work(G, Tq, k.shape[2], H * D, 2),
            nbytes(q, k, v, bias, mask) + nbytes(q))


def conv3x3_work(x, O: int, out_itemsize: int, *read):
    """A stride-1 3x3 conv of x (N, H, W, C) to O channels: its products,
    and the bytes of x, of ``read`` (weights, scales, residual) and of the
    (N, H, W, O) output."""
    N, H, W, C = x.shape
    return (2.0 * N * H * W * 9 * C * O,
            nbytes(x, *read) + N * H * W * O * out_itemsize)


def k3_work(x, w, shift, residual=None):
    """K3: x (N, H, W, C), w (3, 3, C, O) in x's dtype (the wgmma route
    reads the same bytes transposed), shift (O,) f32, residual like the
    output."""
    return conv3x3_work(x, w.shape[-1], x.dtype.itemsize, w, shift,
                        residual)


def k7_work(x, wt, s_w, shift, residual=None):
    """K7: int8 products of x quantized inside the kernel with wt (O, 9 C)
    int8; reads x, wt, the scales and shift, the residual; writes the
    output in x's dtype.  The |max| slots (4 bytes each) are not counted."""
    return conv3x3_work(x, wt.shape[0], x.dtype.itemsize, wt, s_w, shift,
                        residual)


def s8_work(xq, wt, sw, t, residual_q=None, out_itemsize: int = 1):
    """The int8 chain's conv: int8 products of xq (N, H, W, C) int8 with
    wt (O, 9 C) int8; reads the per-channel scale and shift and the int8
    residual, writes int8 (``out_itemsize`` 1, requantized) or the model's
    dtype.  The 0-d scales are not counted."""
    return conv3x3_work(xq, wt.shape[0], out_itemsize, wt, sw, t,
                        residual_q)


def a7_work(x, slot):
    """The absmax that scales a stage's first K7: a compare a value of x
    (no products), x read and the slot written."""
    return float(_numel(x.shape)), nbytes(x, slot)


def k2_work(B: int, n: int, H: int, W: int, h: int, w: int, q_win, k_win,
            D: int, C: int, hidden: int, embed: bool, dtype_size: int):
    """K2, one FAX cross-view branch over B maps, n cameras, BEV H x W, keys
    h x w: the K/V, Q, output and MLP products, the two attention products
    of every (window, query segment) over the window's n * kh * kw keys;
    bytes of x, key, val, the output, the weights and the embeddings, each
    once."""
    nq = n if embed else 1
    rows_k, rows_q, rows_o = B * n * h * w, B * nq * H * W, B * H * W
    windows = B * (H // q_win[0]) * (W // q_win[1])
    flops = 2.0 * D * C * (2 * rows_k + rows_q + rows_o)
    flops += 4.0 * rows_o * D * hidden
    flops += 4.0 * windows * nq * q_win[0] * q_win[1] * n * k_win[0] * \
        k_win[1] * C
    elems = 2 * rows_k * D + 2 * rows_o * D + 4 * D * C + 2 * D * hidden
    if embed:
        elems += H * W * D + B * n * D
    return flops, elems * dtype_size


def fusion_work(B: int, L: int, H: int, W: int, D: int, window: int,
                heads: int, depth: int, mlp: int, dtype_size: int,
                bias_size: int, masked: bool = True, head: bool = True):
    """The FuseBEVT encoder over a (B, L, H, W, D) state: depth x 2
    sublayers (LN, QKV, window or grid attention over L * window^2 tokens,
    output projection, LN, MLP) and, with ``head``, the agent pooling and
    the head's D x D product.  Bytes: the state in, the result out ((B, H,
    W, D) with the head, the state without), the weight matrices, the bias
    of every sublayer at ``bias_size`` bytes an element and the f32 key
    mask, each once.  K4 is the whole encoder; K6 is the sublayers (its head
    is plain PyTorch, counted as such)."""
    rows, T, G = B * L * H * W, L * window * window, \
        B * (H // window) * (W // window)
    sub = 2.0 * rows * D * (3 * D + D + 2 * mlp) + 4.0 * G * T * T * D
    flops = 2 * depth * sub + (2.0 * B * H * W * D * D if head else 0.0)
    weights = 2 * depth * (4 * D * D + 2 * D * mlp) + (D * D if head else 0)
    elems = rows * D + (B * H * W * D if head else rows * D) + weights
    return flops, (elems * dtype_size + 2 * depth * T * heads * T * bias_size
                   + (B * L * H * W * 4 if masked else 0))


def bn_stats_work(R: int, C: int, reads: int, dtype_size: int):
    """K9 (``reads`` 1) and K10 (2): a max, a cast, an add and a
    multiply-add an element of each input, in f32 units (no products);
    bytes of the (R, C) inputs and the two f32 (C,) sums."""
    return 4.0 * R * C * reads, reads * R * C * dtype_size + 8 * C


def k11_work(x, gamma, beta, w1, b1, w2, b2):
    """K11, the PreNorm FFN sublayer: two N x D x M products; its seven
    operands read and the (N, D) output written."""
    N, D = x.shape
    return 4.0 * N * D * w1.shape[1], nbytes(x, gamma, beta, w1, b1, w2,
                                             b2, x)


def k12_work(x, dy, gamma, beta, w1, b1, w2):
    """K12, K11's backward: five N x D x M products (h, da, dt, dW1, dW2);
    reads x, dy and the parameters, writes dx in x's dtype and the six f32
    parameter gradients."""
    N, D = x.shape
    M = w1.shape[1]
    grads = 4 * (2 * D + 2 * D * M + M + D)
    return 10.0 * N * D * M, (nbytes(x, dy, gamma, beta, w1, b1, w2, x)
                              + grads)


# ---------------------------------------------------------------------------
# Counting a call
# ---------------------------------------------------------------------------

def _no_work_ops():
    """aten ops besides views that launch no work on the device:
    allocations and aliases."""
    import torch

    aten = torch.ops.aten
    return {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
            aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
            aten._unsafe_view, aten.set_, aten.resize_, aten.record_stream}


def _tensor_bytes(tree) -> int:
    import torch
    from torch.utils._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Counted:
    """What :func:`costs` sums over a call."""

    def __init__(self):
        self.flops = self.int8 = 0.0
        self.bytes = 0
        self.kernels = {}


def _counting_mode(kernel_ops, counted):
    """A dispatch mode that sums into ``counted``: the products of every op
    with a formula in ``FlopCounterMode``'s registry (aten's, and the one
    each ``cobevt::`` op registers), the logical operand and output bytes of
    every op that launches work (views and allocations excluded) or a
    kernel op's bytes from its formula, and each kernel op's calls,
    operations and bytes."""
    from torch.utils.flop_counter import FlopCounterMode
    from torch.utils._python_dispatch import TorchDispatchMode

    # the registry only: entering FlopCounterMode also tracks modules,
    # which asks for grad hooks on every module output
    registry = FlopCounterMode(display=False).flop_registry
    no_work = _no_work_ops()

    class CountingMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            packet = func.overloadpacket
            formula = registry.get(packet)
            products = (formula(*args, **kwargs, out_val=out)
                        if formula is not None else 0)
            counted.flops += products
            op = kernel_ops.get(packet)
            if op is not None:
                ops_, b = op.work(*args, **kwargs)
                if op.products == "int8":
                    counted.int8 += products
                rec = counted.kernels.setdefault(
                    op.name, {"calls": 0, "ops": 0.0, "bytes": 0})
                rec["calls"] += 1
                rec["ops"] += ops_
                rec["bytes"] += b
                counted.bytes += b
            elif not func.is_view and packet not in no_work:
                counted.bytes += _tensor_bytes((args, kwargs)) + \
                    _tensor_bytes(out)
            return out

    return CountingMode()


def costs(fn, *args, **kwargs) -> dict:
    """{'flops', 'int8_ops', 'bytes', 'kernels'} of one call of
    ``fn(*args, **kwargs)``, counted at the dispatcher (module docstring):
    ``kernels`` maps each ``cobevt::`` op reached to its calls, operations
    (its formula's; A7's are compares) and bytes.  The call runs as it
    would: on the card its kernels launch and count their launches.  The
    autograd engine's threads inherit the mode, so a backward run inside is
    counted too."""
    from cobevt_tpu_torch.ops import KERNEL_OPS

    kernel_ops = {op.overload.overloadpacket: op
                  for op in KERNEL_OPS.values()}
    counted = _Counted()
    with _counting_mode(kernel_ops, counted):
        fn(*args, **kwargs)
    return {"flops": float(counted.flops), "int8_ops": float(counted.int8),
            "bytes": float(counted.bytes),
            "kernels": {k: dict(v) for k, v in counted.kernels.items()}}
