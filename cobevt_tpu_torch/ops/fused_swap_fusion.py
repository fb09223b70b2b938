"""Fused FuseBEVT encoder (K4 and K6): wrappers, plain versions, launches.

Counterpart of ``cobevt_tpu/ops/fused_swap_fusion.py``: the whole
SwapFusionEncoder at eval, depth x [window, grid] sublayers (LN -> QKV ->
attention with the 3-D rel-pos bias and the additive key mask ->
out-projection -> residual -> LN -> FFN -> residual), then the agent mean
-> LN -> Linear head.

  * :func:`fused_swap_fusion` (K4, ``fused_swap_fusion`` of the JAX package)
    for a state small enough to stay cache-resident: the CUDA kernel is
    ``csrc/fused_swap_fusion.cu``, each launch counted.  bf16 at D 128
    (:func:`k4_kernel_path`, CorpBEVT) runs on ``wgmma``: one QKV launch,
    then per sublayer K1's attention kernel and an output launch that also
    runs the next sublayer's LN + QKV, and the head (:func:`k4_plan`); f32
    and the other widths run three row launches per sublayer and the head.
    Bias and mask rows ride in the compute dtype (``_kernel`` :117-184).
  * :func:`fused_swap_fusion_streaming` (K6,
    ``fused_swap_fusion_streaming`` of the JAX package, body
    ``_stream_kernel`` :333-381) for larger states and wider tokens: the
    CUDA kernel is ``csrc/fused_swap_fusion_streaming.cu``, one C entry per
    sublayer, counted once per entry.  Bias and mask stay in f32; the agent
    pooling and the head run outside the kernel as plain PyTorch, as the JAX
    package leaves them to XLA.

Shared numerics: weights in the compute dtype, f32 LayerNorms and products,
q scaled after the cast of qkv, the exp rounded to the compute dtype before
both the numerator and the sum.  Both kernels and both plain versions take
the row maximum per head; the streaming TPU body takes it over the heads of
a 128-channel group, which moves a bf16 weight by at most one ulp and
nothing in f32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.dispatch import (
    KernelOp,
    check_aligned,
    check_operand,
    needs_grad,
    route,
)
from cobevt_tpu_torch.ops.fused_cross_attention import (
    KERNEL_DTYPES,
    KERNEL_HEAD_DIMS,
    SMEM_BYTES,
    _pad,
    ln_f32,
    row_smem_bytes,
)
from cobevt_tpu_torch.utils import flops

NEG_INF = -1e9


def launches_per_call(depth: int, path: str = "rows") -> int:
    """K4's launches for ``depth`` blocks of two sublayers.  "rows": three a
    sublayer (QKV rows, attention, output rows) and the head; "wgmma"
    (:func:`k4_kernel_path`): the first QKV, two a sublayer (attention, and
    the output with the next sublayer's QKV in its epilogue) and the
    head."""
    if path == "wgmma":
        return 1 + depth * 2 * 2 + 1
    return depth * 2 * 3 + 1


def k4_kernel_path(D: int, heads: int, mlp: int, dtype) -> str:
    """Which K4 kernels a shape runs: "wgmma" (bf16, D 128, head dim 16 or
    32, mlp a multiple of 128: CorpBEVT's encoder) or "rows" (f32, the
    sharp check, and the other widths).  A choice by shape; both compute the
    same function and roundings."""
    if dtype == torch.bfloat16 and D == 128 and heads > 0 and \
            D % heads == 0 and D // heads in (16, 32) and mlp % 128 == 0:
        return "wgmma"
    return "rows"


def kernel_accepts(L: int, H: int, W: int, D: int, window: int, heads: int,
                   mlp: int) -> bool:
    """Shapes the CUDA kernel takes: whole windows, head dims 8/16/32,
    widths that are multiples of 16, a multiple of 8 tokens per window, and
    row tiles that fit one block's shared memory.  Device-independent."""
    if window <= 0 or H % window or W % window:
        return False
    if heads <= 0 or D % heads or D // heads not in KERNEL_HEAD_DIMS:
        return False
    if D % 16 or mlp % 16 or (L * window * window) % 8:
        return False
    return max(row_smem_bytes(D, 3 * D), row_smem_bytes(D, D, mlp)) \
        <= SMEM_BYTES


# The JAX dispatch keeps a state whole-resident (K4) while the f32 bias of a
# sublayer and the bf16 state of one batch element each fit this many bytes;
# anything larger streams (K6).  The split is kept so both packages run the
# same kernel, with the same bias dtype, at the same shape.
RESIDENT_BYTES = int(2.5 * 2 ** 20)


# token rows of a K6 row-kernel block (csrc/fused_swap_fusion_streaming.cu)
STREAM_ROWS = 16


def fits_resident(L: int, H: int, W: int, D: int, window: int,
                  heads: int) -> bool:
    """``fits`` of the JAX dispatch (``models/fusion/swap_fusion.py:394``):
    whole windows, the f32 bias (T, heads*T) and the bf16 state (L, H, W, D)
    each within :data:`RESIDENT_BYTES`."""
    if window <= 0 or H % window or W % window:
        return False
    T = L * window * window
    return T * heads * T * 4 <= RESIDENT_BYTES and \
        L * H * W * D * 2 <= RESIDENT_BYTES


def stream_accepts(L: int, H: int, W: int, D: int, window: int, heads: int,
                   mlp: int) -> bool:
    """Shapes K6 takes.  Device-independent.  The semantic terms of the JAX
    gate ``streams`` stay: whole windows and a multiple of 8 tokens per
    window.  Its TPU block-shape terms (``d % 128``, ``w % 8 or w == W``,
    ``n_win % 8``, an 8 MB resident bias) have no counterpart on the card
    and give way to the kernel's own limits:

      * head dim 8, 16 or 32: the attention kernels are instantiated for
        these;
      * D and mlp multiples of 64: the 8 warps of a row block split every
        product's output columns in 8-column tiles.  Every model of the
        repo qualifies (CorpBEVT 128/256, LiDAR 256/512); other widths run
        the stock modules;
      * f32 row tiles (:data:`STREAM_ROWS` rows) of widths D + 3D and
        2D + mlp within one block's shared memory (D 256 with mlp 512 takes
        67 KB of 227 KB; the limit is near D 896 with mlp 2D);
      * B times the windows of a map at most 65,535, the launch grid's z
        extent (checked at the launch, which knows B).

    No size term: the bias is read tile by tile from device memory."""
    if window <= 0 or H % window or W % window:
        return False
    if heads <= 0 or D % heads or D // heads not in KERNEL_HEAD_DIMS:
        return False
    if D % 64 or mlp % 64 or (L * window * window) % 8:
        return False
    tiles = max(_pad(D) + _pad(3 * D), 2 * _pad(D) + _pad(mlp))
    return STREAM_ROWS * tiles * 4 <= SMEM_BYTES


# K6's wgmma route (csrc/fused_swap_fusion_streaming.cu, namespace wg): 64-row
# tiles, two warpgroups a block, the output launch's weight ring at most this
# deep; K4's output launch (csrc/fused_swap_fusion.cu, out_k4) keeps barriers
# for rings of K4_MAX_STAGES boxes
STREAM_TILE, STREAM_GROUPS, STREAM_MAX_STAGES = 64, 2, 4
K4_MAX_STAGES = 8


def stream_kernel_path(D: int, heads: int, mlp: int, dtype) -> str:
    """Which K6 kernels a shape runs: "wgmma" (bf16, D 128, 256 or 512, head
    dim 16 or 32, mlp a multiple of 128: every FuseBEVT of the repo, SECOND's
    D 512 included; :func:`stream_plan` plans D 128 / 256, :func:`wide_plan`
    D 512) or "rows" (f32, and bf16 at the other widths: the row kernels and
    flash.cuh).  A choice by shape; both compute the same function and
    roundings."""
    if dtype == torch.bfloat16 and D in (128, 256, WIDE_D) and heads > 0 \
            and D % heads == 0 and D // heads in (16, 32) and mlp % 128 == 0:
        return "wgmma"
    return "rows"


class StreamPlan(NamedTuple):
    """The launch plan of K6's wgmma route for ``rows`` token rows."""

    tiles: int         # 64-row tiles
    qkv_blocks: int    # the QKV launch's grid x (y: q, k, v)
    out_blocks: int    # the output launch's persistent blocks
    stages: int        # boxes in the output launch's weight ring
    stage_bytes: int   # the largest box: D rows x 64 columns of bf16
    qkv_smem: int      # shared memory a block of each launch takes
    out_smem: int


def stream_plan(rows: int, D: int, mlp: int, sms: int) -> StreamPlan:
    """Grids and shared memory of K6's wgmma route, the same numbers as the
    kernels' ``qkv_smem`` / ``out_smem``: one block an SM in each launch
    (the QKV launch's blocks split over q, k, v, each holding its D x D
    slice of Wqkv), and as deep a weight ring as fits beside the two
    warpgroups' attention / LN tiles and hidden tiles.  Raises when two
    boxes do not fit."""
    tile, groups = STREAM_TILE, STREAM_GROUPS
    tiles = -(-rows // tile)
    pairs = -(-tiles // groups)
    stage = D * 128
    qkv_smem = 1024 + D * D * 2 + groups * tile * D * 2 + 2 * D * 4 + 16
    fixed = 1024 + groups * (tile * D * 2 + tile * 128 * 2) + groups * tile \
        * 4 + (2 * STREAM_MAX_STAGES + groups) * 8
    stages = min(STREAM_MAX_STAGES, (SMEM_BYTES - fixed) // stage)
    if stages < 2 or qkv_smem > SMEM_BYTES:
        raise ValueError(f"K6's wgmma route does not fit D={D}, mlp={mlp} "
                         f"in {SMEM_BYTES} bytes")
    return StreamPlan(tiles, max(1, min(sms // 3, pairs)), min(sms, pairs),
                      stages, stage, qkv_smem, fixed + stages * stage)


# K6's wgmma route at D 512 (csrc/fused_swap_fusion_streaming.cu, namespace
# wide): the QKV launch's two warpgroups (a 64-row tile each) share one ring
# of boxes of 128 Wqkv rows x 64 columns; the output launch's four
# warpgroups share a tile, each owning 128 output columns and hidden chunks
# of 64, and streaming boxes of 64 weight rows x 64 columns through a ring of
# its own
WIDE_D = 512
WIDE_QKV_GROUPS, WIDE_QKV_COLS, WIDE_QKV_MAX_STAGES = 2, 128, 6
WIDE_OUT_GROUPS, WIDE_OUT_HIDDEN, WIDE_OUT_MAX_STAGES = 4, 64, 4


class WidePlan(NamedTuple):
    """The launch plan of K6's wgmma route at D 512 for ``rows`` token
    rows."""

    tiles: int         # 64-row tiles
    qkv_blocks: int    # the QKV launch's persistent blocks (pairs of tiles)
    out_blocks: int    # the output launch's persistent blocks (a tile each)
    qkv_stages: int    # boxes in the QKV launch's ring
    out_stages: int    # boxes in each output warpgroup's ring
    qkv_box: int       # bytes of a ring box: 128 Wqkv rows x 64 columns
    out_box: int       # 64 weight rows x 64 columns
    qkv_smem: int      # shared memory a block of each launch takes
    out_smem: int


def wide_plan(rows: int, D: int, mlp: int, sms: int) -> WidePlan:
    """Grids and shared memory of K6's wgmma route at D 512, the same
    numbers as the kernels' ``wide::qkv_smem`` / ``wide::out_smem``: one
    block an SM in each launch, and each ring as deep as fits (the QKV
    launch's beside its two 64 x D A tiles; the output launch's four beside
    the A tile and the 64 x mlp hidden tile).  Raises when a ring of two
    boxes does not fit, or on another D."""
    tile = STREAM_TILE
    tiles = -(-rows // tile)
    pairs = -(-tiles // WIDE_QKV_GROUPS)
    a_tile = tile * D * 2
    qkv_box = WIDE_QKV_COLS * 128
    out_box = 64 * 128
    qkv_fixed = 1024 + WIDE_QKV_GROUPS * a_tile + 2 * D * 4 + \
        2 * WIDE_QKV_MAX_STAGES * 8
    out_fixed = 1024 + a_tile + tile * mlp * 2 + tile * 4 + \
        2 * WIDE_OUT_GROUPS * tile * 4 + \
        (2 * WIDE_OUT_GROUPS * WIDE_OUT_MAX_STAGES + 1) * 8
    qkv_stages = min(WIDE_QKV_MAX_STAGES,
                     (SMEM_BYTES - qkv_fixed) // qkv_box)
    out_stages = min(WIDE_OUT_MAX_STAGES, (SMEM_BYTES - out_fixed)
                     // (WIDE_OUT_GROUPS * out_box))
    if D != WIDE_D or mlp % 128 or qkv_stages < 2 or out_stages < 2:
        raise ValueError(f"K6's D 512 wgmma route does not fit D={D}, "
                         f"mlp={mlp} in {SMEM_BYTES} bytes")
    return WidePlan(tiles, min(sms, pairs), min(sms, tiles), qkv_stages,
                    out_stages, qkv_box, out_box,
                    qkv_fixed + qkv_stages * qkv_box,
                    out_fixed + out_stages * WIDE_OUT_GROUPS * out_box)


class K4Plan(NamedTuple):
    """The launch plan of K4's wgmma route for ``rows`` token rows: 64-row
    tiles; the output launch's two warpgroups share a tile, each owning
    half of every product's columns and streaming its own weight ring."""

    tiles: int         # 64-row tiles
    qkv_blocks: int    # the first QKV launch's grid x (y: q, k, v)
    out_blocks: int    # the output launches' persistent blocks
    stages: int        # 16 KB boxes in each warpgroup's weight ring
    qkv_smem: int      # shared memory a block of each launch takes
    out_smem: int
    # each launch may start while the one ahead of it runs, its blocks
    # setting up and loading weights before they wait for its results
    # (programmatic dependent launch; False: one launch after the other)
    pdl: bool = True


def k4_plan(rows: int, D: int, mlp: int, sms: int) -> K4Plan:
    """Grids and shared memory of K4's wgmma route, the same numbers as
    ``swapwg::qkv_smem`` (one warpgroup a block) and ``wg4::out_k4_smem``:
    a block a tile while the tiles fit the SMs (80 blocks at CorpBEVT's
    5,120 rows, where K6's plan gives 40), and the deepest weight rings
    that fit (at most :data:`K4_MAX_STAGES` boxes).  Raises when it does
    not fit."""
    tile = STREAM_TILE
    tiles = -(-rows // tile)
    qkv_smem = 1024 + D * D * 2 + tile * D * 2 + 2 * D * 4 + 16
    stage = 2 * 128 * 128     # a 16 KB box in each warpgroup's ring
    fixed = 1024 + tile * D * 2 + tile * mlp * 2 + tile * 4 + \
        2 * 2 * tile * 4 + (4 * K4_MAX_STAGES + 1) * 8
    stages = min(K4_MAX_STAGES, (SMEM_BYTES - fixed) // stage)
    if stages < 2 or qkv_smem > SMEM_BYTES or mlp % 128:
        raise ValueError(f"K4's wgmma route does not fit D={D}, mlp={mlp} "
                         f"in {SMEM_BYTES} bytes")
    return K4Plan(tiles, tiles, min(sms, tiles), stages, qkv_smem,
                  fixed + stages * stage)


def gather_key_mask(mask, window: int, grid: bool):
    """The (B, L, H, W) key mask of one half as K1's kernel reads it: (G, T)
    f32 in the window-major order of K6's rows (``to_windows``), one copy."""
    T = mask.shape[1] * window * window
    return to_windows(mask, window, grid).reshape(-1, T).contiguous()


class PackedFusion(NamedTuple):
    """K4's or K6's operands as both versions read them (:func:`pack`)."""

    layers: list      # per block, (window, grid) dicts of packed weights
    bias: torch.Tensor  # (depth, 2, T, heads*T): compute dtype (K4), f32 (K6)
    head: dict


def pack(layers, bias_stack, head, dtype, bias_dtype=None) -> PackedFusion:
    """Every weight, the bias and the head in the compute dtype, as the TPU
    body's stacks (``_pack_layer_params`` :187 and the head rows of
    ``_fused_eval``); matrices transposed to (out, in), LayerNorm pairs as
    (2, D).  ``bias_dtype`` (default: the compute dtype, K4's) is
    ``torch.float32`` for K6.  A caller that runs the encoder many times
    packs once and passes the result as ``layers``."""
    def vec(*ts):
        return torch.stack([t.reshape(-1) for t in ts]).to(dtype).contiguous()

    def mat_t(m):
        return m.t().to(dtype).contiguous()

    def one(p):
        return {"ln_a": vec(*p["ln_a"]), "wqkv_t": mat_t(p["wqkv"]),
                "wout_t": mat_t(p["wout"]), "ln_f": vec(*p["ln_f"]),
                "w1_t": mat_t(p["w1"]), "b1": p["b1"].to(dtype).contiguous(),
                "w2_t": mat_t(p["w2"]), "b2": p["b2"].to(dtype).contiguous()}

    return PackedFusion(
        [(one(wp), one(gp)) for wp, gp in layers],
        bias_stack.to(bias_dtype or dtype).contiguous(),
        {"ln": vec(*head["ln"]), "w_t": mat_t(head["w"]),
         "b": head["b"].to(dtype).contiguous()})


def _packed(layers, bias_stack, head, dtype, bias_dtype) -> PackedFusion:
    if not isinstance(layers, PackedFusion):
        return pack(layers, bias_stack, head, dtype, bias_dtype)
    if bias_stack is not None or head is not None:
        raise ValueError("packed layers already hold the bias and the head")
    if layers.head["b"].dtype != dtype or layers.bias.dtype != bias_dtype:
        raise ValueError(
            f"layers were packed in {layers.head['b'].dtype} with a "
            f"{layers.bias.dtype} bias; this call needs {dtype} and "
            f"{bias_dtype}")
    return layers


def to_windows(t, w: int, grid: bool):
    """(B, L, H, W, ...) -> (B, X*Y, L*w*w, ...): window cells, or grid
    cells (token (l, p, s) of cell (x, y) at row p*X + x, column s*Y + y)."""
    B, L, H, W = t.shape[:4]
    rest = t.shape[4:]
    X, Y = H // w, W // w
    tail = tuple(range(6, 6 + len(rest)))
    if grid:
        t = t.reshape(B, L, w, X, w, Y, *rest).permute(
            0, 3, 5, 1, 2, 4, *tail)
    else:
        t = t.reshape(B, L, X, w, Y, w, *rest).permute(
            0, 2, 4, 1, 3, 5, *tail)
    return t.reshape(B, X * Y, L * w * w, *rest)


def from_windows(t, L: int, H: int, W: int, w: int, grid: bool):
    """Inverse of :func:`to_windows` for (B, X*Y, T, D)."""
    B, D = t.shape[0], t.shape[-1]
    X, Y = H // w, W // w
    t = t.reshape(B, X, Y, L, w, w, D)
    t = t.permute(0, 3, 4, 1, 5, 2, 6) if grid else \
        t.permute(0, 3, 1, 4, 2, 5, 6)
    return t.reshape(B, L, H, W, D)


def _proj(t, w_t, b=None):
    y = t @ w_t.float().t()
    return y if b is None else y + b.float()


def _head_reference(state, agent_mask, head, mean_over_valid):
    """Agent pooling in f32 (the mean over L, or over the live agents with
    the divisor clamped at 1) -> cast -> LN -> cast -> Linear: the head of
    both TPU bodies (``_kernel`` :163-184, ``fused_swap_fusion_streaming``
    :460-475)."""
    dt = state.dtype
    L = state.shape[1]
    st = state.float()
    if mean_over_valid and agent_mask is not None:
        am = agent_mask.float()
        wsum = torch.zeros_like(st[:, 0])
        tot = torch.zeros_like(am[:, 0])
        for li in range(L):
            wsum = wsum + st[:, li] * am[:, li, None, None, None]
            tot = tot + am[:, li]
        pooled = wsum / tot.clamp(min=1.0)[:, None, None, None]
    else:
        pooled = st.mean(1)
    t = ln_f32(pooled.to(dt), *head["ln"]).to(dt).float()
    return _proj(t, head["w_t"], head["b"]).to(dt)


def _reference(x, mask, agent_mask, bias, layers, head, window, heads,
               mean_over_valid, mask_f32=False):
    """``mask_f32``: the additive mask stays f32 (K6) instead of being
    rounded to the compute dtype (K4); the bias is used in the dtype it was
    packed in."""
    state = _layers_reference(x, mask, bias, layers, window, heads,
                              mask_f32)
    return _head_reference(state, agent_mask, head, mean_over_valid)


def _layers_reference(x, mask, bias, layers, window, heads, mask_f32):
    """The sublayers of :func:`_reference`: the final (B, L, H, W, D)
    state before the agent pooling and the head."""
    dt = x.dtype
    B, L, H, W, D = x.shape
    w = window
    Dh = D // heads
    proj = _proj

    def c(t):   # the TPU body's astype(compute_dtype), kept as f32 values
        return t.to(dt).float()

    # x (bf16) * python float: the scale is taken in the compute dtype
    scale = torch.tensor(Dh ** -0.5, dtype=dt)
    madd = None
    if mask is not None:
        madd = torch.where(mask > 0, 0.0, NEG_INF)             # (B, L, H, W)
        madd = madd.float() if mask_f32 else c(madd)
    state = x
    for d, pair in enumerate(layers):
        for half, p in enumerate(pair):
            grid = half == 1
            tok = to_windows(state, w, grid)                     # (B, XY, T, D)
            G, T = tok.shape[1], tok.shape[2]
            qkv = proj(c(ln_f32(tok, *p["ln_a"])), p["wqkv_t"]).to(dt)
            q = (qkv[..., :D] * scale).float()
            k, v = qkv[..., D:2 * D].float(), qkv[..., 2 * D:].float()

            def heads4(t):
                return t.reshape(B, G, T, heads, Dh).transpose(2, 3)

            sim = heads4(q) @ heads4(k).transpose(-1, -2)  # (B, G, h, T, T)
            sim = sim + bias[d, half].float().reshape(T, heads, T) \
                .transpose(0, 1)
            if madd is not None:
                sim = sim + to_windows(madd, w, grid)[:, :, None, None, :]
            e = c(torch.exp(sim - sim.amax(-1, keepdim=True)))
            att = (e @ heads4(v)) / e.sum(-1, keepdim=True)
            att = att.transpose(2, 3).reshape(B, G, T, D)
            x1 = tok.float() + proj(c(att), p["wout_t"])
            f = c(ln_f32(c(x1), *p["ln_f"]))
            f = c(F.gelu(proj(f, p["w1_t"], p["b1"])))
            f = proj(f, p["w2_t"], p["b2"])
            state = from_windows((x1 + f).to(dt), L, H, W, w, grid)
    return state


def swap_fusion_reference(x, mask, agent_mask, bias_stack, layers, head,
                          window: int, heads: int,
                          mean_over_valid: bool = False):
    """Plain PyTorch version of K4: the TPU body's chain on whole tensors,
    with the same casts."""
    p = _packed(layers, bias_stack, head, x.dtype, x.dtype)
    return _reference(x, mask, agent_mask, p.bias, p.layers, p.head, window,
                      heads, mean_over_valid)


def _lib():
    lib = _build.load("fused_swap_fusion")
    P, I, IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    f = ctypes.c_float
    lib.cobevt_fusion_qkv.argtypes = [P, P, P, f, P, IP, I, I, P]
    lib.cobevt_fusion_attention.argtypes = [P, P, P, f, P, IP, I, I, P]
    lib.cobevt_fusion_out.argtypes = [P] * 9 + [IP, I, I, P]
    lib.cobevt_fusion_head.argtypes = [P] * 6 + [IP, I, I, I, P]
    lib.cobevt_fusion_wg_qkv.argtypes = [P, P, P, f, P, IP, I, I, I, P]
    lib.cobevt_fusion_wg_attention.argtypes = [P, P, P, P, IP, I, I, P]
    lib.cobevt_fusion_wg_out.argtypes = [P] * 12 + [f, IP, I, I, I, I, P]
    for fn in (lib.cobevt_fusion_qkv, lib.cobevt_fusion_attention,
               lib.cobevt_fusion_out, lib.cobevt_fusion_head,
               lib.cobevt_fusion_wg_qkv, lib.cobevt_fusion_wg_attention,
               lib.cobevt_fusion_wg_out):
        fn.restype = I
    return lib


def _launch_kernel(x, mask, agent_mask, bias, layers, head, window, heads,
                   mean_over_valid):
    B, L, H, W, D = x.shape
    w = window
    dt, dev = x.dtype, x.device
    mlp = layers[0][0]["w1_t"].shape[0]
    if dt not in KERNEL_DTYPES:
        raise ValueError(f"K4 takes {KERNEL_DTYPES}, got {dt}")
    if not kernel_accepts(L, H, W, D, w, heads, mlp):
        raise ValueError(f"K4 does not take L={L}, {H}x{W}, D={D}, "
                         f"window={w}, heads={heads}, mlp={mlp}")
    T = L * w * w
    depth = len(layers)
    check_operand("x", x, (B, L, H, W, D), dt, dev)
    check_aligned("x", x)
    check_operand("bias_stack", bias, (depth, 2, T, heads * T), dt, dev)
    if mask is not None:
        check_operand("mask", mask, (B, L, H, W), torch.float32, dev)
    if agent_mask is not None:
        check_operand("agent_mask", agent_mask, (B, L), torch.float32, dev)
    for pair in layers:
        for p in pair:
            for name, t in p.items():
                check_operand(name, t, t.shape, dt, dev)
    for name, t in head.items():
        check_operand(name, t, t.shape, dt, dev)

    flag, idx = int(dt == torch.bfloat16), dev.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = float(torch.tensor((D // heads) ** -0.5, dtype=dt))
    mask_add = float(torch.tensor(NEG_INF, dtype=dt))
    rows = B * L * H * W
    att = torch.empty((rows, D), dtype=dt, device=dev)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    out = torch.empty((B, H, W, D), dtype=dt, device=dev)
    lib = _lib()

    def launched(err, what):
        _build.check(err, what)
        fused_swap_fusion.launches += 1

    def dims(grid):
        return (ctypes.c_int * 9)(B, L, H, W, D, w, heads, mlp, int(grid))

    pdl = False
    if k4_kernel_path(D, heads, mlp, dt) == "wgmma":
        plan = k4_plan(rows, D, mlp, torch.cuda.get_device_properties(dev)
                       .multi_processor_count)
        pdl = plan.pdl
        state = _launch_wgmma(x, mask, bias, layers, window, scale, att,
                              bufs, dims, launched, plan)
    else:
        state = _launch_rows(x, mask, bias, layers, scale, mask_add, att,
                             bufs, dims, launched)
    am = agent_mask if mean_over_valid else None
    launched(lib.cobevt_fusion_head(
        state.data_ptr(), None if am is None else am.data_ptr(),
        head["ln"].data_ptr(), head["w_t"].data_ptr(), head["b"].data_ptr(),
        out.data_ptr(), dims(False), flag, int(pdl), idx, stream),
        "fused_swap_fusion head")
    return out


def _launch_rows(x, mask, bias, layers, scale, mask_add, att, bufs, dims,
                 launched):
    """K4's row route: per sublayer the QKV rows, flash.cuh's attention and
    the output rows; returns the final state."""
    dt, dev = x.dtype, x.device
    flag, idx = int(dt == torch.bfloat16), dev.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    qkv = torch.empty((att.shape[0], 3 * x.shape[-1]), dtype=dt, device=dev)
    lib = _lib()
    state = x
    for d, pair in enumerate(layers):
        for half, p in enumerate(pair):
            dm = dims(half == 1)
            nxt = bufs[(2 * d + half) % 2]   # ping-pong: never in place
            launched(lib.cobevt_fusion_qkv(
                state.data_ptr(), p["ln_a"].data_ptr(),
                p["wqkv_t"].data_ptr(), scale, qkv.data_ptr(), dm, flag, idx,
                stream), "fused_swap_fusion qkv")
            launched(lib.cobevt_fusion_attention(
                qkv.data_ptr(), bias[d, half].data_ptr(),
                None if mask is None else mask.data_ptr(), mask_add,
                att.data_ptr(), dm, flag, idx, stream),
                "fused_swap_fusion attention")
            launched(lib.cobevt_fusion_out(
                att.data_ptr(), state.data_ptr(), p["wout_t"].data_ptr(),
                p["ln_f"].data_ptr(), p["w1_t"].data_ptr(),
                p["b1"].data_ptr(), p["w2_t"].data_ptr(),
                p["b2"].data_ptr(), nxt.data_ptr(), dm, flag, idx, stream),
                "fused_swap_fusion out")
            state = nxt
    return state


def _launch_wgmma(x, mask, bias, layers, window, scale, att, bufs, dims,
                  launched, plan):
    """K4's wgmma route (:func:`k4_kernel_path`): the first sublayer's QKV,
    then per sublayer K1's attention kernel (with K4's numerics: the bf16
    bias as it is) and the output launch, which also writes the next
    sublayer's q, k, v; returns the final state.  The key mask of each half
    is gathered once a call into K1's (G, T) order."""
    B, L, H, W, D = x.shape
    dev, idx = x.device, x.device.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = B * L * H * W
    for name, t in [("x", x), ("bias_stack", bias)] + [
            (name, t) for pair in layers for p in pair
            for name, t in p.items()]:
        check_aligned(name, t)
    masks = (None, None) if mask is None else tuple(
        gather_key_mask(mask, window, g) for g in (False, True))
    qkv = torch.empty((3, rows, D), dtype=x.dtype, device=dev)
    lib = _lib()
    subs = [(d, half, p) for d, pair in enumerate(layers)
            for half, p in enumerate(pair)]
    launched(lib.cobevt_fusion_wg_qkv(
        x.data_ptr(), subs[0][2]["ln_a"].data_ptr(),
        subs[0][2]["wqkv_t"].data_ptr(), scale, qkv.data_ptr(),
        dims(False), plan.qkv_blocks, int(plan.pdl), idx, stream),
        "fused_swap_fusion wgmma qkv")
    state = x
    for i, (d, half, p) in enumerate(subs):
        dm = dims(half == 1)
        nxt = bufs[i % 2]   # ping-pong: never in place
        m = masks[half]
        launched(lib.cobevt_fusion_wg_attention(
            qkv.data_ptr(), bias[d, half].data_ptr(),
            None if m is None else m.data_ptr(), att.data_ptr(), dm,
            int(plan.pdl), idx, stream), "fused_swap_fusion wgmma attention")
        pn = subs[i + 1][2] if i + 1 < len(subs) else None
        launched(lib.cobevt_fusion_wg_out(
            att.data_ptr(), state.data_ptr(), p["wout_t"].data_ptr(),
            p["ln_f"].data_ptr(), p["w1_t"].data_ptr(), p["b1"].data_ptr(),
            p["w2_t"].data_ptr(), p["b2"].data_ptr(), nxt.data_ptr(),
            None if pn is None else pn["ln_a"].data_ptr(),
            None if pn is None else pn["wqkv_t"].data_ptr(),
            None if pn is None else qkv.data_ptr(), scale, dm,
            plan.out_blocks, plan.stages, int(plan.pdl), idx, stream),
            "fused_swap_fusion wgmma out")
        state = nxt
    return state


# the ops' flat operands: each sublayer's dict in this key order, window
# half before grid half, block after block; the head's
LAYER_KEYS = ("ln_a", "wqkv_t", "wout_t", "ln_f", "w1_t", "b1", "w2_t", "b2")
HEAD_KEYS = ("ln", "w_t", "b")


def flat_layers(layers) -> list:
    """Packed layers as the ops' ``Tensor[]``."""
    return [p[k] for pair in layers for p in pair for k in LAYER_KEYS]


def unflat_layers(ts) -> list:
    """The inverse of :func:`flat_layers`."""
    n = len(LAYER_KEYS)
    if not ts or len(ts) % (2 * n):
        raise ValueError(f"expected a multiple of {2 * n} layer tensors, got "
                         f"{len(ts)}")
    subs = [dict(zip(LAYER_KEYS, ts[i:i + n])) for i in range(0, len(ts), n)]
    return [(subs[i], subs[i + 1]) for i in range(0, len(subs), 2)]


def _work(x, mask, bias, layers, window, heads, head):
    """(operations, bytes) of one call of K4's op (``head``: the whole
    encoder) or K6's (the sublayers), ``utils/flops.py:fusion_work``."""
    B, L, H, W, D = x.shape
    subs = unflat_layers(layers)
    return flops.fusion_work(B, L, H, W, D, window, heads, len(subs),
                             subs[0][0]["w1_t"].shape[0], x.dtype.itemsize,
                             bias.dtype.itemsize, mask is not None, head)


def _k4_op_args(f):
    def impl(x, mask, agent_mask, bias, layers, head, window, heads,
             mean_over_valid):
        return f(x, mask, agent_mask, bias, unflat_layers(layers),
                 dict(zip(HEAD_KEYS, head)), window, heads, mean_over_valid)
    return impl


# K4 as the custom op cobevt::swap_fusion: (B, L, H, W, D) -> (B, H, W, D)
_K4 = KernelOp(
    "swap_fusion",
    "(Tensor x, Tensor? mask, Tensor? agent_mask, Tensor bias, "
    "Tensor[] layers, Tensor[] head, int window, int heads, "
    "bool mean_over_valid) -> Tensor",
    _k4_op_args(_reference), _k4_op_args(_launch_kernel),
    lambda x, *args: x.new_empty((x.shape[0], *x.shape[2:])),
    lambda x, mask, agent_mask, bias, layers, head, window, heads,
    mean_over_valid: _work(x, mask, bias, layers, window, heads, True))


def fused_swap_fusion(x, mask, agent_mask, bias_stack, layers, head,
                      window: int, heads: int, mean_over_valid: bool = False,
                      impl=None):
    """The SwapFusionEncoder at eval, fused.

    x: (B, L, H, W, D); mask: (B, L, H, W) key mask or None (keys with
    mask <= 0 get -1e9, in the compute dtype); agent_mask: (B, L), read
    only with ``mean_over_valid`` (the mean then runs over the live
    agents, else over all L); bias_stack: (depth, 2, T, heads*T) rel-pos
    bias of the window and grid halves (T = L*window^2, column block h
    holding head h); layers: per block a (window, grid) pair of dicts with
    ln_a / ln_f = (gamma, beta), wqkv (D, 3D), wout (D, D), w1 (D, mlp), b1,
    w2 (mlp, D), b2; head: {ln: (gamma, beta), w: (D, D), b: (D,)}.
    ``layers`` may instead be the :func:`pack` of all three, with
    bias_stack and head None.  Returns (B, H, W, D) in x's dtype.

    ``impl``: None (kernel for CUDA tensors, plain version for CPU
    tensors), "kernel" or "torch".  The kernel raises on a shape it does
    not take.

    The call is the op ``cobevt::swap_fusion`` on either device, unless
    "torch" is asked for by name or a CPU operand needs a gradient (the
    plain version then runs inline).  Inference only: the op has no
    backward (a gradient asked through it on the card raises).  Training
    runs the stock modules (``self.training`` gates the dispatch)."""
    p = _packed(layers, bias_stack, head, x.dtype, x.dtype)
    use_valid = mean_over_valid and agent_mask is not None
    if route(impl, x, needs_grad(x, p.bias, *p.head.values())) == "plain":
        return _reference(x, mask, agent_mask, p.bias, p.layers, p.head,
                          window, heads, use_valid)
    return _K4(
        x.contiguous(), None if mask is None else mask.float().contiguous(),
        agent_mask.float().contiguous() if use_valid else None, p.bias,
        flat_layers(p.layers), [p.head[k] for k in HEAD_KEYS], window, heads,
        use_valid)


# kernel launches since the last reset (plain-version calls do not count);
# launches_per_call(depth, k4_kernel_path(...)) per encoder
fused_swap_fusion.launches = 0


def swap_fusion_streaming_reference(x, mask, agent_mask, bias_stack, layers,
                                    head, window: int, heads: int,
                                    mean_over_valid: bool = False):
    """Plain PyTorch version of K6: the streaming TPU body's chain on whole
    tensors with the same casts, bias and additive mask in f32, then the
    head."""
    p = _packed(layers, bias_stack, head, x.dtype, torch.float32)
    return _reference(x, mask, agent_mask, p.bias, p.layers, p.head, window,
                      heads, mean_over_valid, mask_f32=True)


def _stream_lib():
    lib = _build.load("fused_swap_fusion_streaming")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.cobevt_fusion_stream_sublayer
    fn.argtypes = [P] * 14 + [ctypes.c_float, ctypes.POINTER(I),
                              ctypes.POINTER(I), I, I, P]
    fn.restype = I
    return fn


def _launch_streaming(x, mask, bias, layers, window, heads):
    """depth x [window, grid] sublayers of K6 over ``x``; returns the final
    (B, L, H, W, D) state.  The QKV and attention scratch and the two state
    buffers are allocated once for the call."""
    B, L, H, W, D = x.shape
    w = window
    dt, dev = x.dtype, x.device
    mlp = layers[0][0]["w1_t"].shape[0]
    if dt not in KERNEL_DTYPES:
        raise ValueError(f"K6 takes {KERNEL_DTYPES}, got {dt}")
    # the windows are the launch grid's z extent
    if not stream_accepts(L, H, W, D, w, heads, mlp) or \
            B * (H // w) * (W // w) > 65535:
        raise ValueError(f"K6 does not take B={B}, L={L}, {H}x{W}, D={D}, "
                         f"window={w}, heads={heads}, mlp={mlp}")
    T = L * w * w
    depth = len(layers)
    check_operand("x", x, (B, L, H, W, D), dt, dev)
    check_aligned("x", x)
    check_operand("bias_stack", bias, (depth, 2, T, heads * T),
                  torch.float32, dev)
    if mask is not None:
        check_operand("mask", mask, (B, L, H, W), torch.float32, dev)
    for pair in layers:
        for p in pair:
            for name, t in p.items():
                check_operand(name, t, t.shape, dt, dev)

    flag, idx = int(dt == torch.bfloat16), dev.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = float(torch.tensor((D // heads) ** -0.5, dtype=dt))
    rows = B * L * H * W
    # the wgmma route: q, k, v as (3, rows, D), the key mask of each half
    # gathered once into the (G, T) order of K1's kernel, and the plan
    plan, masks = None, (mask, mask)
    if stream_kernel_path(D, heads, mlp, dt) == "wgmma":
        flag = 2
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if D == WIDE_D:
            wp = wide_plan(rows, D, mlp, sms)
            plan = (ctypes.c_int * 4)(wp.qkv_blocks, wp.out_blocks,
                                      wp.out_stages, wp.qkv_stages)
        else:
            sp = stream_plan(rows, D, mlp, sms)
            plan = (ctypes.c_int * 4)(sp.qkv_blocks, sp.out_blocks,
                                      sp.stages, 0)
        for name, t in [("x", x), ("bias_stack", bias)] + [
                (name, t) for pair in layers for p in pair
                for name, t in p.items()]:
            check_aligned(name, t)
        if mask is not None:
            masks = tuple(gather_key_mask(mask, w, g) for g in (False, True))
    qkv = torch.empty((rows, 3 * D), dtype=dt, device=dev)
    att = torch.empty((rows, D), dtype=dt, device=dev)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    sublayer = _stream_lib()

    state = x
    for d, pair in enumerate(layers):
        for half, p in enumerate(pair):
            dims = (ctypes.c_int * 9)(B, L, H, W, D, w, heads, mlp, half)
            nxt = bufs[(2 * d + half) % 2]   # ping-pong: never in place
            m = masks[half]
            _build.check(sublayer(
                state.data_ptr(), nxt.data_ptr(), qkv.data_ptr(),
                att.data_ptr(), p["ln_a"].data_ptr(), p["wqkv_t"].data_ptr(),
                p["wout_t"].data_ptr(), p["ln_f"].data_ptr(),
                p["w1_t"].data_ptr(), p["b1"].data_ptr(),
                p["w2_t"].data_ptr(), p["b2"].data_ptr(),
                bias[d, half].data_ptr(),
                None if m is None else m.data_ptr(), scale, dims, plan, flag,
                idx, stream), "fused_swap_fusion_streaming sublayer")
            fused_swap_fusion_streaming.launches += 1
            state = nxt
    return state


# K6's sublayers as the custom op cobevt::swap_fusion_streaming: the final
# (B, L, H, W, D) state, before the pooling and the head
_K6 = KernelOp(
    "swap_fusion_streaming",
    "(Tensor x, Tensor? mask, Tensor bias, Tensor[] layers, int window, "
    "int heads) -> Tensor",
    lambda x, mask, bias, layers, window, heads: _layers_reference(
        x, mask, bias, unflat_layers(layers), window, heads, True),
    lambda x, mask, bias, layers, window, heads: _launch_streaming(
        x, mask, bias, unflat_layers(layers), window, heads),
    lambda x, *args: torch.empty_like(x),
    lambda x, mask, bias, layers, window, heads: _work(
        x, mask, bias, layers, window, heads, False))


def fused_swap_fusion_streaming(x, mask, agent_mask, bias_stack, layers, head,
                                window: int, heads: int,
                                mean_over_valid: bool = False, impl=None):
    """The SwapFusionEncoder at eval for states that do not stay resident
    (the cooperative-LiDAR map), one kernel call per sublayer.

    Operands as :func:`fused_swap_fusion`, except that the key mask adds
    -1e9 in f32 and ``bias_stack`` stays f32 (a :func:`pack` needs
    ``bias_dtype=torch.float32``).  Returns (B, H, W, D) in x's dtype.

    ``impl``: None (kernel for CUDA tensors, plain version for CPU
    tensors), "kernel" or "torch".  The kernel raises on a shape it does
    not take (:func:`stream_accepts`).  The sublayers are the op
    ``cobevt::swap_fusion_streaming`` as K4's call is ``cobevt::
    swap_fusion``; the agent pooling and the head are plain PyTorch on
    either path.  Inference only, like K4."""
    p = _packed(layers, bias_stack, head, x.dtype, torch.float32)
    use_valid = mean_over_valid and agent_mask is not None
    if route(impl, x, needs_grad(x, p.bias, *p.head.values())) == "plain":
        return _reference(x, mask, agent_mask, p.bias, p.layers, p.head,
                          window, heads, use_valid, mask_f32=True)
    state = _K6(
        x.contiguous(), None if mask is None else mask.float().contiguous(),
        p.bias, flat_layers(p.layers), window, heads)
    return _head_reference(state, agent_mask, p.head, use_valid)


# sublayer calls since the last reset (plain-version calls do not count):
# 2 * depth per encoder, each three kernel launches behind one C entry
fused_swap_fusion_streaming.launches = 0
