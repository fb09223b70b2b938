"""Fused cross-view window attention (K2): wrapper, plain version, CUDA launches.

Counterpart of ``cobevt_tpu/ops/fused_cross_attention.py:
fused_cross_view_attention``: one whole FAX cross-view branch (query build,
LN + Q/K/V projections, window attention, camera mean before the output
projection, skip, optional token MLP and post-LN).  The CUDA kernel is
``csrc/fused_cross_attention.cu``: four launches on the stream per branch
(K/V rows, query rows, attention, output rows), each counted; which kernels
they are, :func:`kernel_path` says.

Numerics follow the TPU body (``_kernel`` :113-216): f32 LayerNorms and
products, a cast to the compute dtype exactly where the body casts, every
weight taken in the compute dtype (the body's packed parameter stack).

Differentiable when the parameters come as the raw dicts and autograd is on:
the forward is K2, the backward differentiates the plain composite with its
attention through ``fused_window_attention_packed`` (K1 recompute + K5), as
the JAX ``_cva_bwd`` is autodiff of ``_xla_composite``.  The JAX package has
no backward kernel for this stage, so there is none here.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.dispatch import (
    KernelOp,
    check_aligned,
    check_operand,
    needs_grad,
    resolve_impl,
    route,
)
from cobevt_tpu_torch.ops.window_attention import (
    _packed_from_4d,
    _packed_to_4d,
    fused_window_attention_packed,
)
from cobevt_tpu_torch.utils import flops

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_HEAD_DIMS = (8, 16, 32)
# rows of a row-kernel block, and the shared memory a block may take
# (an H100 block's maximum, less the kernels' static arrays)
ROWS = 64
SMEM_BYTES = 232448 - 1024
LAUNCHES_PER_CALL = 4


def _pad(n: int) -> int:
    return n + 8


def ln_f32(t, gamma, beta, eps: float = 1e-5):
    """LayerNorm in f32 in the TPU body's order (``_ln_f32``)."""
    t = t.float()
    mu = t.mean(-1, keepdim=True)
    var = ((t - mu) ** 2).mean(-1, keepdim=True)
    return (t - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


# the shapes of the wgmma kernels: the FAX widths D = C (SinBEVT-nuScenes'
# stages 0-1 at 32 and 64, CorpBEVT's and stage 2's 128), the token MLP's
# hidden widths at each, the head dims of one wgmma product, the query
# segments (the cameras of a local branch: 4 on OPV2V, 6 on nuScenes)
WGMMA_HIDDEN = {32: (0, 64), 64: (0, 128), 128: (0, 128, 256)}
WGMMA_HEAD_DIMS = (16, 32)
WGMMA_SEGMENTS = (1, 4, 6)
_PATH_FLAGS = {"scalar": 0, "mma": 1, "wgmma": 2}


def kernel_path(dtype, D: int, C: int, n_heads: int, hidden: int,
                nq: int) -> str:
    """Which kernels a branch's four launches take on the card: "wgmma"
    (bf16 at D = C = 32, 64 or 128 with the MLP hidden of
    :data:`WGMMA_HIDDEN`, head dim 16 or 32, 1, 4 or 6 query segments: every
    CorpBEVT, SinBEVT-OPV2V and SinBEVT-nuScenes branch) -- persistent
    wgmma GEMMs with the weights in shared memory and K1's wgmma attention
    with the cameras as segments; "mma" (the other bf16 shapes): the row
    kernels of ``rowops.cuh`` and ``flash.cuh``'s attention on
    ``mma.sync``; "scalar" (f32).  Device-independent."""
    if dtype != torch.bfloat16:
        return "scalar"
    if (D == C and hidden in WGMMA_HIDDEN.get(D, ())
            and n_heads > 0 and C % n_heads == 0
            and C // n_heads in WGMMA_HEAD_DIMS and nq in WGMMA_SEGMENTS):
        return "wgmma"
    return "mma"


def xattn_row_maps(B: int, n: int, H: int, W: int, h: int, w: int, q_win,
                   k_win, nq: int, grid_keys: bool):
    """The tokens the rows of the three projection launches touch, by the
    index math of the kernels (``window_of`` and the row loops of
    ``csrc/fused_cross_attention.cu``), as numpy arrays: (key rows -> flat
    (b, cam, y, x) of key/val, query rows -> flat (b, y, x) of x, query rows
    -> camera, output rows -> flat (b, y, x) of the output).  Rows are
    window-major, camera-major inside a window; no tensor is copied."""
    import numpy as np
    wh, ww = q_win
    kh, kw = k_win
    X, Y = H // wh, W // ww
    gw = np.arange(B * X * Y)
    b, wx, wy = gw // (X * Y), gw % (X * Y) // Y, gw % (X * Y) % Y
    j = np.arange(n * kh * kw)
    cam, p, s_ = j // (kh * kw), j % (kh * kw) // kw, j % kw
    if grid_keys:
        y, x = p * X + wx[:, None], s_ * Y + wy[:, None]
    else:
        y, x = wx[:, None] * kh + p, wy[:, None] * kw + s_
    key = (((b[:, None] * n + cam) * h + y) * w + x).reshape(-1)
    jq = np.arange(nq * wh * ww)
    tk = jq % (wh * ww)
    pos = ((b[:, None] * H + wx[:, None] * wh + tk // ww) * W
           + wy[:, None] * ww + tk % ww)
    query_cam = np.broadcast_to(jq // (wh * ww), pos.shape).reshape(-1)
    out = pos[:, :wh * ww].reshape(-1)
    return key, pos.reshape(-1), query_cam, out


def row_smem_bytes(*widths: int) -> int:
    """Shared memory of a row kernel holding f32 tiles of these widths."""
    return ROWS * sum(_pad(w) for w in widths if w) * 4


def kernel_accepts(D: int, C: int, n_heads: int, n_keys: int,
                   hidden: int = 0) -> bool:
    """Shapes the CUDA kernel takes: head dims 8/16/32, widths that are
    multiples of 16, a multiple of 8 keys per window, and row tiles that
    fit one block's shared memory.  Device-independent."""
    if n_heads <= 0 or C % n_heads or C // n_heads not in KERNEL_HEAD_DIMS:
        return False
    if D % 16 or C % 16 or hidden % 16 or n_keys % 8:
        return False
    return max(row_smem_bytes(D, C),
               row_smem_bytes(max(C, D), D, hidden)) <= SMEM_BYTES


class PackedParams(dict):
    """K2's operands as both versions read them (:func:`pack_params`)."""


def pack_params(params, mlp=None, post_ln=None,
                dtype=torch.float32) -> PackedParams:
    """Every weight in the compute dtype, as the TPU body's packed stack
    (``_pack_params`` :219); matrices transposed to (out, in), LayerNorm
    pairs stacked as (2, D).  A caller that runs a branch many times packs
    once and passes the result as ``params``."""
    def vec(*ts):
        return torch.stack([t.reshape(-1) for t in ts]).to(dtype).contiguous()

    def mat_t(m):
        return m.t().to(dtype).contiguous()

    p = PackedParams(
        {"ln_q": vec(*params["ln_q"]), "ln_k": vec(*params["ln_k"]),
         "ln_v": vec(*params["ln_v"]),
         "wq_t": mat_t(params["wq"]), "wk_t": mat_t(params["wk"]),
         "wv_t": mat_t(params["wv"]), "wo_t": mat_t(params["wo"]),
         "bq": params["bq"].to(dtype).contiguous(),
         "bk": params["bk"].to(dtype).contiguous(),
         "bv": params["bv"].to(dtype).contiguous(),
         "bo": params["bo"].to(dtype).contiguous()})
    if mlp is not None:
        p.update(ln_m=vec(*mlp["ln"]), w1_t=mat_t(mlp["w1"]),
                 b1=mlp["b1"].to(dtype).contiguous(),
                 w2_t=mat_t(mlp["w2"]), b2=mlp["b2"].to(dtype).contiguous())
    if post_ln is not None:
        p["ln_p"] = vec(*post_ln)
    return p


def _windows(t, a: int, b: int):
    """(B, n, H, W, D) -> (B, X*Y, n*a*b, D) local windows."""
    B, n, H, W, D = t.shape
    t = t.reshape(B, n, H // a, a, W // b, b, D).permute(0, 2, 4, 1, 3, 5, 6)
    return t.reshape(B, (H // a) * (W // b), n * a * b, D)


def _grid_windows(t, a: int, b: int):
    """(B, n, H, W, D) -> (B, X*Y, n*a*b, D) grid cells: element (p, s) of
    cell (x, y) is pixel (p*X + x, s*Y + y)."""
    B, n, H, W, D = t.shape
    t = t.reshape(B, n, a, H // a, b, W // b, D).permute(0, 3, 5, 1, 2, 4, 6)
    return t.reshape(B, (H // a) * (W // b), n * a * b, D)


def packed_attention_rounded(q, k, v, n_heads: int, dtype):
    """The TPU body's attention core (``_packed_attn`` :63) on f32 values of
    packed (G, T, C) heads: f32 products, the row max over every head of
    the row, the exp rounded to ``dtype`` before both the numerator and the
    per-head sum, the sum's quotient in f32.  Returns f32."""
    q4, k4, v4 = (_packed_to_4d(t, n_heads).float() for t in (q, k, v))
    sim = torch.einsum("ghqd,ghkd->ghqk", q4, k4)
    m = sim.amax(dim=(1, 3), keepdim=True)
    e = torch.exp(sim - m).to(dtype).float()
    out = torch.einsum("ghqk,ghkd->ghqd", e, v4) / e.sum(-1, keepdim=True)
    return _packed_from_4d(out)


def _reference(x, w_embed, c_embed, key, val, p, q_win, k_win, n_heads,
               scale, add_skip, grid_keys, attention=None):
    """``attention``: None for the TPU body's core on the f32 values
    (:func:`packed_attention_rounded`), else a function of (q, k, v) in the
    compute dtype (the backward's composite takes the differentiable
    ``fused_window_attention_packed``)."""
    dt = x.dtype
    B, H, W, D = x.shape
    wh, ww = q_win
    kh, kw = k_win

    def c(t):   # the TPU body's astype(compute_dtype), kept as f32 values
        return t.to(dt).float()

    def proj(t, w_t, b):
        return t @ w_t.float().t() + b.float()

    if w_embed is not None:
        emb = c(w_embed)[None, None] - c(c_embed)[:, :, None, None]
        emb = emb / (torch.sqrt((emb * emb).sum(-1, keepdim=True)) + 1e-7)
        query = emb.to(dt) + x[:, None].to(dt)          # in the compute dtype
    else:
        query = x[:, None]
    part = _grid_windows if grid_keys else _windows
    qw = _windows(query, wh, ww)
    q = c(proj(c(ln_f32(qw, *p["ln_q"])), p["wq_t"], p["bq"]) * scale)
    k = c(proj(c(ln_f32(part(key, kh, kw), *p["ln_k"])), p["wk_t"], p["bk"]))
    v = c(proj(c(ln_f32(part(val, kh, kw), *p["ln_v"])), p["wv_t"], p["bv"]))

    Bq, nwin, Tq, C = q.shape
    Tk = k.shape[2]
    q, k, v = (q.reshape(Bq * nwin, Tq, C), k.reshape(Bq * nwin, Tk, C),
               v.reshape(Bq * nwin, Tk, C))
    if attention is None:
        out = packed_attention_rounded(q, k, v, n_heads, dt)
    else:
        out = attention(q.to(dt), k.to(dt), v.to(dt)).float()
    nq = Tq // (wh * ww)
    # camera mean, the cameras added one after another as the body adds them
    out = out.reshape(B, nwin, nq, wh * ww, C)
    acc = out[:, :, 0]
    for i in range(1, nq):
        acc = acc + out[:, :, i]
    out = acc / nq
    y = proj(c(out), p["wo_t"], p["bo"])
    X, Y = H // wh, W // ww
    y = y.reshape(B, X, Y, wh, ww, D).permute(0, 1, 3, 2, 4, 5).reshape(
        B, H, W, D)
    if add_skip:
        y = y + x.float()
    if "w1_t" in p:
        yc = c(y)
        t = c(ln_f32(yc, *p["ln_m"]))
        hid = c(F.gelu(proj(t, p["w1_t"], p["b1"])))
        y = yc + proj(hid, p["w2_t"], p["b2"])
    if "ln_p" in p:
        y = ln_f32(c(y), *p["ln_p"])
    return y.to(dt)


def _packed(params, mlp, post_ln, dtype) -> PackedParams:
    if not isinstance(params, PackedParams):
        return pack_params(params, mlp, post_ln, dtype)
    if mlp is not None or post_ln is not None:
        raise ValueError("packed params already hold the MLP and post-LN")
    if params["wq_t"].dtype != dtype:
        raise ValueError(f"params were packed in {params['wq_t'].dtype}, "
                         f"x is {dtype}")
    return params


def cross_view_attention_reference(x, w_embed, c_embed, key, val, params,
                                   q_win, k_win, n_heads: int, scale: float,
                                   add_skip: bool = True, mlp=None,
                                   post_ln=None, grid_keys: bool = False):
    """Plain PyTorch version of K2, the TPU body's chain on whole tensors
    (the layout of ``_xla_composite`` :267), rounded where the body rounds,
    the attention core's probabilities included."""
    p = _packed(params, mlp, post_ln, x.dtype)
    return _reference(x, w_embed, c_embed, key, val, p, tuple(q_win),
                      tuple(k_win), n_heads, scale, add_skip, grid_keys)


def _lib():
    lib = _build.load("fused_cross_attention")
    P, I, IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.cobevt_xattn_kv.argtypes = [P] * 10 + [IP, I, I, P]
    lib.cobevt_xattn_q.argtypes = [P] * 6 + [ctypes.c_float, P, IP, I, I, P]
    lib.cobevt_xattn_attention.argtypes = [P] * 4 + [I] * 8 + [P]
    lib.cobevt_xattn_out.argtypes = [P] * 11 + [IP] + [I] * 4 + [P]
    for fn in (lib.cobevt_xattn_kv, lib.cobevt_xattn_q,
               lib.cobevt_xattn_attention, lib.cobevt_xattn_out):
        fn.restype = I
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_kernel(x, w_embed, c_embed, key, val, p, q_win, k_win, n_heads,
                   scale, add_skip, grid_keys):
    B, H, W, D = x.shape
    _, n, h, w, _ = key.shape
    wh, ww = q_win
    kh, kw = k_win
    C = p["wq_t"].shape[0]
    hidden = p["w1_t"].shape[0] if "w1_t" in p else 0
    dt, dev = x.dtype, x.device
    if dt not in KERNEL_DTYPES:
        raise ValueError(f"K2 takes {KERNEL_DTYPES}, got {dt}")
    if H % wh or W % ww or h % kh or w % kw or \
            (H // wh, W // ww) != (h // kh, w // kw):
        raise ValueError(f"K2 needs matching window grids; got BEV {H}x{W} "
                         f"/ {q_win} and keys {h}x{w} / {k_win}")
    if not kernel_accepts(D, C, n_heads, n * kh * kw, hidden):
        raise ValueError(f"K2 does not take D={D}, C={C}, heads={n_heads}, "
                         f"{n * kh * kw} keys, hidden={hidden}")
    nq = n if w_embed is not None else 1
    check_operand("x", x, (B, H, W, D), dt, dev)
    check_operand("key", key, (B, n, h, w, D), dt, dev)
    check_operand("val", val, (B, n, h, w, D), dt, dev)
    if w_embed is not None:
        check_operand("w_embed", w_embed, (H, W, D), dt, dev)
        check_operand("c_embed", c_embed, (B, n, D), dt, dev)
    for name, t in p.items():
        check_operand(name, t, t.shape, dt, dev)
    for name, t in (("x", x), ("w_embed", w_embed), ("c_embed", c_embed),
                    ("key", key), ("val", val)):
        if t is not None:
            check_aligned(name, t)
    G, Tw = B * (H // wh) * (W // ww), wh * ww
    Tk = n * kh * kw
    dims = (ctypes.c_int * 14)(B, n, H, W, D, C, h, w, wh, ww, kh, kw, nq,
                               int(grid_keys))
    path = kernel_path(dt, D, C, n_heads, hidden, nq)
    if path == "wgmma":
        # the weights are read by TMA
        for name, t in p.items():
            check_aligned(name, t)
    flag, idx = _PATH_FLAGS[path], dev.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    k_s = torch.empty((G * Tk, C), dtype=dt, device=dev)
    v_s = torch.empty_like(k_s)
    q_s = torch.empty((G * nq * Tw, C), dtype=dt, device=dev)
    a_s = torch.empty((G * Tw, C), dtype=dt, device=dev)
    out = torch.empty_like(x)
    lib = _lib()

    def launched(err, what):
        _build.check(err, what)
        fused_cross_view_attention.launches += 1

    launched(lib.cobevt_xattn_kv(
        key.data_ptr(), val.data_ptr(), p["ln_k"].data_ptr(),
        p["ln_v"].data_ptr(), p["wk_t"].data_ptr(), p["wv_t"].data_ptr(),
        p["bk"].data_ptr(), p["bv"].data_ptr(), k_s.data_ptr(),
        v_s.data_ptr(), dims, flag, idx, stream), "fused_cross_attention kv")
    launched(lib.cobevt_xattn_q(
        x.data_ptr(), _ptr(w_embed), _ptr(c_embed), p["ln_q"].data_ptr(),
        p["wq_t"].data_ptr(), p["bq"].data_ptr(), scale, q_s.data_ptr(),
        dims, flag, idx, stream), "fused_cross_attention q")
    launched(lib.cobevt_xattn_attention(
        q_s.data_ptr(), k_s.data_ptr(), v_s.data_ptr(), a_s.data_ptr(), G,
        Tw, nq, Tk, n_heads, C, flag, idx, stream),
        "fused_cross_attention attention")
    launched(lib.cobevt_xattn_out(
        a_s.data_ptr(), x.data_ptr(), p["wo_t"].data_ptr(),
        p["bo"].data_ptr(), _ptr(p.get("ln_m")), _ptr(p.get("w1_t")),
        _ptr(p.get("b1")), _ptr(p.get("w2_t")), _ptr(p.get("b2")),
        _ptr(p.get("ln_p")), out.data_ptr(), dims, hidden, int(add_skip),
        flag, idx, stream), "fused_cross_attention out")
    return out


# the op's flat parameter list: these keys in this order, then the MLP's
# and the post-LN's where the branch has them (11, 12, 16 or 17 tensors)
PARAM_KEYS = ("ln_q", "ln_k", "ln_v", "wq_t", "wk_t", "wv_t", "wo_t", "bq",
              "bk", "bv", "bo")
MLP_KEYS = ("ln_m", "w1_t", "b1", "w2_t", "b2")


def flat_params(p: PackedParams) -> list:
    """Packed params as the op's ``Tensor[]``."""
    keys = PARAM_KEYS + (MLP_KEYS if "w1_t" in p else ()) + (
        ("ln_p",) if "ln_p" in p else ())
    if len(keys) != len(p):
        raise ValueError(f"unexpected K2 params {sorted(p)}")
    return [p[k] for k in keys]


def unflat_params(ts) -> PackedParams:
    """The inverse of :func:`flat_params`."""
    n = len(ts)
    if n not in (11, 12, 16, 17):
        raise ValueError(f"K2 takes 11, 12, 16 or 17 parameter tensors, "
                         f"got {n}")
    keys = PARAM_KEYS + (MLP_KEYS if n >= 16 else ()) + (
        ("ln_p",) if n in (12, 17) else ())
    return PackedParams(zip(keys, ts))


def _op_args(f):
    """An implementation of K2's op from one over the dict of params."""
    def impl(x, w_embed, c_embed, key, val, params, q_win, k_win, n_heads,
             scale, add_skip, grid_keys):
        return f(x, w_embed, c_embed, key, val, unflat_params(params),
                 tuple(q_win), tuple(k_win), n_heads, scale, add_skip,
                 grid_keys)
    return impl


def _work(x, w_embed, c_embed, key, val, params, q_win, k_win, *rest):
    """(operations, bytes) of one call of K2's op (``utils/flops.py``)."""
    B, H, W, D = x.shape
    _, n, h, w, _ = key.shape
    p = unflat_params(params)
    hidden = p["w1_t"].shape[0] if "w1_t" in p else 0
    return flops.k2_work(B, n, H, W, h, w, q_win, k_win, D,
                         p["wq_t"].shape[0], hidden, w_embed is not None,
                         x.dtype.itemsize)


# K2 as the custom op cobevt::cross_view_attention: the plain version on CPU
# tensors, the four launches on CUDA tensors (their scratch made inside)
_K2 = KernelOp(
    "cross_view_attention",
    "(Tensor x, Tensor? w_embed, Tensor? c_embed, Tensor key, Tensor val, "
    "Tensor[] params, int[] q_win, int[] k_win, int n_heads, float scale, "
    "bool add_skip, bool grid_keys) -> Tensor",
    _op_args(_reference), _op_args(_launch_kernel),
    lambda x, *args: torch.empty_like(x), _work)


def _forward(x, w_embed, c_embed, key, val, p, q_win, k_win, n_heads, scale,
             add_skip, grid_keys, impl):
    """``impl`` "torch": the plain version inline; else K2's op."""
    if impl == "torch":
        return _reference(x, w_embed, c_embed, key, val, p, q_win, k_win,
                          n_heads, scale, add_skip, grid_keys)
    dt = x.dtype

    def cast(t):
        return None if t is None else t.to(dt).contiguous()

    return _K2(x.contiguous(), cast(w_embed), cast(c_embed), cast(key),
               cast(val), flat_params(p), list(q_win), list(k_win), n_heads,
               float(scale), add_skip, grid_keys)


class _FusedCrossView(torch.autograd.Function):
    """K2 forward; the backward recomputes the plain composite under
    autograd (``_fused_cva`` of the JAX package).  Saves the operands only."""

    @staticmethod
    def forward(ctx, statics, spec, x, w_embed, c_embed, key, val, *leaves):
        params, mlp, post_ln = tree_unflatten(list(leaves), spec)
        p = pack_params(params, mlp, post_ln, x.dtype)
        ctx.save_for_backward(x, w_embed, c_embed, key, val, *leaves)
        ctx.statics, ctx.spec = statics, spec
        return _forward(x, w_embed, c_embed, key, val, p, *statics)

    @staticmethod
    def backward(ctx, g):
        q_win, k_win, n_heads, scale, add_skip, grid_keys, impl = ctx.statics
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, needs)]
            x, w_embed, c_embed, key, val = ins[:5]
            params, mlp, post_ln = tree_unflatten(ins[5:], ctx.spec)
            out = _reference(
                x, w_embed, c_embed, key, val,
                pack_params(params, mlp, post_ln, x.dtype), q_win, k_win,
                n_heads, scale, add_skip, grid_keys,
                attention=lambda q, k, v: fused_window_attention_packed(
                    q, k, v, n_heads, impl=impl))
            wanted = [t for t, need in zip(ins, needs) if need]
            grads = iter(torch.autograd.grad(out, wanted, g,
                                             allow_unused=True))
        return (None, None) + tuple(next(grads) if need else None
                                    for need in needs)


def fused_cross_view_attention(x, w_embed, c_embed, key, val, params,
                               q_win, k_win, n_heads: int, scale: float,
                               add_skip: bool = True, mlp=None, post_ln=None,
                               impl=None, grid_keys: bool = False):
    """One FAX cross-view branch, fused.

    x: (B, H, W, D) BEV state; w_embed: (H, W, D) world embedding or None;
    c_embed: (B, n, D) camera-center embedding or None (both or neither:
    None means the query is x alone, the grid branch and stages 1-2);
    key/val: (B, n, h, w, D) raw per-camera tensors (pre-LayerNorm);
    params: dict with ln_q/ln_k/ln_v = (gamma, beta), wq/wk/wv (D, C),
    bq/bk/bv (C,), wo (C, D), bo (D,), or the :func:`pack_params` of
    them; scale multiplies q after its bias.  ``mlp`` = {ln: (g, b), w1,
    b1, w2, b2} adds the token MLP, ``post_ln`` = (g, b) a final LayerNorm
    (packed params hold both already).  ``grid_keys``: the key windows are grid
    cells of key/val (the JAX package passes factor-swapped tensors
    instead, ``models/fax.py:493-498``).  Returns (B, H, W, D) in x's
    dtype.

    ``impl``: None (kernel for CUDA tensors, plain version for CPU
    tensors), "kernel" or "torch".  The kernel takes contiguous tensors in
    x's dtype and raises on a shape it does not take.

    Differentiable in x, w_embed, c_embed, key, val and every parameter
    when ``params`` (with ``mlp``, ``post_ln``) are the raw dicts and
    autograd is on: the backward recomputes the plain composite, its
    attention through K1 and K5 (``impl`` picks their implementation too).
    Packed params are built without autograd: a call with them is the
    eval path, the op ``cobevt::cross_view_attention`` on either device
    (the plain version inline where "torch" is asked for by name, or where
    a CPU operand needs a gradient)."""
    q_win, k_win = tuple(q_win), tuple(k_win)
    if isinstance(params, PackedParams) or not torch.is_grad_enabled():
        plain = route(impl, x, needs_grad(x, w_embed, c_embed, key,
                                          val)) == "plain"
        return _forward(x, w_embed, c_embed, key, val,
                        _packed(params, mlp, post_ln, x.dtype), q_win, k_win,
                        n_heads, scale, add_skip, grid_keys,
                        "torch" if plain else "kernel")
    impl = resolve_impl(impl, x)
    leaves, spec = tree_flatten((params, mlp, post_ln))
    statics = (q_win, k_win, n_heads, scale, add_skip, grid_keys, impl)
    return _FusedCrossView.apply(statics, spec, x, w_embed, c_embed, key, val,
                                 *leaves)


# kernel launches since the last reset (plain-version calls do not count);
# LAUNCHES_PER_CALL per branch
fused_cross_view_attention.launches = 0
