"""Window attention: K1 (packed forward), K5 (its flash backward) and K8
(the head-major twin), each with its plain version and CUDA launch.

Counterpart of ``cobevt_tpu/ops/window_attention.py``.  One kernel serves
the three attention flavours of CorpBEVT:

  * ``CrossWinAttention`` (no bias, no mask)   -- models/fax.py
  * ``SelfAttention``     (2D rel-pos bias)    -- models/fax.py
  * ``FusionAttention``   (3D bias + key mask) -- models/fusion/swap_fusion.py

:func:`fused_window_attention_packed` is differentiable through a
``torch.autograd.Function`` that mirrors the JAX package's ``custom_vjp``
(``_fused_packed``): it saves q, k, v, bias, mask, weight and the output,
nothing of size Tq x Tk, and its backward recomputes the attention; where
the backward will be the bf16 K5, K1 also writes the row statistics K5
would otherwise take in a sweep of its own (3 G H Tq floats, each row padded
to 16 bytes: :func:`stats_pitch`; saved too).  The
backward takes K5 (the op ``cobevt::window_attention_packed_bwd``:
``csrc/window_attention_bwd.cu`` on CUDA tensors; on CPU tensors
:func:`packed_backward_reference`, inline) where
:func:`packed_bwd_kernel_ok` holds and ``COBEVT_FLASH_BWD_F32`` is not "1";
otherwise :func:`packed_backward_composite`, the plain PyTorch form of the
JAX package's XLA branch, which is no kernel there and none here.  The gate
does not look at the device.  ``COBEVT_FLASH_BWD=0`` routes forward and
backward through the plain version with stock autograd.  Both switches are
read per call.

The TPU kernel groups heads into 128-channel chunks to fill the MXU
(``_fwa_packed_jit``); that is the same math and has no counterpart here:
the CUDA kernels run one block per (window, head, query tile), the bf16
one on ``wgmma`` with TMA-staged operands (:func:`attention_tile_plan`).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.dispatch import (
    KernelOp,
    check_aligned,
    check_operand,
    needs_grad,
    resolve_impl,
    route,
)
from cobevt_tpu_torch.utils import flops

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


def _additive_mask(mask):
    return torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF)


def _packed_sim(q4, k4, n_heads, bias_flat, mask):
    """(q k^T + bias) + mask in f32, (G, H, Tq, Tk)."""
    sim = torch.einsum("ghqd,ghkd->ghqk", q4, k4)
    if bias_flat is not None:
        sim = sim + _flat_to_heads(bias_flat.float(), n_heads)[None]
    if mask is not None:
        sim = sim + _additive_mask(mask)
    return sim


def packed_row_stats_reference(q, k, n_heads, bias_flat=None, mask=None):
    """Plain version of the row statistics the forward hands K5 (the bf16
    K1 writes its own: the per-head max times log2(e) and the inverse of the
    rounded-exp sum, ``csrc/window_attention.cu``): (2, G, H, Tq) f32, the
    row max -- over every head of a row, as the TPU body takes it -- and the
    per-head sum of the exp rounded to the value dtype.  Fed to
    :func:`packed_backward_reference`, it stands for that function's own
    first sweep."""
    q4, k4 = (_packed_to_4d(t, n_heads).float() for t in (q, k))
    sim = _packed_sim(q4, k4, n_heads, bias_flat, mask)
    m = sim.amax(dim=(1, 3), keepdim=True)
    l = torch.exp(sim - m).to(q.dtype).float().sum(dim=-1)
    return torch.stack([m[..., 0].expand_as(l), l])


def packed_backward_reference(q, k, v, g, out, n_heads, bias_flat=None,
                              mask=None, stats=None):
    """Plain PyTorch version of K5, following the TPU body
    (``_packed_bwd_kernel``) cast for cast: the exp rounded to the value
    dtype feeds both the weights and their per-head sum; ``g * out`` is
    multiplied in the input dtype; ds and p are rounded to the input dtype
    for the products, which sum in f32 and are rounded once.  ``stats``: the
    row max and sum of :func:`packed_row_stats_reference`, or None to take
    them here.  Returns (dq, dk, dv, dbias_flat); dbias_flat is f32
    (Tq, H*Tk) or None."""
    dt = q.dtype
    q4, k4, v4, g4 = (_packed_to_4d(t, n_heads).float()
                      for t in (q, k, v, g))
    sim = _packed_sim(q4, k4, n_heads, bias_flat, mask)
    if stats is None:
        # the TPU body's row maximum spans every head of the row
        e = torch.exp(sim - sim.amax(dim=(1, 3), keepdim=True)).to(dt).float()
        l = e.sum(dim=-1, keepdim=True)
    else:
        e = torch.exp(sim - stats[0][..., None]).to(dt).float()
        l = stats[1][..., None]
    p32 = e * (1.0 / l)
    s = _packed_to_4d((g * out).float(), n_heads).sum(dim=-1, keepdim=True)
    da = torch.einsum("ghqd,ghkd->ghqk", g4, v4)
    ds32 = p32 * (da - s)
    ds = ds32.to(dt).float()
    dq = torch.einsum("ghqk,ghkd->ghqd", ds, k4)
    dk = torch.einsum("ghqk,ghqd->ghkd", ds, q4)
    dv = torch.einsum("ghqk,ghqd->ghkd", p32.to(dt).float(), g4)
    dbias = None
    if bias_flat is not None:
        db = ds32.sum(dim=0)                               # (H, Tq, Tk)
        dbias = db.permute(1, 0, 2).reshape(db.shape[1], -1)
    return (_packed_from_4d(dq).to(dt), _packed_from_4d(dk).to(dt),
            _packed_from_4d(dv).to(dt), dbias)


def packed_backward_composite(q, k, v, g, out, n_heads, bias_flat=None,
                              mask=None, weight=None, bwd_f32=False,
                              need_dweight=False):
    """The other backward formulation of the JAX package (the XLA branch of
    ``_fused_packed_bwd``), cast for cast: plain softmax weights, every
    (Tq, Tk)-sized tensor (p, da, dsim) rounded to ``dt`` -- the input
    dtype, or f32 with ``bwd_f32`` -- and products summed in f32.  It takes
    the post-softmax ``weight`` (the flash identity sum_d g*out =
    sum_k da*w*p holds with it).  Returns (dq, dk, dv, dbias_flat,
    dweight); dweight only with ``need_dweight``."""
    dt = torch.float32 if bwd_f32 else q.dtype
    q4, k4, v4 = (_packed_to_4d(t, n_heads).float() for t in (q, k, v))
    g4 = _packed_to_4d(g, n_heads).to(dt).float()
    out4 = _packed_to_4d(out, n_heads).to(dt).float()
    w4 = None if weight is None else _weight_to_4d(weight, n_heads)
    sim = torch.einsum("ghqd,ghkd->ghqk", q4, k4)
    if bias_flat is not None:
        sim = sim + _flat_to_heads(bias_flat.float(), n_heads)[None]
    if mask is not None:
        sim = sim + _additive_mask(mask)
    p = torch.softmax(sim, dim=-1).to(dt)
    a = p if w4 is None else p * w4.to(dt)
    s = (g4 * out4).sum(dim=-1, keepdim=True)
    dv4 = torch.einsum("ghqk,ghqd->ghkd", a.float(), g4)
    da = torch.einsum("ghqd,ghkd->ghqk", g4, v4).to(dt)
    dweight = None
    if w4 is not None:
        if need_dweight:
            dw4 = (p.float() * da.float()).to(weight.dtype)
            dweight = dw4.permute(0, 2, 1, 3).reshape(weight.shape)
        ds = da * w4.to(dt)
    else:
        ds = da
    dsim = (p.float() * (ds.float() - s)).to(dt).float()
    dq4 = torch.einsum("ghqk,ghkd->ghqd", dsim, k4)
    dk4 = torch.einsum("ghqk,ghqd->ghkd", dsim, q4)
    dbias = None
    if bias_flat is not None:
        db = dsim.sum(dim=0)
        dbias = db.permute(1, 0, 2).reshape(db.shape[1], -1).to(
            bias_flat.dtype)
    return (_packed_from_4d(dq4).to(q.dtype), _packed_from_4d(dk4).to(k.dtype),
            _packed_from_4d(dv4).to(v.dtype), dbias, dweight)


def flash_bwd_enabled() -> bool:
    """``COBEVT_FLASH_BWD=0`` routes window attention through the plain
    version with stock autograd (the JAX package's A/B lever)."""
    return os.environ.get("COBEVT_FLASH_BWD", "1") != "0"


def bwd_f32_enabled() -> bool:
    """``COBEVT_FLASH_BWD_F32=1`` takes the composite backward with its
    (Tq, Tk)-sized tensors in f32."""
    return os.environ.get("COBEVT_FLASH_BWD_F32", "0") == "1"


def packed_bwd_kernel_ok(q, k, weight, n_heads) -> bool:
    """Whether a backward takes K5.  What is semantics in the JAX gate
    (``_packed_bwd_pallas_ok``) stays: no post-softmax weight.  Its Tq % 8,
    lane and VMEM conditions are TPU tiling (the sublane of 8 rows, 128
    lanes); in their place stands what the CUDA kernel takes
    (:func:`check_k5_shapes`): any Tq, Tk a multiple of 8, head dim 16 or
    32, f32 or bf16.  So the nuScenes windows of 100 and 625 queries take
    K5 here where the JAX package takes its XLA composite.  The same on
    every device."""
    _, Tq, C = q.shape
    Tk = k.shape[1]
    return (weight is None and Tq >= 1 and Tk % 8 == 0
            and C % n_heads == 0 and C // n_heads in _KERNEL_HEAD_DIMS
            and q.dtype in _KERNEL_DTYPES)


def stats_pitch(Tq: int) -> int:
    """Floats between two rows of the (3, G, H, pitch) row-statistics
    scratch that K1 writes and K5 reads: Tq rounded up to 4, so every
    (window, head) row starts on 16 bytes, as K5's TMA map of it needs.
    Equal to Tq wherever Tq % 4 == 0.  The one place the pitch is chosen:
    the launches pass the scratch's row stride to both kernels."""
    return -(-Tq // 4) * 4


def stats_scratch(G: int, H: int, Tq: int, device):
    """K5's row-statistics scratch for G windows of H heads and Tq rows;
    the entries past Tq of a row are never read as a row's statistics."""
    return torch.empty((3, G, H, stats_pitch(Tq)), dtype=torch.float32,
                       device=device)


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_ptr: int, n_int: int):
    """A C entry point of the window-attention libraries: ``n_ptr``
    pointers, ``n_int`` ints, then the stream."""
    lib = _build.load("window_attention_bwd" if name.endswith("_bwd")
                      else "window_attention")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


# the bf16 kernel's query rows per block: one warpgroup
_TILE_ROWS = 64


def attention_tile_plan(G: int, H: int, Tq: int):
    """Query rows per block of the bf16 kernel and its number of blocks:
    (64, G * H * ceil(Tq / 64)), one warpgroup a block.  Blocks of 64 rows
    keep six warpgroups on an SM; the kernel is bound by latency, and on
    the H100 two warpgroups sharing 128 rows, or 128-key stages, ran slower
    wherever they applied (fewer warpgroups an SM)."""
    return _TILE_ROWS, G * H * -(-Tq // _TILE_ROWS)


def bwd_tile_plan(G: int, H: int, Tq: int, Tk: int):
    """K5's bf16 grids: (rows a block owns, dq blocks, dk/dv blocks).  A
    dq block owns 64 query rows of one (window, head) and sweeps its keys;
    a dk/dv block owns 64 keys and sweeps the queries.  Both walk the tiles
    fastest and the windows slowest (:func:`bwd_block_coords`)."""
    return (_TILE_ROWS, G * H * -(-Tq // _TILE_ROWS),
            G * H * -(-Tk // _TILE_ROWS))


# one wave of K5's blocks on 132 SMs at four blocks an SM
_WAVE = 132 * 4


def dbias_plan(G: int, H: int, Tq: int, Tk: int, dtype=torch.bfloat16):
    """K5's dbias in a fixed order: (P chunks, windows a chunk, bytes of the
    (P, Tq, H*Tk) f32 partial buffer).  The windows are cut into P chunks
    of consecutive windows; a block sums its chunk's windows in order into
    the chunk's slot, and one more launch adds the P slots in order (none
    when P is 1: the slot is dbias itself, 0 extra bytes).  bf16: a block
    of the dbias launch owns a 64 x 64 tile (query tile, head, key tile) in
    registers; f32: a block of the scalar dq kernel owns 64 query rows of a
    head, each entry added by the one thread that owns it.  P is the most
    chunks whose blocks fit one wave, so no SM idles, and at most G."""
    blocks = H * -(-Tq // _TILE_ROWS)
    if dtype == torch.bfloat16:
        blocks *= -(-Tk // _TILE_ROWS)
    wpc = -(-G // max(1, _WAVE // blocks))
    chunks = -(-G // wpc)
    return chunks, wpc, (chunks * Tq * H * Tk * 4 if chunks > 1 else 0)


def bwd_block_coords(block: int, H: int, T: int):
    """(window, head, first row) of K5 block ``block`` in a grid over T
    rows (Tq for the dq launch, Tk for the dk/dv launch), as the kernels
    decompose ``blockIdx.x``; the block's TMA boxes cover rows
    [first, first + 64), zero-filled past T."""
    tiles = -(-T // _TILE_ROWS)
    return (block // (tiles * H), block // tiles % H,
            block % tiles * _TILE_ROWS)


def _check_tma_bases(**operands):
    """Raise unless every operand present starts on a 16-byte boundary:
    the bf16 kernel reads them all through TMA."""
    for name, t in operands.items():
        if t is not None:
            check_aligned(name, t)


def _check_dtype_and_head_dim(what, dtype, D):
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{what} takes {_KERNEL_DTYPES}, got {dtype}")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{what} takes head dims {_KERNEL_HEAD_DIMS}; got "
                         f"{D}")


def check_k1_shapes(dtype, Tq, Tk, D):
    """K1 takes any Tq >= 1: its query boxes are cut at Tq by the tensor
    map (TMA zero-fills the rows past it) and rows past Tq are not stored,
    so the nuScenes windows (10 x 10 = 100, 25 x 25 = 625 queries) run as
    they are.  Tk stays a multiple of 8: a thread owns two adjacent keys of
    each 8-key group, and both fall past Tk together."""
    _check_dtype_and_head_dim("K1", dtype, D)
    if Tq < 1 or Tk % 8:
        raise ValueError(f"K1 takes Tq >= 1 and Tk multiples of 8; got "
                         f"{Tq}, {Tk}")


def check_k5_shapes(dtype, Tq, Tk, D):
    """K5 takes any Tq >= 1, as K1 does: its q, g and out maps cut the last
    tile at Tq (TMA zero-fills the rows past it), the row statistics of
    those rows read 0, which makes their weights exactly 0, and their dq is
    not stored.  Tk stays a multiple of 8 (K1's reason)."""
    _check_dtype_and_head_dim("K5", dtype, D)
    if Tq < 1 or Tk % 8:
        raise ValueError(f"K5 takes Tq >= 1 and Tk multiples of 8; got "
                         f"{Tq}, {Tk}")


def check_k8_shapes(dtype, Tq, Tk, D):
    """K8's shapes: Tq and Tk multiples of 8 (no model path sends it
    another)."""
    _check_dtype_and_head_dim("K8", dtype, D)
    if Tq % 8 or Tk % 8:
        raise ValueError(f"K8 takes Tq, Tk multiples of 8; got {Tq}, {Tk}")


def _launch_kernel(q, k, v, n_heads, bias_flat, mask, weight, stats=None):
    """K1; ``stats``: None, or (bf16, no weight) K5's f32 scratch
    (:func:`stats_scratch`), whose first two planes the kernel fills."""
    G, Tq, C = q.shape
    Tk = k.shape[1]
    if C % n_heads:
        raise ValueError(f"K1: C={C} does not divide over {n_heads} heads")
    check_k1_shapes(q.dtype, Tq, Tk, C // n_heads)
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
    if stats is not None:
        check_operand("stats", stats, (3, G, n_heads, stats_pitch(Tq)),
                      torch.float32, dev)
    _check_tma_bases(q=q, k=k, v=v, bias_flat=bias_flat, mask=mask,
                     weight=weight)
    out = torch.empty_like(q)
    err = _entry("cobevt_window_attention", 8, 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias_flat),
        _ptr(mask), _ptr(weight), out.data_ptr(), _ptr(stats), G, Tq, Tk,
        n_heads, C // n_heads, 0 if stats is None else stats.stride(2),
        int(q.dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "window_attention")
    fused_window_attention_packed.launches += 1
    return out


def _k1_plain(q, k, v, n_heads, bias_flat, mask, weight, stats):
    if stats is not None:
        raise ValueError("the row-statistics scratch is filled by the CUDA "
                         "kernel only")
    return packed_attention_reference(q, k, v, n_heads, bias_flat, mask,
                                      weight)


# K1 as the custom op cobevt::window_attention_packed: the plain version on
# CPU tensors, the kernel on CUDA tensors (``stats``, K5's scratch, written)
_K1 = KernelOp(
    "window_attention_packed",
    "(Tensor q, Tensor k, Tensor v, int n_heads, Tensor? bias_flat, "
    "Tensor? mask, Tensor? weight, Tensor(a!)? stats) -> Tensor",
    _k1_plain, _launch_kernel,
    lambda q, k, v, n_heads, bias_flat, mask, weight, stats:
    torch.empty_like(q), flops.k1_work, mutates_args=("stats",))


def _launch_bwd_kernel(q, k, v, g, out, n_heads, bias_flat, mask,
                       stats=None):
    """K5; ``stats``: None (the kernel takes its own row statistics), or the
    scratch K1 filled for these operands (bf16)."""
    G, Tq, C = q.shape
    Tk = k.shape[1]
    if C % n_heads:
        raise ValueError(f"K5: C={C} does not divide over {n_heads} heads")
    check_k5_shapes(q.dtype, Tq, Tk, C // n_heads)
    dev = q.device
    for name, t, T in (("q", q, Tq), ("k", k, Tk), ("v", v, Tk),
                       ("g", g, Tq), ("out", out, Tq)):
        check_operand(name, t, (G, T, C), q.dtype, dev)
    HTk = n_heads * Tk
    dbias = part = None
    wpc = 1
    if bias_flat is not None:
        check_operand("bias_flat", bias_flat, (Tq, HTk), torch.float32, dev)
        dbias = torch.empty_like(bias_flat)
        chunks, wpc, _ = dbias_plan(G, n_heads, Tq, Tk, q.dtype)
        # each chunk's slot is written whole, then the slots are added
        part = dbias if chunks == 1 else torch.empty(
            (chunks, Tq, HTk), dtype=torch.float32, device=dev)
    if mask is not None:
        check_operand("mask", mask, (G, Tk), torch.float32, dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # per (window, head, query row): the row max (bf16: times log2(e)), the
    # sum of the rounded exp (bf16: its inverse) and the flash rowsum
    stats_ready = stats is not None
    if stats_ready:
        check_operand("stats", stats, (3, G, n_heads, stats_pitch(Tq)),
                      torch.float32, dev)
    else:
        stats = stats_scratch(G, n_heads, Tq, dev)
    _check_tma_bases(q=q, k=k, v=v, g=g, out=out, bias_flat=bias_flat,
                     mask=mask, stats=stats)
    err = _entry("cobevt_window_attention_bwd", 13, 10)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        out.data_ptr(), _ptr(bias_flat), _ptr(mask), stats.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dbias), _ptr(part),
        G, Tq, Tk, n_heads, C // n_heads, stats.stride(2), wpc,
        int(q.dtype == torch.bfloat16), int(stats_ready), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "window_attention_bwd")
    fused_window_attention_packed_bwd.launches += 1
    return dq, dk, dv, dbias


def _no_dbias(q):
    """The op's dbias where there is no bias: an empty f32 tensor (an op
    returns a tensor in every output)."""
    return q.new_empty((0,), dtype=torch.float32)


def _k5_plain(q, k, v, g, out, n_heads, bias_flat, mask, stats):
    if stats is not None:
        raise ValueError("the row-statistics scratch is filled by the CUDA "
                         "kernel only")
    dq, dk, dv, dbias = packed_backward_reference(q, k, v, g, out, n_heads,
                                                  bias_flat, mask)
    return dq, dk, dv, _no_dbias(q) if dbias is None else dbias


def _k5_launch(q, k, v, g, out, n_heads, bias_flat, mask, stats):
    dq, dk, dv, dbias = _launch_bwd_kernel(q, k, v, g, out, n_heads,
                                           bias_flat, mask, stats)
    return dq, dk, dv, _no_dbias(q) if dbias is None else dbias


# K5 as the custom op cobevt::window_attention_packed_bwd: the plain version
# on CPU tensors, the kernel on CUDA tensors (``stats``, the scratch K1
# filled: read, and its third plane, the flash rowsum, written); dbias an
# empty f32 tensor where there is no bias
_K5 = KernelOp(
    "window_attention_packed_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor g, Tensor out, int n_heads, "
    "Tensor? bias_flat, Tensor? mask, Tensor(a!)? stats) -> "
    "(Tensor, Tensor, Tensor, Tensor)",
    _k5_plain, _k5_launch,
    lambda q, k, v, g, out, n_heads, bias_flat, mask, stats: (
        torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
        _no_dbias(q) if bias_flat is None else torch.empty_like(bias_flat)),
    flops.k5_work, mutates_args=("stats",))


def fused_window_attention_packed_bwd(q, k, v, g, out, n_heads: int,
                                      bias_flat=None, mask=None, impl=None):
    """K5: the flash backward of :func:`fused_window_attention_packed`
    without a post-softmax weight.  q, g (the output's gradient), out
    (G, Tq, H*D) and k, v (G, Tk, H*D) in one dtype; bias_flat (Tq, H*Tk)
    f32 or None; mask (G, Tk) or None.  Returns (dq, dk, dv, dbias_flat)
    with dbias_flat f32, summed over the windows, or None.

    ``impl`` as in the forward.  One call is two kernel launches in bf16
    (dq with the row statistics, then dk/dv: :func:`bwd_tile_plan`) and
    three in f32, behind one C entry point, and counts once; with a bias,
    bf16 adds a dbias launch (blocks owning 64 x 64 tiles of dbias, each
    summing a chunk of windows in order), and both add the chunks' partials
    in order (:func:`dbias_plan`).  No dbias entry has two writers and
    every sum has a fixed order, so dq, dk, dv and dbias repeat bit for
    bit."""
    return _packed_bwd(q, k, v, g, out, n_heads, bias_flat, mask,
                       resolve_impl(impl, q))


def _packed_bwd(q, k, v, g, out, n_heads, bias_flat, mask, impl,
                stats=None):
    """K5 or its plain version; ``stats``: K1's statistics scratch (kernel)
    or :func:`packed_row_stats_reference` (plain), or None."""
    if impl == "torch":
        return packed_backward_reference(q, k, v, g, out, n_heads, bias_flat,
                                         mask, stats)
    if bias_flat is not None:
        bias_flat = bias_flat.float().contiguous()
    if mask is not None:
        mask = mask.float().contiguous()
    dq, dk, dv, dbias = _K5(q.contiguous(), k.contiguous(), v.contiguous(),
                            g.contiguous(), out.contiguous(), n_heads,
                            bias_flat, mask, stats)
    return dq, dk, dv, None if bias_flat is None else dbias


def _packed_forward(q, k, v, n_heads, bias_flat, mask, weight, impl,
                    stats=None):
    """``impl`` "torch": the plain version inline; else K1's op."""
    if impl == "torch":
        return packed_attention_reference(q, k, v, n_heads, bias_flat, mask,
                                          weight)
    if bias_flat is not None:
        bias_flat = bias_flat.float().contiguous()
    if mask is not None:
        mask = mask.float().contiguous()
    if weight is not None:
        weight = weight.to(q.dtype).contiguous()
    return _K1(q, k, v, n_heads, bias_flat, mask, weight, stats)


class _FusedPacked(torch.autograd.Function):
    """K1 forward, recompute backward (``_fused_packed`` of the JAX
    package).  Saves the operands and the output, and where the backward
    will be the bf16 K5 the row statistics K1 wrote for it (3 G H Tq
    floats), so K5 skips its own statistics sweep; nothing of size
    Tq x Tk."""

    @staticmethod
    def forward(ctx, q, k, v, bias_flat, mask, weight, n_heads, impl,
                bwd_f32):
        stats = None
        if (impl == "kernel" and q.dtype == torch.bfloat16 and not bwd_f32
                and packed_bwd_kernel_ok(q, k, weight, n_heads)):
            stats = stats_scratch(q.shape[0], n_heads, q.shape[1], q.device)
        out = _packed_forward(q, k, v, n_heads, bias_flat, mask, weight, impl,
                              stats)
        ctx.save_for_backward(q, k, v, bias_flat, mask, weight, out, stats)
        ctx.n_heads, ctx.impl, ctx.bwd_f32 = n_heads, impl, bwd_f32
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias_flat, mask, weight, out, stats = ctx.saved_tensors
        n_heads = ctx.n_heads
        dweight = None
        if not ctx.bwd_f32 and packed_bwd_kernel_ok(q, k, weight, n_heads):
            dq, dk, dv, dbias = _packed_bwd(q, k, v, g, out, n_heads,
                                            bias_flat, mask, ctx.impl, stats)
        else:
            dq, dk, dv, dbias, dweight = packed_backward_composite(
                q, k, v, g, out, n_heads, bias_flat, mask, weight,
                bwd_f32=ctx.bwd_f32,
                need_dweight=weight is not None and ctx.needs_input_grad[5])
        if dbias is not None:
            dbias = dbias.to(bias_flat.dtype)
        # the mask gets no gradient (JAX returns zeros for it)
        return dq, dk, dv, dbias, None, dweight, None, None, None


def fused_window_attention_packed(q, k, v, n_heads: int, bias_flat=None,
                                  mask=None, weight=None, impl=None):
    """Packed-layout attention: q (G, Tq, H*D) pre-scaled, k/v
    (G, Tk, H*D) with heads interleaved in the channel axis; bias_flat
    (Tq, H*Tk) f32 with column block h holding head h's bias, or None;
    mask (G, Tk) (keys with mask <= 0 get -1e9 added), or None; weight
    (G, Tq, H*Tk) post-softmax multiplicative weights that scale the
    numerator only (attention dropout), or None.  Returns (G, Tq, H*D) in
    q's dtype.  Differentiable in q, k, v, bias_flat and weight; see the
    module docstring for which backward runs.

    ``impl``: None (kernel for CUDA tensors, plain version for CPU
    tensors), "kernel" or "torch"; it also picks K5's implementation in
    the backward.  The kernel path takes contiguous tensors, casts bias and
    mask to f32 and weight to q's dtype.  Where no gradient can flow the
    call is the op ``cobevt::window_attention_packed`` on either device
    (unless "torch" is asked for by name); under autograd the plain
    composite runs inline on CPU tensors and the autograd Function calls
    the op on CUDA tensors."""
    if weight is not None and mask is not None:
        raise ValueError("weight+mask combination not implemented")
    if not flash_bwd_enabled():
        return packed_attention_reference(q, k, v, n_heads, bias_flat, mask,
                                          weight)
    if not needs_grad(q, k, v, bias_flat, weight):
        # no gradient can flow: the forward alone, without the autograd
        # Function's bookkeeping on the host
        return _packed_forward(q, k, v, n_heads, bias_flat, mask, weight,
                               "torch" if route(impl, q) == "plain"
                               else "kernel")
    impl = resolve_impl(impl, q)
    return _FusedPacked.apply(q, k, v, bias_flat, mask, weight, n_heads,
                              impl, bwd_f32_enabled())


# ---------------------------------------------------------------------------
# K8: the head-major variant
# ---------------------------------------------------------------------------

def window_attention_reference(q, k, v, bias=None, mask=None):
    """Plain PyTorch version of K8 (the JAX ``_xla_reference``): q
    (G, H, Tq, D), k/v (G, H, Tk, D), bias (H, Tq, Tk), mask (G, Tk);
    products and softmax in f32, output in q's dtype."""
    sim = torch.einsum("ghqd,ghkd->ghqk", q.float(), k.float())
    if bias is not None:
        sim = sim + bias.float()[None]
    if mask is not None:
        sim = sim + _additive_mask(mask)
    attn = torch.softmax(sim, dim=-1)
    return torch.einsum("ghqk,ghkd->ghqd", attn, v.float()).to(q.dtype)


def window_attention_backward(q, k, v, g, out, bias=None, mask=None,
                              bwd_f32=False):
    """Backward of K8, the plain PyTorch form of the JAX package's
    ``_fused_bwd`` (XLA there, so no kernel here): flash rowsum from the
    saved output, (Tq, Tk)-sized tensors rounded to the input dtype (f32
    with ``bwd_f32``), sums in f32.  Returns (dq, dk, dv, dbias)."""
    dt = torch.float32 if bwd_f32 else q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    sim = torch.einsum("ghqd,ghkd->ghqk", qf, kf)
    if bias is not None:
        sim = sim + bias.float()[None]
    if mask is not None:
        sim = sim + _additive_mask(mask)
    p = torch.softmax(sim, dim=-1).to(dt).float()
    gf = g.to(dt).float()
    s = (gf * out.to(dt).float()).sum(dim=-1, keepdim=True)
    dv = torch.einsum("ghqk,ghqd->ghkd", p, gf)
    dp = torch.einsum("ghqd,ghkd->ghqk", gf, vf).to(dt).float()
    ds = (p * (dp - s)).to(dt).float()
    dq = torch.einsum("ghqk,ghkd->ghqd", ds, kf)
    dk = torch.einsum("ghqk,ghqd->ghkd", ds, qf)
    dbias = None if bias is None else ds.sum(dim=0).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _launch_hm_kernel(q, k, v, bias, mask):
    G, H, Tq, D = q.shape
    Tk = k.shape[2]
    check_k8_shapes(q.dtype, Tq, Tk, D)
    dev = q.device
    check_operand("q", q, (G, H, Tq, D), q.dtype, dev)
    check_operand("k", k, (G, H, Tk, D), q.dtype, dev)
    check_operand("v", v, (G, H, Tk, D), q.dtype, dev)
    if bias is not None:
        check_operand("bias", bias, (H, Tq, Tk), torch.float32, dev)
    if mask is not None:
        check_operand("mask", mask, (G, Tk), torch.float32, dev)
    _check_tma_bases(q=q, k=k, v=v, bias=bias, mask=mask)
    out = torch.empty_like(q)
    err = _entry("cobevt_window_attention_hm", 6, 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(mask),
        out.data_ptr(), G, Tq, Tk, H, D, int(q.dtype == torch.bfloat16),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "window_attention (head-major)")
    fused_window_attention.launches += 1
    return out


# K8 as the custom op cobevt::window_attention
_K8 = KernelOp(
    "window_attention",
    "(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor? mask) -> Tensor",
    window_attention_reference, _launch_hm_kernel,
    lambda q, k, v, bias, mask: torch.empty_like(q), flops.k8_work)


def _hm_forward(q, k, v, bias, mask, impl):
    """``impl`` "torch": the plain version inline; else K8's op."""
    if impl == "torch":
        return window_attention_reference(q, k, v, bias, mask)
    return _K8(
        q.contiguous(), k.contiguous(), v.contiguous(),
        None if bias is None else bias.float().contiguous(),
        None if mask is None else mask.float().contiguous())


class _Fused(torch.autograd.Function):
    """K8 forward, recompute backward (``_fused`` of the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, impl, bwd_f32):
        out = _hm_forward(q, k, v, bias, mask, impl)
        ctx.save_for_backward(q, k, v, bias, mask, out)
        ctx.bwd_f32 = bwd_f32
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask, out = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_backward(
            q, k, v, g, out, bias, mask, ctx.bwd_f32)
        return dq, dk, dv, dbias, None, None, None


def fused_window_attention(q, k, v, bias=None, mask=None, impl=None):
    """K8, head-major attention: q (G, H, Tq, D) pre-scaled, k/v
    (G, H, Tk, D), bias (H, Tq, Tk) or None, mask (G, Tk) or None.
    Returns (G, H, Tq, D) in q's dtype.  Differentiable: the backward
    recomputes the attention in plain PyTorch, as the JAX package's does
    in XLA.  ``impl``, the op (``cobevt::window_attention``) and the two
    ``COBEVT_FLASH_BWD*`` switches as in
    :func:`fused_window_attention_packed`."""
    if not flash_bwd_enabled():
        return window_attention_reference(q, k, v, bias, mask)
    if not needs_grad(q, k, v, bias):
        return _hm_forward(q, k, v, bias, mask,
                           "torch" if route(impl, q) == "plain"
                           else "kernel")
    impl = resolve_impl(impl, q)
    return _Fused.apply(q, k, v, bias, mask, impl, bwd_f32_enabled())


# kernel launches since the last reset (plain-version calls do not count)
fused_window_attention_packed.launches = 0
fused_window_attention_packed_bwd.launches = 0
fused_window_attention.launches = 0
