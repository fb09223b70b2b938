"""FAX: fused axial attention camera->BEV transformer (SinBEVT core).

Counterpart of ``cobevt_tpu/models/fax.py`` (reference
``opv2v/opencood/models/sub_modules/fax_modules.py``), with the JAX
package's dispatch: at eval each cross-view branch (local and grid) runs
as K2 (``ops/fused_cross_attention.py``) where :func:`fused_xattn_ok`
holds, and ``COBEVT_FUSED_XATTN=0`` or training runs the stock modules,
whose window attentions go through K1 (``ops/window_attention.py``).  The
self-attention always runs K1.  Channels-last throughout; window and grid
partitions are reshapes.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from einops import rearrange

from cobevt_tpu_torch.geometry.transforms import generate_grid, get_view_matrix
from cobevt_tpu_torch.nn.layers import (
    Bottleneck,
    batch_norm,
    bn_nhwc,
    conv_nhwc,
    layer_norm,
    mlp_seq,
    pixel_unshuffle,
    torch_conv,
)
from cobevt_tpu_torch.ops.dispatch import PackCache, tracing
from cobevt_tpu_torch.ops.fused_cross_attention import (
    fused_cross_view_attention,
    kernel_accepts,
    pack_params,
)
from cobevt_tpu_torch.ops.window_attention import fused_window_attention_packed


# ---------------------------------------------------------------------------
# static grid helpers (host-side numpy, as in the JAX package)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def bev_world_grid(bev_height: int, bev_width: int, h_meters: float,
                   w_meters: float, offset: float, scale: int) -> np.ndarray:
    """Ego-frame (x, y) world coordinates of each BEV cell at one pyramid
    scale, shape (h, w, 2)."""
    V_inv = np.linalg.inv(
        get_view_matrix(bev_height, bev_width, h_meters, w_meters, offset))
    h, w = bev_height // scale, bev_width // scale
    grid = generate_grid(h, w)                      # (3, h, w) in [0,1]
    grid[0] *= bev_width
    grid[1] *= bev_height
    world = np.einsum("ij,jhw->ihw", V_inv.astype(np.float64), grid)
    return np.ascontiguousarray(
        world[:2].transpose(1, 2, 0).astype(np.float32))  # (h, w, 2)


@functools.lru_cache(maxsize=None)
def image_plane_grid(feat_height: int, feat_width: int, image_height: int,
                     image_width: int) -> np.ndarray:
    """Pixel-coordinate grid of the feature map, shape (h, w, 3)."""
    plane = generate_grid(feat_height, feat_width)  # (3, h, w)
    plane[0] *= image_width
    plane[1] *= image_height
    return np.ascontiguousarray(plane.transpose(1, 2, 0).astype(np.float32))


def on_device(grid_fn, args: tuple, device: torch.device) -> torch.Tensor:
    """``grid_fn(*args)``, a static numpy grid, as a tensor on ``device``,
    copied there once per (grid, device): a copy from pageable host memory
    at every forward would make the host wait for the stream, so it could
    not queue the next launches while the card works.  Read-only.  Made
    outside inference mode, so that a grid a runner cached first may be
    saved for a training step's backward.  Under tracing the grid is made
    and not kept: a traced tensor must not stand in for data later."""
    if tracing():
        return torch.from_numpy(grid_fn(*args)).to(device)
    return _on_device(grid_fn, args, device)


@functools.lru_cache(maxsize=None)
def _on_device(grid_fn, args: tuple, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(grid_fn(*args)).to(device)


on_device.cache_clear = _on_device.cache_clear


@functools.lru_cache(maxsize=None)
def rel_pos_indices_2d(window: int) -> np.ndarray:
    """(w^2, w^2) index table into a (2w-1)^2 relative-position embedding."""
    pos = np.arange(window)
    gy, gx = np.meshgrid(pos, pos, indexing="ij")
    grid = np.stack([gy.ravel(), gx.ravel()], axis=-1)     # (w^2, 2)
    rel = grid[:, None] - grid[None, :] + window - 1
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


def window_partition(x, wh: int, ww: int):
    """(..., H, W, d) -> (..., H/wh, W/ww, wh, ww, d) local windows."""
    return rearrange(x, "... (x w1) (y w2) d -> ... x y w1 w2 d",
                     w1=wh, w2=ww)


def window_reverse(x):
    return rearrange(x, "... x y w1 w2 d -> ... (x w1) (y w2) d")


def grid_partition(x, wh: int, ww: int):
    """(..., H, W, d) -> (..., H/wh, W/ww, wh, ww, d) strided 'grid'
    windows: element (w1, w2) of cell (x, y) is pixel (w1*X + x, w2*Y + y)."""
    return rearrange(x, "... (w1 x) (w2 y) d -> ... x y w1 w2 d",
                     w1=wh, w2=ww)


def grid_reverse(x):
    return rearrange(x, "... x y w1 w2 d -> ... (w1 x) (w2 y) d")


def pad_divisible(x, wh: int, ww: int):
    """Zero-pad the trailing spatial dims of (..., H, W, d) to window
    multiples."""
    H, W = x.shape[-3], x.shape[-2]
    ph = (-H) % wh
    pw = (-W) % ww
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, 0, 0, pw, 0, ph))


def _normalize(t):
    return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-7)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class BEVEmbedding(nn.Module):
    """Learned BEV prior queries, kept in the torch (dim, H, W) layout."""

    def __init__(self, dim: int, sigma: float, bev_height: int,
                 bev_width: int, h_meters: float, w_meters: float,
                 offset: float, upsample_scales: Sequence[int]):
        super().__init__()
        self.grid_args = (bev_height, bev_width, h_meters, w_meters, offset)
        self.upsample_scales = tuple(upsample_scales)
        h = bev_height // upsample_scales[0]
        w = bev_width // upsample_scales[0]
        self.learned_features = nn.Parameter(
            sigma * torch.randn(dim, h, w))

    def world_grid(self, index: int, device) -> torch.Tensor:
        return on_device(bev_world_grid,
                         (*self.grid_args, self.upsample_scales[index]),
                         device)

    def forward(self):
        return self.learned_features.permute(1, 2, 0)     # (H, W, dim)


class SelfAttention(nn.Module):
    """Windowed self-attention with a 2D relative-position bias over the
    final BEV map (the map is one window of ``window_size``^2 tokens)."""

    def __init__(self, dim: int, dim_head: int = 32, dropout: float = 0.0,
                 window_size: int = 25):
        super().__init__()
        self.heads = dim // dim_head
        self.dim_head = dim_head
        self.dropout = dropout
        self.window_size = window_size
        n_rel = 2 * window_size - 1
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.rel_pos_bias = nn.Embedding(n_rel * n_rel, self.heads)
        self.to_out = nn.Sequential(nn.Linear(dim, dim, bias=False),
                                    nn.Dropout(dropout))
        self.register_buffer(
            "rel_pos_indices",
            torch.from_numpy(rel_pos_indices_2d(window_size)),
            persistent=False)

    def forward(self, x, generator=None):
        """``generator`` draws the dropout keep-mask in training."""
        B, H, W, d = x.shape
        heads = self.heads
        T = H * W
        qkv = self.to_qkv(x.reshape(B, T, d))
        q, k, v = qkv.chunk(3, dim=-1)
        q = q * (self.dim_head ** -0.5)
        # (T, T, heads) gather of the (2w-1)^2 table, emitted in the
        # packed kernel's flat (T, heads*T) layout
        bias = self.rel_pos_bias.weight.float()[self.rel_pos_indices]
        bias_flat = bias.permute(0, 2, 1).reshape(T, heads * T)
        drop_w = None
        if self.training and self.dropout > 0:
            keep = torch.rand((B, T, heads * T), device=x.device,
                              generator=generator) >= self.dropout
            drop_w = keep.to(q.dtype) / (1.0 - self.dropout)
        out = fused_window_attention_packed(
            q.contiguous(), k.contiguous(), v.contiguous(), n_heads=heads,
            bias_flat=bias_flat, weight=drop_w)
        return self.to_out(out.reshape(B, H, W, heads * self.dim_head))


class CrossWinAttention(nn.Module):
    """Windowed cross-attention: each BEV query window attends to the
    matching (local or grid) window of every camera's features."""

    def __init__(self, dim: int, heads: int, dim_head: int, qkv_bias: bool):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.to_q = nn.Sequential(layer_norm(dim),
                                  nn.Linear(dim, inner, bias=qkv_bias))
        self.to_k = nn.Sequential(layer_norm(dim),
                                  nn.Linear(dim, inner, bias=qkv_bias))
        self.to_v = nn.Sequential(layer_norm(dim),
                                  nn.Linear(dim, inner, bias=qkv_bias))
        self.proj = nn.Linear(inner, dim)

    def forward(self, q, k, v, skip=None):
        """q: (b, nq, X, Y, W1, W2, d); k, v: (b, n, X, Y, w1, w2, d).
        Returns (b, X, Y, W1, W2, d)."""
        b, nq, X, Y, W1, W2, _ = q.shape
        q = rearrange(q, "b n x y w1 w2 d -> b (x y) (n w1 w2) d")
        k = rearrange(k, "b n x y w1 w2 d -> b (x y) (n w1 w2) d")
        v = rearrange(v, "b n x y w1 w2 d -> b (x y) (n w1 w2) d")
        q = self.to_q(q) * (self.dim_head ** -0.5)
        k = self.to_k(k)
        v = self.to_v(v)

        bq, nwin, Tq, C = q.shape
        Tk = k.shape[2]
        out = fused_window_attention_packed(
            q.reshape(bq * nwin, Tq, C).contiguous(),
            k.reshape(bq * nwin, Tk, C).contiguous(),
            v.reshape(bq * nwin, Tk, C).contiguous(), n_heads=self.heads)
        out = self.proj(out.reshape(bq, nwin, Tq, C))
        out = rearrange(out, "b (x y) (n w1 w2) d -> b n x y w1 w2 d",
                        x=X, y=Y, w1=W1, w2=W2)
        out = out.mean(dim=1)
        if skip is not None:
            out = out + skip
        return out


def fused_xattn_ok(H: int, W: int, q_win, h: int, w: int, k_win, dim: int,
                   heads: int, dim_head: int, n_cams: int,
                   hidden: int) -> bool:
    """Both branches of a stage take K2 when ``COBEVT_FUSED_XATTN`` is not
    "0" (default "1", as in the JAX package), the query and key windows
    tile their maps into the same window grid (the JAX gate's tiling
    conditions, ``cobevt_tpu/models/fax.py:331-335``), and the CUDA kernel
    takes the widths (``ops/fused_cross_attention.py:kernel_accepts``, in
    place of the JAX gate's VMEM budgets).  The same on every device."""
    if os.environ.get("COBEVT_FUSED_XATTN", "1") == "0":
        return False
    if H % q_win[0] or W % q_win[1] or h % k_win[0] or w % k_win[1]:
        return False
    if (H // q_win[0], W // q_win[1]) != (h // k_win[0], w // k_win[1]):
        return False
    return kernel_accepts(dim, heads * dim_head, heads,
                          n_cams * k_win[0] * k_win[1], hidden)


def fused_xattn_train() -> bool:
    """``COBEVT_FUSED_XATTN_TRAIN=1`` (read per call, default "0") takes K2
    in training too: the cross-view branches carry no dropout and no batch
    statistics, so the fused region means the same.  The backward is
    autograd of the plain composite over K1 and K5; the switch is the A/B
    lever, as in the JAX package."""
    return os.environ.get("COBEVT_FUSED_XATTN_TRAIN", "0") == "1"


def _ln_pair(ln: nn.LayerNorm):
    return ln.weight, ln.bias


def _cross_params(attend: "CrossWinAttention") -> dict:
    """K2's parameters, in the JAX layout, from a stock module's weights
    (the JAX package's ``CrossWinAttentionParams``)."""
    def lin(seq):
        ln, dense = seq
        bias = dense.bias if dense.bias is not None else \
            dense.weight.new_zeros(dense.weight.shape[0])
        return _ln_pair(ln), dense.weight.t(), bias

    (ln_q, wq, bq), (ln_k, wk, bk), (ln_v, wv, bv) = (
        lin(attend.to_q), lin(attend.to_k), lin(attend.to_v))
    return {"ln_q": ln_q, "ln_k": ln_k, "ln_v": ln_v, "wq": wq, "bq": bq,
            "wk": wk, "bk": bk, "wv": wv, "bv": bv,
            "wo": attend.proj.weight.t(), "bo": attend.proj.bias}


def _mlp_params(prenorm: nn.LayerNorm, seq: nn.Sequential) -> dict:
    return {"ln": _ln_pair(prenorm), "w1": seq[0].weight.t(),
            "b1": seq[0].bias, "w2": seq[2].weight.t(), "b2": seq[2].bias}


class CrossViewSwapAttention(nn.Module):
    """One FAX pyramid stage: camera-geometry embeds + local-window
    cross-attention + grid cross-attention, each followed by an MLP."""

    def __init__(self, feat_height: int, feat_width: int, feat_dim: int,
                 dim: int, image_height: int, image_width: int,
                 qkv_bias: bool, heads: int, dim_head: int,
                 q_win_size: Tuple[int, int], feat_win_size: Tuple[int, int],
                 bev_embed_flag: bool, no_image_features: bool = False,
                 skip: bool = True):
        super().__init__()
        self.grid_args = (feat_height, feat_width, image_height, image_width)
        self.dim = dim
        self.heads = heads
        self.dim_head = dim_head
        self.q_win_size = tuple(q_win_size)
        self.feat_win_size = tuple(feat_win_size)
        self.bev_embed_flag = bev_embed_flag
        self.no_image_features = no_image_features
        self.skip = skip

        self.cam_embed = nn.Linear(4, dim, bias=False)
        self.img_embed = nn.Linear(4, dim, bias=False)
        if bev_embed_flag:
            self.bev_embed = nn.Linear(2, dim)
        if not no_image_features:
            self.feature_proj = nn.Sequential(
                batch_norm(feat_dim), nn.ReLU(),
                torch_conv(feat_dim, dim, 1, 1, 0, False))
        self.feature_linear = nn.Sequential(
            batch_norm(feat_dim), nn.ReLU(),
            torch_conv(feat_dim, dim, 1, 1, 0, False))
        self.cross_win_attend_1 = CrossWinAttention(dim, heads, dim_head,
                                                    qkv_bias)
        self.cross_win_attend_2 = CrossWinAttention(dim, heads, dim_head,
                                                    qkv_bias)
        self.prenorm_1 = layer_norm(dim)
        self.prenorm_2 = layer_norm(dim)
        self.mlp_1 = mlp_seq(dim, 2 * dim, dim)
        self.mlp_2 = mlp_seq(dim, 2 * dim, dim)
        self.postnorm = layer_norm(dim)
        self._packed = PackCache()   # K2's operands, per branch and dtype

    def _fused_params(self, branch: int, dtype):
        """K2's operands of the local (1) or grid (2) branch as keyword
        arguments: the attention, its MLP and, for the grid branch, the
        postnorm.  At eval packed once and reused while the weights are
        unchanged; in training the raw parameters, which carry gradients."""
        attend = getattr(self, f"cross_win_attend_{branch}")
        prenorm = getattr(self, f"prenorm_{branch}")
        mlp = getattr(self, f"mlp_{branch}")
        post = self.postnorm if branch == 2 else None
        if self.training:
            return {"params": _cross_params(attend),
                    "mlp": _mlp_params(prenorm, mlp),
                    "post_ln": None if post is None else _ln_pair(post)}
        modules = (attend, prenorm, mlp) + (() if post is None else (post,))
        return {"params": self._packed.get(
            branch, [t for m in modules for t in m.parameters()],
            lambda: pack_params(_cross_params(attend),
                                _mlp_params(prenorm, mlp),
                                None if post is None else _ln_pair(post),
                                dtype),
            dtype)}

    @staticmethod
    def _bn_relu_conv(seq, t):
        b, n, h, w, c = t.shape
        bn, _, conv = seq
        flat = F.relu(bn_nhwc(bn, t.reshape(b * n, h, w, c)))
        flat = conv_nhwc(conv, flat)
        return flat.reshape(b, n, h, w, -1)

    def forward(self, x, world, feature, I_inv, E_inv):
        """x: (b, H, W, dim) BEV state; world: (H, W, 2) ego-frame cell
        coordinates (None without the BEV embedding); feature:
        (b, n, h, w, feat_dim); I_inv: (b, n, 3, 3); E_inv: (b, n, 4, 4)."""
        dtype = self.cam_embed.weight.dtype
        pixel = on_device(image_plane_grid, self.grid_args,
                          x.device)                            # (h, w, 3)

        # camera-center embedding: last column of E_inv
        c_embed = self.cam_embed(E_inv[..., -1].to(dtype))     # (b, n, d)
        # per-pixel ray embedding: unproject pixels, then E_inv
        cam = torch.einsum("bnij,hwj->bnhwi", I_inv, pixel)
        cam = torch.cat([cam, torch.ones_like(cam[..., :1])], dim=-1)
        d_vec = torch.einsum("bnij,bnhwj->bnhwi", E_inv, cam)
        d_embed = self.img_embed(d_vec.to(dtype))              # (b,n,h,w,d)
        img_embed = _normalize(d_embed - c_embed[:, :, None, None])

        if self.no_image_features:
            key = img_embed
        else:
            key = img_embed + self._bn_relu_conv(self.feature_proj, feature)
        val = self._bn_relu_conv(self.feature_linear, feature)
        key = pad_divisible(key, *self.feat_win_size)
        val = pad_divisible(val, *self.feat_win_size)

        # eval takes K2 for both branches where the gate holds (the JAX
        # package's dispatch, cobevt_tpu/models/fax.py:417-504); training
        # takes it only with COBEVT_FUSED_XATTN_TRAIN=1, and
        # COBEVT_FUSED_XATTN=0 runs the stock modules everywhere
        H, W = x.shape[1:3]
        n, kh, kw_ = key.shape[1:4]
        use_fused = (not self.training or fused_xattn_train()) \
            and fused_xattn_ok(
            H, W, self.q_win_size, kh, kw_, self.feat_win_size, self.dim,
            self.heads, self.dim_head, n, self.mlp_1[0].out_features)
        scale = self.dim_head ** -0.5

        # --- local-window cross attention ---
        w_embed = (self.bev_embed(world.to(dtype)) if self.bev_embed_flag
                   else None)                                  # (H, W, d)
        if use_fused:
            query = fused_cross_view_attention(
                x, w_embed, c_embed if self.bev_embed_flag else None, key, val,
                q_win=self.q_win_size, k_win=self.feat_win_size,
                n_heads=self.heads, scale=scale, add_skip=self.skip,
                **self._fused_params(1, x.dtype))
        else:
            if self.bev_embed_flag:
                bev_embed = _normalize(w_embed[None, None]
                                       - c_embed[:, :, None, None])
                query = bev_embed + x[:, None]                 # (b,n,H,W,d)
            else:
                query = x[:, None]                             # (b,1,H,W,d)
            qw = window_partition(query, *self.q_win_size)
            kw = window_partition(key, *self.feat_win_size)
            vw = window_partition(val, *self.feat_win_size)
            skip1 = (window_partition(x, *self.q_win_size)
                     if self.skip else None)
            query = window_reverse(self.cross_win_attend_1(qw, kw, vw, skip1))
            query = query + self.mlp_1(self.prenorm_1(query))
        x_skip = query

        # --- grid (global) cross attention ---
        # after the local branch the query has no per-camera content, so
        # one copy stands for the reference's n identical ones (their mean
        # is the identity)
        if use_fused:
            # keys ride the grid cells by index math inside the kernel
            return fused_cross_view_attention(
                query, None, None, key, val, q_win=self.q_win_size,
                k_win=self.feat_win_size, n_heads=self.heads, scale=scale,
                add_skip=self.skip, grid_keys=True,
                **self._fused_params(2, x.dtype))
        qg = window_partition(query[:, None], *self.q_win_size)
        kg = grid_partition(key, *self.feat_win_size)
        vg = grid_partition(val, *self.feat_win_size)
        skip2 = (window_partition(x_skip, *self.q_win_size)
                 if self.skip else None)
        query = window_reverse(self.cross_win_attend_2(qg, kg, vg, skip2))
        query = query + self.mlp_2(self.prenorm_2(query))
        return self.postnorm(query)


@dataclasses.dataclass(frozen=True)
class FAXConfig:
    """Static configuration for the FAX pyramid (the ``fax:`` block of the
    reference hypes, e.g. ``opcamera/corpbevt.yaml:65-95``)."""

    dim: Tuple[int, ...] = (128, 128, 128)
    middle: Tuple[int, ...] = (2, 2, 2)
    # backbone feature shapes per stage: (h, w, c)
    backbone_output_shape: Tuple[Tuple[int, int, int], ...] = ()
    image_height: int = 512
    image_width: int = 512
    qkv_bias: bool = True
    heads: Tuple[int, ...] = (4, 4, 4)
    dim_head: Tuple[int, ...] = (32, 32, 32)
    q_win_size: Tuple[Tuple[int, int], ...] = ((16, 16), (16, 16), (32, 32))
    feat_win_size: Tuple[Tuple[int, int], ...] = ((8, 8), (8, 8), (16, 16))
    bev_embedding_flag: Tuple[bool, ...] = (True, False, False)
    no_image_features: bool = False
    skip: bool = True
    # bev embedding
    sigma: float = 1.0
    bev_height: int = 256
    bev_width: int = 256
    h_meters: float = 100.0
    w_meters: float = 100.0
    offset: float = 0.0
    upsample_scales: Tuple[int, ...] = (2, 4, 8)
    # final windowed self attention
    self_attn_dim_head: int = 32
    self_attn_dropout: float = 0.1
    self_attn_window: int = 32
    use_self_attn: bool = True


class FAXStages(nn.Module):
    """The FAX pyramid's stages, shared by OPV2V's ``FAXModule`` and the
    nuScenes ``PyramidAxialEncoder``: a BEV prior, then per stage a
    cross-view swap attention and ``middle`` bottleneck convs, and between
    stages conv3x3 -> pixel-unshuffle(2) -> conv3x3 -> BN -> ReLU ->
    conv1x1 -> BN, whose first conv narrows to ``dim // narrow`` (4 in
    OPV2V's FAX, 2 in the nuScenes encoder)."""

    def _build_stages(self, cfg, shapes, narrow: int):
        """``cfg``: the stage fields of a ``FAXConfig`` or a
        ``PyramidAxialConfig``; ``shapes``: (h, w, c) of each backbone
        map."""
        self.bev_embedding = BEVEmbedding(
            cfg.dim[0], cfg.sigma, cfg.bev_height, cfg.bev_width,
            cfg.h_meters, cfg.w_meters, cfg.offset, cfg.upsample_scales)
        self.cross_views = nn.ModuleList()
        self.layers = nn.ModuleList()
        self.downsample_layers = nn.ModuleList()
        for i, (fh, fw, fc) in enumerate(shapes):
            self.cross_views.append(CrossViewSwapAttention(
                fh, fw, fc, cfg.dim[i], cfg.image_height, cfg.image_width,
                cfg.qkv_bias, cfg.heads[i], cfg.dim_head[i],
                cfg.q_win_size[i], cfg.feat_win_size[i],
                cfg.bev_embedding_flag[i], cfg.no_image_features, cfg.skip))
            self.layers.append(nn.Sequential(*[
                Bottleneck(cfg.dim[i], cfg.dim[i] // 4)
                for _ in range(cfg.middle[i])]))
            if i < len(shapes) - 1:
                dim_in, dim_out = cfg.dim[i], cfg.dim[i + 1]
                # torch path downsample_layers.<i>.0.<j>; 1 is the
                # parameterless pixel-unshuffle, 4 the ReLU
                self.downsample_layers.append(nn.Sequential(nn.Sequential(
                    torch_conv(dim_in, dim_in // narrow, 3, 1, 1, False),
                    nn.PixelUnshuffle(2),
                    torch_conv(dim_in // narrow * 4, dim_out, 3, 1, 1,
                               False),
                    batch_norm(dim_out), nn.ReLU(),
                    torch_conv(dim_out, dim_out, 1, 1, 0, False),
                    batch_norm(dim_out))))

    def _downsample(self, x, i):
        seq = self.downsample_layers[i][0]
        x = pixel_unshuffle(conv_nhwc(seq[0], x), 2)
        x = F.relu(bn_nhwc(seq[3], conv_nhwc(seq[2], x)))
        return bn_nhwc(seq[6], conv_nhwc(seq[5], x))

    def _run_stages(self, feats, I_inv, E_inv, dtype):
        """feats: (b, n, h, w, c) per stage; I_inv: (b, n, 3, 3); E_inv:
        (b, n, 4, 4).  Returns the (b, H, W, dim[-1]) BEV state, which runs
        in ``dtype``."""
        x = self.bev_embedding()
        x = x[None].expand(feats[0].shape[0], *x.shape).to(dtype)
        for i, feat in enumerate(feats):
            world = (self.bev_embedding.world_grid(i, x.device)
                     if self.config.bev_embedding_flag[i] else None)
            x = self.cross_views[i](x, world, feat, I_inv, E_inv)
            x = self.layers[i](x)
            if i < len(feats) - 1:
                x = self._downsample(x, i)
        return x


class FAXModule(FAXStages):
    """3-stage FAX pyramid: BEV prior -> per-stage cross-view swap
    attention + bottleneck convs + pixel-unshuffle downsample -> windowed
    self-attention."""

    def __init__(self, config: FAXConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self._build_stages(cfg, cfg.backbone_output_shape, narrow=4)
        if cfg.use_self_attn:
            self.self_attn = SelfAttention(
                cfg.dim[-1], cfg.self_attn_dim_head, cfg.self_attn_dropout,
                cfg.self_attn_window)

    def forward(self, features, intrinsic, extrinsic, generator=None):
        """features: list of (b, l, n, h, w, c) per pyramid stage;
        intrinsic: (b, l, n, 3, 3); extrinsic: (b, l, n, 4, 4);
        ``generator`` draws the self-attention dropout mask in training.
        Returns (b, l, H, W, dim[-1])."""
        cfg = self.config
        b, l, n = features[0].shape[:3]
        # inv_ex: no host sync on a check of the result
        I_inv = torch.linalg.inv_ex(
            intrinsic.reshape(b * l, n, 3, 3).float())[0]
        E_inv = extrinsic.reshape(b * l, n, 4, 4).float()

        # the BEV residual stream runs in the compute dtype
        x = self._run_stages(
            [f.reshape(b * l, n, *shape) for f, shape in
             zip(features, cfg.backbone_output_shape)],
            I_inv, E_inv, features[0].dtype)
        if cfg.use_self_attn:
            x = self.self_attn(x, generator=generator)
        H, W = x.shape[1:3]
        return x.reshape(b, l, H, W, -1)
