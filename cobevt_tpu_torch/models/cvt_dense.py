"""Dense CVT camera->BEV cross-attention (the baseline FAX sparsifies).

Counterpart of ``cobevt_tpu/models/cvt_dense.py`` (reference
``opv2v/opencood/models/sub_modules/cvt_modules.py:280``, and the nuScenes
twin ``cross_view_transformer/model/encoder.py:281``): every BEV query
attends to all cameras' tokens at once, one softmax over cameras x pixels,
at one fixed BEV resolution.  The JAX package computes this product outside
any Pallas kernel, so it stays two ``torch.einsum`` products here.  Their
scores, softmax and value product run in f32 whatever the model's dtype, as
the JAX body does (``preferred_element_type=float32``, then ``v`` cast to
the scores' dtype).  Channels-last; attribute paths mirror the flax names.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from einops import rearrange

from cobevt_tpu_torch.models.fax import (
    _normalize,
    bev_world_grid,
    image_plane_grid,
    on_device,
)
from cobevt_tpu_torch.nn.layers import (
    Bottleneck,
    batch_norm,
    bn_nhwc,
    conv_nhwc,
    layer_norm,
    mlp_seq,
    torch_conv,
)


def dense_bev_grid(bev_height: int, bev_width: int, h_meters: float,
                   w_meters: float, offset: float, n_blocks: int):
    """(h, w, 2) ego-frame grid at bev_size // 2^n_blocks."""
    return bev_world_grid(bev_height, bev_width, h_meters, w_meters, offset,
                          2 ** n_blocks)


class DenseCrossAttention(nn.Module):
    """Full BEV x (cameras * pixels) attention with a prenorm MLP tail
    (reference ``cvt_modules.py:92``)."""

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
        self.prenorm = layer_norm(dim)
        self.mlp = mlp_seq(dim, 2 * dim, dim)
        self.postnorm = layer_norm(dim)

    def forward(self, q, k, v, skip=None):
        """q: (b, n, H, W, d); k, v: (b, n, h, w, d) -> (b, H, W, d)."""
        b, n, H, W, _ = q.shape
        heads, dim_head = self.heads, self.dim_head
        q = rearrange(self.to_q(q), "b n H W (m e) -> b n (H W) m e",
                      m=heads) * dim_head ** -0.5
        k = rearrange(self.to_k(k), "b n h w (m e) -> b n (h w) m e",
                      m=heads)
        v = rearrange(self.to_v(v), "b n h w (m e) -> b (n h w) m e",
                      m=heads)
        # per-camera scores, then one softmax over all cameras' keys (the
        # reference's 'b n Q K -> b Q (n K)'): camera n's keys are scored
        # against camera n's positional copy of the query
        dot = torch.einsum("bnqme,bnkme->bmqnk", q.float(), k.float())
        att = F.softmax(dot.reshape(b, heads, H * W, -1), dim=-1)
        out = torch.einsum("bmqk,bkme->bqme", att, v.float())
        z = self.proj(out.reshape(b, H * W, heads * dim_head).to(q.dtype))
        if skip is not None:
            z = z + skip.reshape(b, H * W, -1)
        z = self.prenorm(z)
        z = self.postnorm(z + self.mlp(z))
        return z.reshape(b, H, W, -1)


class DenseCrossViewAttention(nn.Module):
    """Geometry embeds + dense cross attention (reference
    ``cvt_modules.py:165``)."""

    def __init__(self, feat_height: int, feat_width: int, feat_dim: int,
                 dim: int, image_height: int, image_width: int, heads: int,
                 dim_head: int, qkv_bias: bool,
                 no_image_features: bool = False, skip: bool = True):
        super().__init__()
        self.grid_args = (feat_height, feat_width, image_height, image_width)
        self.no_image_features = no_image_features
        self.skip = skip
        self.cam_embed = nn.Linear(4, dim, bias=False)
        self.img_embed = nn.Linear(4, dim, bias=False)
        self.bev_embed = nn.Linear(2, dim)
        if not no_image_features:
            self.feature_proj = nn.Sequential(
                batch_norm(feat_dim), nn.ReLU(),
                torch_conv(feat_dim, dim, 1, 1, 0, False))
        self.feature_linear = nn.Sequential(
            batch_norm(feat_dim), nn.ReLU(),
            torch_conv(feat_dim, dim, 1, 1, 0, False))
        self.cross_attend = DenseCrossAttention(dim, heads, dim_head,
                                                qkv_bias)

    @staticmethod
    def _bn_relu_conv(seq, t):
        b, n, h, w, c = t.shape
        bn, _, conv = seq
        flat = F.relu(bn_nhwc(bn, t.reshape(b * n, h, w, c)))
        return conv_nhwc(conv, flat).reshape(b, n, h, w, -1)

    def forward(self, x, world, feature, I_inv, E_inv):
        """x: (b, H, W, dim); world: (H, W, 2); feature: (b, n, h, w, c);
        I_inv: (b, n, 3, 3); E_inv: (b, n, 4, 4), both f32."""
        dtype = self.cam_embed.weight.dtype
        pixel = on_device(image_plane_grid, self.grid_args, x.device)

        c_embed = self.cam_embed(E_inv[..., -1].to(dtype))     # (b, n, d)
        cam = torch.einsum("bnij,hwj->bnhwi", I_inv, pixel)
        cam = torch.cat([cam, torch.ones_like(cam[..., :1])], dim=-1)
        d_vec = torch.einsum("bnij,bnhwj->bnhwi", E_inv, cam)
        d_embed = self.img_embed(d_vec.to(dtype))              # (b,n,h,w,d)
        img_embed = _normalize(d_embed - c_embed[:, :, None, None])

        w_embed = self.bev_embed(world.to(dtype))              # (H, W, d)
        query_pos = _normalize(w_embed[None, None]
                               - c_embed[:, :, None, None])    # (b,n,H,W,d)

        if self.no_image_features:
            key = img_embed
        else:
            key = img_embed + self._bn_relu_conv(self.feature_proj, feature)
        val = self._bn_relu_conv(self.feature_linear, feature)
        return self.cross_attend(query_pos + x[:, None], key, val,
                                 skip=x if self.skip else None)


@dataclasses.dataclass(frozen=True)
class CVTModuleConfig:
    """The ``cvm`` block of the reference's ``opcamera/cvt*.yaml`` (a copy
    of the JAX package's config)."""

    dim: int = 128
    middle: Tuple[int, ...] = (2, 2)
    backbone_output_shape: Tuple[Tuple[int, int, int], ...] = ()
    image_height: int = 512
    image_width: int = 512
    heads: int = 4
    dim_head: int = 32
    qkv_bias: bool = True
    no_image_features: bool = False
    skip: bool = True
    sigma: float = 1.0
    bev_height: int = 256
    bev_width: int = 256
    h_meters: float = 100.0
    w_meters: float = 100.0
    offset: float = 0.0
    decoder_blocks: int = 3


class _DenseBEVPrior(nn.Module):
    """Learned BEV queries, kept in the torch (dim, h, w) layout (the JAX
    package's ``_DenseBEVPrior``)."""

    def __init__(self, dim: int, sigma: float, h: int, w: int):
        super().__init__()
        self.learned_features = nn.Parameter(sigma * torch.randn(dim, h, w))

    def forward(self):
        return self.learned_features.permute(1, 2, 0)          # (h, w, dim)


class DenseStages(nn.Module):
    """The BEV prior and the stages of dense cross-view attention, each
    followed by ``middle[i]`` bottlenecks, shared by OPV2V's
    ``CrossViewModule`` and the nuScenes ``CVTNuScenesEncoder``."""

    def _build_stages(self, cfg, shapes, image_hw):
        """``cfg``: a ``CVTModuleConfig`` or a ``CVTNuScenesConfig``;
        ``shapes``: (h, w, c) of each backbone map."""
        self.grid_args = (cfg.bev_height, cfg.bev_width, cfg.h_meters,
                          cfg.w_meters, cfg.offset, cfg.decoder_blocks)
        scale = 2 ** cfg.decoder_blocks
        self.bev_embedding = _DenseBEVPrior(
            cfg.dim, cfg.sigma, cfg.bev_height // scale,
            cfg.bev_width // scale)
        self.cross_views = nn.ModuleList([
            DenseCrossViewAttention(fh, fw, fc, cfg.dim, *image_hw,
                                    cfg.heads, cfg.dim_head, cfg.qkv_bias,
                                    cfg.no_image_features, cfg.skip)
            for fh, fw, fc in shapes])
        self.layers = nn.ModuleList([
            nn.Sequential(*[Bottleneck(cfg.dim, cfg.dim // 4)
                            for _ in range(cfg.middle[i])])
            for i in range(len(shapes))])

    def _run_stages(self, feats, I_inv, E_inv, dtype):
        """feats: (b, n, h, w, c) per stage; I_inv, E_inv: (b, n, 3, 3),
        (b, n, 4, 4) in f32.  Returns the (b, H, W, dim) BEV state, which
        runs in ``dtype``."""
        world = on_device(dense_bev_grid, self.grid_args, feats[0].device)
        x = self.bev_embedding()
        x = x[None].expand(feats[0].shape[0], *x.shape).to(dtype)
        for cross_view, layers, feat in zip(self.cross_views, self.layers,
                                            feats):
            x = layers(cross_view(x, world, feat, I_inv, E_inv))
        return x


class CrossViewModule(DenseStages):
    """Dense cross-view attention + bottlenecks at one fixed BEV resolution
    over every agent's cameras (reference ``cvt_modules.py:280``)."""

    def __init__(self, config: CVTModuleConfig = CVTModuleConfig()):
        super().__init__()
        self.config = config
        self._build_stages(config, config.backbone_output_shape,
                           (config.image_height, config.image_width))

    def forward(self, features, intrinsic, extrinsic):
        """features: list of (b, l, n, h, w, c); intrinsic (b, l, n, 3, 3);
        extrinsic (b, l, n, 4, 4).  Returns (b, l, H, W, dim)."""
        cfg = self.config
        b, l, n = features[0].shape[:3]
        # inv_ex: no host sync on a check of the result
        I_inv = torch.linalg.inv_ex(
            intrinsic.reshape(b * l, n, 3, 3).float())[0]
        E_inv = extrinsic.reshape(b * l, n, 4, 4).float()
        x = self._run_stages(
            [f.reshape(b * l, n, *shape) for f, shape in
             zip(features, cfg.backbone_output_shape)],
            I_inv, E_inv, features[0].dtype)
        return x.reshape(b, l, *x.shape[1:])
