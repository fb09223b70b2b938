"""Baseline multi-agent fusion zoo: F-Cooper max, per-pixel attention,
split attention and the CAV transformer.

Counterpart of ``cobevt_tpu/models/fusion/zoo.py``.  Every module takes the
padded layout x (B, L, H, W, C) with zeroed padding rows and masks the
padded agents on the key side, which for the valid agents equals the
reference's ragged ``record_len`` loops:

  * max fusion     -- reference ``fusion_modules/f_cooper_fuse.py:10`` / :30
  * AttFusion      -- ``fusion_modules/self_attn.py:36``
  * SplitAttn      -- ``fusion_modules/split_attn.py:32``
  * CavAttention / BaseEncoder / BaseTransformer --
                      ``models/base_transformer.py:127`` / :322 / :342

Attention scores, softmax and the value product run in f32, as in the JAX
package (``preferred_element_type=float32``); dropouts draw from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from einops import rearrange

from cobevt_tpu_torch.nn.layers import dropout, layer_norm

NEG_INF = -1e9


def max_fusion(x, mask=None):
    """Elementwise max over the agents of (B, L, H, W, C).

    With ``mask`` (B, L): the max over valid agents only.  Without: the max
    over the padded stack, zero rows included."""
    if mask is None:
        return x.max(dim=1).values
    neg = torch.where(mask[:, :, None, None, None] > 0, x,
                      torch.full_like(x, NEG_INF))
    return neg.max(dim=1).values


def _key_bias(mask):
    """0 where a key is valid, NEG_INF where it is masked, in f32."""
    return torch.where(mask > 0, 0.0, NEG_INF).float()


class AttFusion(nn.Module):
    """Per-pixel scaled-dot-product attention across agents; returns the
    ego (row 0) context.  No parameters."""

    def __init__(self, feature_dim: int):
        super().__init__()
        self.feature_dim = feature_dim

    def forward(self, x, mask=None):
        """x: (B, L, H, W, C); mask: (B, L) or None -> (B, H, W, C)."""
        B, L, H, W, C = x.shape
        t = rearrange(x, "b l h w c -> b (h w) l c").float()
        sim = torch.einsum("bpic,bpjc->bpij", t, t)
        sim = sim / torch.sqrt(torch.tensor(float(self.feature_dim)))
        if mask is not None:
            sim = sim + _key_bias(mask[:, None, None, :])
        attn = F.softmax(sim, dim=-1)
        ego = torch.einsum("bpij,bpjc->bpic", attn, t)[:, :, 0]
        return ego.reshape(B, H, W, C).to(x.dtype)


class SplitAttn(nn.Module):
    """Radix-3 split attention over three window-scale branches (defined
    but unused in the reference; kept for capability parity)."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.input_dim = input_dim
        self.fc1 = nn.Linear(input_dim, input_dim, bias=False)
        self.bn1 = layer_norm(input_dim)
        self.fc2 = nn.Linear(input_dim, 3 * input_dim, bias=False)

    def forward(self, windows):
        """windows: [(B, L, H, W, C)] * 3 -> (B, L, H, W, C)."""
        if len(windows) != 3:
            raise ValueError(f"SplitAttn takes 3 branches, got {len(windows)}")
        sw, mw, bw = windows
        gap = (sw + mw + bw).mean(dim=(2, 3), keepdim=True)
        gap = F.relu(self.bn1(self.fc1(gap)))
        B, L = gap.shape[:2]
        # radix softmax over the 3 branches, per channel
        a = F.softmax(self.fc2(gap).reshape(B, L, 1, 1, 3, self.input_dim),
                      dim=4)
        return sw * a[..., 0, :] + mw * a[..., 1, :] + bw * a[..., 2, :]


class CavAttention(nn.Module):
    """Masked per-pixel attention across agents, heads batched."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 dropout: float = 0.1):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.dropout = dropout
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        # torch name to_out.0; 1 is the parameterless dropout
        self.to_out = nn.Sequential(nn.Linear(inner, dim), nn.Dropout(dropout))

    def forward(self, x, mask, generator=None):
        """x: (B, L, H, W, C); mask: (B, H, W, 1, L) spatial key mask."""
        t = rearrange(x, "b l h w c -> b h w l c")
        q, k, v = (rearrange(z, "b h w l (m c) -> b m h w l c", m=self.heads)
                   for z in self.to_qkv(t).chunk(3, dim=-1))
        sim = torch.einsum("bmhwic,bmhwjc->bmhwij", q.float(), k.float())
        sim = sim * self.dim_head ** -0.5 + _key_bias(mask[:, None])
        attn = F.softmax(sim, dim=-1)
        out = torch.einsum("bmhwij,bmhwjc->bmhwic", attn, v.float())
        out = rearrange(out, "b m h w l c -> b h w l (m c)")
        out = self.to_out[0](out.to(t.dtype))
        out = dropout(out, self.dropout, self.training, generator)
        return rearrange(out, "b h w l c -> b l h w c").to(x.dtype)


class _FeedForwardPlain(nn.Module):
    """Linear -> GELU -> Dropout -> Linear -> Dropout (torch names net.0 /
    net.3)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.net = nn.Sequential(
            nn.Linear(dim, hidden_dim), nn.GELU(), nn.Dropout(dropout),
            nn.Linear(hidden_dim, dim), nn.Dropout(dropout))

    def forward(self, x, generator=None):
        p, train = self.dropout, self.training
        x = dropout(F.gelu(self.net[0](x)), p, train, generator)
        return dropout(self.net[3](x), p, train, generator)


class _PreNormCav(nn.Module):
    def __init__(self, dim, heads, dim_head, dropout):
        super().__init__()
        self.norm = layer_norm(dim)
        self.fn = CavAttention(dim, heads, dim_head, dropout)

    def forward(self, x, mask, generator=None):
        return self.fn(self.norm(x), mask, generator)


class _PreNormFF(nn.Module):
    def __init__(self, dim, mlp_dim, dropout):
        super().__init__()
        self.norm = layer_norm(dim)
        self.fn = _FeedForwardPlain(dim, mlp_dim, dropout)

    def forward(self, x, generator=None):
        return self.fn(self.norm(x), generator)


class BaseEncoder(nn.Module):
    """depth x (x + prenorm CavAttention, x + prenorm FF); torch names
    ``layers.<i>.<0|1>``."""

    def __init__(self, dim, depth, heads, dim_head, mlp_dim, dropout):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([_PreNormCav(dim, heads, dim_head, dropout),
                           _PreNormFF(dim, mlp_dim, dropout)])
            for _ in range(depth)])

    def forward(self, x, mask, generator=None):
        for attn, ff in self.layers:
            x = attn(x, mask, generator) + x
            x = ff(x, generator) + x
        return x


class BaseTransformer(nn.Module):
    """The CAV transformer: the encoder, then the ego row."""

    def __init__(self, dim: int, depth: int = 3, heads: int = 8,
                 dim_head: int = 32, mlp_dim: int = 256,
                 dropout: float = 0.0):
        super().__init__()
        self.encoder = BaseEncoder(dim, depth, heads, dim_head, mlp_dim,
                                   dropout)

    def forward(self, x, mask, generator=None):
        """x: (B, L, H, W, C); mask: (B, H, W, 1, L) -> (B, H, W, C)."""
        return self.encoder(x, mask, generator)[:, 0]
