"""FuseBEVT: masked window<->grid attention over (agent, H, W) BEV stacks.

Counterpart of ``cobevt_tpu/models/fusion/swap_fusion.py`` (reference
``swap_fusion_modules.py:233``), with the JAX package's dispatch: at eval
the whole encoder runs as K4 (``ops/fused_swap_fusion.py``) while the state
is small enough to stay resident, and as K6, the streaming variant, beyond
that (the cooperative-LiDAR map); ``COBEVT_FUSED_FUSION=0`` or training runs
the stock modules, each window attention through K1
(``ops/window_attention.py``) with the 3D relative-position bias and the
additive key mask.  The canonical mask is (B, L, H, W).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn as nn
from einops import rearrange

from cobevt_tpu_torch.nn.layers import layer_norm
from cobevt_tpu_torch.ops.dispatch import PackCache
from cobevt_tpu_torch.ops.fused_swap_fusion import (
    fits_resident,
    fused_swap_fusion,
    fused_swap_fusion_streaming,
    kernel_accepts,
    pack,
    stream_accepts,
)
from cobevt_tpu_torch.ops.window_attention import fused_window_attention_packed


@functools.lru_cache(maxsize=None)
def _rel_onehot_1d(n: int, table_n: int) -> np.ndarray:
    """(n, n, 2*table_n - 1) 0/1 factor: [a, b, d] = 1 iff
    a - b + table_n - 1 == d.  ``n`` may be smaller than ``table_n``
    (agent-count bucketing); offsets stay those of the full table."""
    a = np.arange(n)
    d = np.arange(2 * table_n - 1)
    return ((a[:, None, None] - a[None, :, None] + table_n - 1)
            == d[None, None, :]).astype(np.float32)


def expand_bias_flat(table, agent_size, window_size, l, w1, w2):
    """Expand the (table_size, heads) block-Toeplitz table to the flat
    (T, heads*T) f32 bias the packed kernel takes: row token (l, y, x),
    column block h holding tokens (l', y', x')."""
    heads = table.shape[-1]
    T = l * w1 * w2
    t4 = table.reshape(2 * agent_size - 1, 2 * window_size - 1,
                       2 * window_size - 1, heads).float()

    def onehot(n, table_n):
        return torch.from_numpy(_rel_onehot_1d(n, table_n)).to(table.device)

    tmp = torch.einsum("defh,uvf->dehuv", t4, onehot(w2, window_size))
    tmp = torch.einsum("dehuv,rse->dhrsuv", tmp, onehot(w1, window_size))
    bias = torch.einsum("dhrsuv,pqd->pruhqsv", tmp,
                        onehot(l, agent_size))
    return bias.reshape(T, heads * T)


class FusionAttention(nn.Module):
    """Attention across (agent, window) tokens with a 3D rel-pos bias."""

    def __init__(self, dim: int, dim_head: int = 32, dropout: float = 0.0,
                 agent_size: int = 6, window_size: int = 7):
        super().__init__()
        self.heads = dim // dim_head
        self.dim_head = dim_head
        self.agent_size = agent_size
        self.window_size = window_size
        table_size = ((2 * agent_size - 1) * (2 * window_size - 1)
                      * (2 * window_size - 1))
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.relative_position_bias_table = nn.Embedding(table_size,
                                                         self.heads)
        self.to_out = nn.Sequential(nn.Linear(dim, dim, bias=False),
                                    nn.Dropout(dropout))

    def forward(self, x, mask=None):
        """x: (b, l, X, Y, w1, w2, d); mask: (b, X, Y, w1, w2, l) or None.
        Returns the same shape as x."""
        b, l, X, Y, w1, w2, d = x.shape
        C = self.heads * self.dim_head
        T = l * w1 * w2
        G = b * X * Y
        t = rearrange(x, "b l x y w1 w2 d -> b (x y) (l w1 w2) d")
        q, k, v = self.to_qkv(t).chunk(3, dim=-1)
        q = q * (self.dim_head ** -0.5)
        bias_flat = expand_bias_flat(
            self.relative_position_bias_table.weight, self.agent_size,
            self.window_size, l, w1, w2)
        key_mask = None
        if mask is not None:
            key_mask = rearrange(
                mask, "b x y w1 w2 l -> (b x y) (l w1 w2)")
        out = fused_window_attention_packed(
            q.reshape(G, T, C).contiguous(), k.reshape(G, T, C).contiguous(),
            v.reshape(G, T, C).contiguous(), n_heads=self.heads,
            bias_flat=bias_flat, mask=key_mask)
        out = self.to_out(out.reshape(b, X * Y, T, C))
        return rearrange(out, "b (x y) (l w1 w2) d -> b l x y w1 w2 d",
                         x=X, y=Y, l=l, w1=w1, w2=w2)


class FeedForward(nn.Module):
    """Linear -> GELU -> Dropout -> Linear -> Dropout (torch names net.0 /
    net.3)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(dim, hidden_dim), nn.GELU(), nn.Dropout(dropout),
            nn.Linear(hidden_dim, dim), nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class _PreNormAttn(nn.Module):
    """x + Attn(LN(x))."""

    def __init__(self, dim, dim_head, dropout, agent_size, window_size):
        super().__init__()
        self.norm = layer_norm(dim)
        self.fn = FusionAttention(dim, dim_head, dropout, agent_size,
                                  window_size)

    def forward(self, x, mask=None):
        return self.fn(self.norm(x), mask) + x


class _PreNormFFD(nn.Module):
    """x + FFD(LN(x))."""

    def __init__(self, dim, mlp_dim, dropout):
        super().__init__()
        self.norm = layer_norm(dim)
        self.fn = FeedForward(dim, mlp_dim, dropout)

    def forward(self, x):
        return self.fn(self.norm(x)) + x


class SwapFusionBlock(nn.Module):
    """window attention -> FFD -> grid attention -> FFD.  The masked
    variant names its sublayers; the unmasked one keeps them in the
    reference's Sequential ``block`` at indices 1/2/5/6 (the others are
    parameterless rearranges)."""

    def __init__(self, input_dim: int, mlp_dim: int, dim_head: int,
                 window_size: int, agent_size: int, dropout: float,
                 masked: bool = True):
        super().__init__()
        self.window_size = window_size
        self.masked = masked
        subs = (_PreNormAttn(input_dim, dim_head, dropout, agent_size,
                             window_size),
                _PreNormFFD(input_dim, mlp_dim, dropout),
                _PreNormAttn(input_dim, dim_head, dropout, agent_size,
                             window_size),
                _PreNormFFD(input_dim, mlp_dim, dropout))
        if masked:
            (self.window_attention, self.window_ffd, self.grid_attention,
             self.grid_ffd) = subs
        else:
            self.block = nn.Sequential(
                nn.Identity(), subs[0], subs[1], nn.Identity(),
                nn.Identity(), subs[2], subs[3], nn.Identity())

    def _sublayers(self):
        if self.masked:
            return (self.window_attention, self.window_ffd,
                    self.grid_attention, self.grid_ffd)
        return tuple(self.block[i] for i in (1, 2, 5, 6))

    def forward(self, x, mask=None):
        """x: (B, L, H, W, d); mask: (B, L, H, W) or None."""
        w = self.window_size
        win_attn, win_ffd, grid_attn, grid_ffd = self._sublayers()
        xw = rearrange(x, "b l (x w1) (y w2) d -> b l x y w1 w2 d",
                       w1=w, w2=w)
        mw = None if mask is None else rearrange(
            mask, "b l (x w1) (y w2) -> b x y w1 w2 l", w1=w, w2=w)
        xw = win_ffd(win_attn(xw, mw))
        x = rearrange(xw, "b l x y w1 w2 d -> b l (x w1) (y w2) d")

        xg = rearrange(x, "b l (w1 x) (w2 y) d -> b l x y w1 w2 d",
                       w1=w, w2=w)
        mg = None if mask is None else rearrange(
            mask, "b l (w1 x) (w2 y) -> b x y w1 w2 l", w1=w, w2=w)
        xg = grid_ffd(grid_attn(xg, mg))
        return rearrange(xg, "b l x y w1 w2 d -> b l (w1 x) (w2 y) d")


def fused_fusion_mode() -> str:
    """``COBEVT_FUSED_FUSION``, the JAX package's switch: "0" runs the
    stock modules; "1" (the default) and "force" run K4 at eval where the
    state fits its resident budget and K6 beyond it, where it streams
    (:meth:`SwapFusionEncoder.fused_kernel`); "force-stream" runs K6
    wherever its gate holds.  Training always runs the stock modules."""
    return os.environ.get("COBEVT_FUSED_FUSION", "1")


def _sublayer_params(attn: _PreNormAttn, ffd: _PreNormFFD) -> dict:
    """One K4 sublayer's parameters, in the JAX layout, from the stock
    modules' weights (the JAX package's ``_SwapBlockParams``)."""
    dense1, dense2 = ffd.fn.net[0], ffd.fn.net[3]
    return {"ln_a": (attn.norm.weight, attn.norm.bias),
            "wqkv": attn.fn.to_qkv.weight.t(),
            "wout": attn.fn.to_out[0].weight.t(),
            "ln_f": (ffd.norm.weight, ffd.norm.bias),
            "w1": dense1.weight.t(), "b1": dense1.bias,
            "w2": dense2.weight.t(), "b2": dense2.bias}


class SwapFusionEncoder(nn.Module):
    """depth x SwapFusionBlock, then the mean over agents + LN + Linear
    head.  By default the mean divides by ``max_cav`` rows, padded ones
    included, as the reference does; ``mean_over_valid`` averages only the
    live agents of ``agent_mask``.  Eval runs the whole encoder as K4 or K6
    where :func:`fused_fusion_mode` and :meth:`fused_kernel` allow; all
    paths share one state_dict."""

    def __init__(self, input_dim: int = 128, mlp_dim: int = 256,
                 agent_size: int = 5, window_size: int = 8,
                 dim_head: int = 32, dropout: float = 0.1, depth: int = 3,
                 mask: bool = True, mean_over_valid: bool = False):
        super().__init__()
        self.mask = mask
        self.mean_over_valid = mean_over_valid
        self.agent_size = agent_size
        self.window_size = window_size
        self.heads = input_dim // dim_head
        self.mlp_dim = mlp_dim
        self.layers = nn.ModuleList([
            SwapFusionBlock(input_dim, mlp_dim, dim_head, window_size,
                            agent_size, dropout, masked=mask)
            for _ in range(depth)])
        # torch names mlp_head.2 / mlp_head.3; 0 and 1 are the
        # parameterless agent reduce and rearrange
        self.mlp_head = nn.Sequential(nn.Identity(), nn.Identity(),
                                      layer_norm(input_dim),
                                      nn.Linear(input_dim, input_dim))
        # K4's and K6's operands, per kernel, agent count and dtype
        self._packed = PackCache()

    def fused_kernel(self, shape):
        """Which fused kernel an eval forward of a (B, L, H, W, d) state
        takes: "K4", "K6" or None (the stock modules).  Reads the shape and
        the switch, never the device, so CPU and GPU take the same branch.
        The dispatch of the JAX package (``models/fusion/swap_fusion.py:
        389-414``) takes K4 where the state ``fits`` the resident budget,
        else K6 where it ``streams``; "force-stream" takes K6 also where K4
        would fit.  Each kernel's own gate stands in for the JAX gate's TPU
        block-shape terms.  Where the state fits but the port's K4 does not
        take its widths (D 256 with mlp 512), K6 runs in K4's place with
        K4's bias rounding (:meth:`_fused_eval`).

        For a while the port sent states beyond the resident budget to the
        stock modules instead, because K6's first kernels (16-row blocks on
        ``mma.sync``) lost to them: 10.9 ms for the four sublayers of the
        cooperative LiDAR map (1, 5, 96, 176, 256) on the card alone, a
        frame of ~16.0 ms device time against 10.3 ms stock (NVIDIA H100
        80GB HBM3, 700 W).  K6's ``wgmma`` kernels take 2.9 ms for the four
        sublayers, and in one call, in turns (``tools/benchmark.py --model
        pointpillar --profile_steps 2``, ``PERF.md`` section 5), the K6
        frame read 7.77-7.86 ms of device time against 10.30-10.49 ms on the
        stock modules, so the JAX package's rule is back; "0" still reaches
        the stock modules."""
        return self._dispatch(shape)[0]

    def _dispatch(self, shape):
        """(kernel, whether K6 stands in for the JAX package's K4)."""
        mode = fused_fusion_mode()
        if self.training or mode == "0":
            return None, False
        _, L, H, W, d = shape
        geom = (L, H, W, d, self.window_size, self.heads)
        resident = fits_resident(*geom)
        fits = resident and kernel_accepts(*geom, self.mlp_dim)
        streams = stream_accepts(*geom, self.mlp_dim)
        if streams and mode == "force-stream":
            return "K6", False
        if fits:
            return "K4", False
        if streams:
            return "K6", resident
        return None, False

    def forward(self, x, mask=None, agent_mask=None):
        """x: (B, L, H, W, d); mask: (B, L, H, W); agent_mask: (B, L)
        (read only with ``mean_over_valid``).  Returns (B, H, W, d)."""
        if not self.mask:
            mask = None
        kernel, in_k4s_place = self._dispatch(x.shape)
        if kernel is not None:
            return self._fused_eval(x, mask, agent_mask,
                                    streaming=kernel == "K6",
                                    round_bias=in_k4s_place)
        for layer in self.layers:
            x = layer(x, mask)
        if self.mean_over_valid and agent_mask is not None:
            w = agent_mask[:, :, None, None, None].to(x.dtype)
            x = (x * w).sum(dim=1) / w.sum(dim=1).clamp(min=1.0)
        else:
            x = x.mean(dim=1)
        return self.mlp_head(x)

    def _fused_eval(self, x, mask, agent_mask, streaming=False,
                    round_bias=False):
        """K4, or K6 when ``streaming``, on this module's weights
        (``_fused_eval`` of the JAX package,
        ``models/fusion/swap_fusion.py:432-491``): the bias tables expanded
        to (depth, 2, T, heads*T) -- in the compute dtype for K4, kept in
        f32 for K6, and with ``round_bias`` (K6 in K4's place) rounded
        through the compute dtype first, the values K4 sees -- and the
        (B, L, H, W) mask passed as it is and read through the window map in
        the kernel.  The packed operands are built once per kernel, agent
        count and dtype and reused while the weights are unchanged."""
        L = x.shape[1]
        bias_dtype = torch.float32 if streaming else x.dtype
        name = "encoder"
        if streaming:
            name = "stream_k4" if round_bias else "stream"
        packed = self._packed.get(
            name, list(self.parameters()),
            lambda: self._pack(L, x.dtype, bias_dtype, round_bias), L,
            x.dtype)
        fn = fused_swap_fusion_streaming if streaming else fused_swap_fusion
        return fn(x, mask, agent_mask, None, packed, None, self.window_size,
                  self.heads, mean_over_valid=self.mean_over_valid)

    def _pack(self, L, dtype, bias_dtype, round_bias=False):
        w = self.window_size
        layers, biases = [], []
        for block in self.layers:
            win_attn, win_ffd, grid_attn, grid_ffd = block._sublayers()
            layers.append((_sublayer_params(win_attn, win_ffd),
                           _sublayer_params(grid_attn, grid_ffd)))
            biases.append(torch.stack([
                expand_bias_flat(a.fn.relative_position_bias_table.weight,
                                 self.agent_size, w, L, w, w)
                for a in (win_attn, grid_attn)]))
        ln, dense = self.mlp_head[2], self.mlp_head[3]
        head = {"ln": (ln.weight, ln.bias), "w": dense.weight.t(),
                "b": dense.bias}
        bias = torch.stack(biases)
        if round_bias:
            bias = bias.to(dtype)
        return pack(layers, bias, head, dtype, bias_dtype)
