"""Host side of the wgmma kernels (K3, K1/K8, K5, K2), on the CPU.

K5's two grids cover every query row and key once; K2's row maps are the
plain version's window partitions and its 64-row tiles and attention grid
cover every token once; K2's route (``kernel_path``); the plain row
statistics a forward hands K5 stand for the plain backward's own sweep.

K3's tile plan (``ops/conv2d.py:conv_tile_plan``): at every trunk shape a
tile's spatial box lies inside one image, holds 128 pixel slots, and the
boxes cover every output pixel exactly once.  K1's plan
(``ops/window_attention.py:attention_tile_plan``) covers every query row of
every path shape once.  K3's packed weight: a ``BasicBlock`` at eval folds,
casts and transposes its weights once per weight version and dtype
(``PackCache``), its fused forward equals the unfused block in f32, and the
cache is rebuilt when ``conv.weight`` or a BatchNorm statistic changes.  The
kernels themselves are held to their plain versions on the card
(``tests/test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

from cobevt_tpu_torch.nn import layers as port_layers
from cobevt_tpu_torch.nn.layers import BasicBlock
from cobevt_tpu_torch.ops import conv2d as port_conv2d
from cobevt_tpu_torch.ops.conv2d import (
    conv3x3_reference,
    conv_tile_plan,
    fold_bn,
    fused_conv3x3,
    pack_conv3x3_weight,
)
from cobevt_tpu_torch.ops.fused_cross_attention import (
    _grid_windows,
    _windows,
    kernel_path,
    xattn_row_maps,
)
from cobevt_tpu_torch.ops.window_attention import (
    attention_tile_plan,
    bwd_block_coords,
    bwd_tile_plan,
    packed_attention_reference,
    packed_backward_reference,
    packed_row_stats_reference,
)

# (H, W) of the ResNet-34 trunk at 512^2 cameras (layer1 .. layer4), of the
# CPU tests, and widths that are no power of two or wider than a box
TRUNK = [(128, 128), (64, 64), (32, 32), (16, 16)]
OTHER = [(9, 7), (5, 6), (3, 200), (1, 1), (17, 130)]


@pytest.mark.parametrize("H,W", TRUNK + OTHER)
def test_conv_tile_plan_covers_every_pixel_once(H, W):
    bh, bw, ty, tx = conv_tile_plan(H, W)
    assert bh * bw == 128 and bw & (bw - 1) == 0
    seen = np.zeros((H, W), np.int64)
    for y in range(ty):
        for x in range(tx):
            ys = slice(y * bh, min((y + 1) * bh, H))
            xs = slice(x * bw, min((x + 1) * bw, W))
            seen[ys, xs] += 1
    assert (seen == 1).all()
    # no tile starts outside the image, and none is needed past it
    assert (ty - 1) * bh < H and (tx - 1) * bw < W


@pytest.mark.parametrize("H,W,box", [(64, 64, (2, 64)), (32, 32, (4, 32)),
                                     (16, 16, (8, 16))])
def test_conv_tile_plan_at_the_trunk_shapes(H, W, box):
    """The boxes of layer2 .. layer4 fill their image rows exactly."""
    bh, bw, ty, tx = conv_tile_plan(H, W)
    assert (bh, bw) == box and ty * bh == H and tx * bw == W


# (G, H, Tq) of K1_CASES in chip_smoke.py: the serving and train path
# shapes, the LiDAR fusion attention, and a ragged query count
K1_SHAPES = [(320, 4, 1024), (320, 4, 256), (80, 4, 256), (5, 4, 1024),
             (16, 4, 320), (264, 8, 320), (3, 4, 72), (3, 4, 136)]


@pytest.mark.parametrize("G,H,Tq", K1_SHAPES)
def test_attention_tile_plan_covers_every_query_once(G, H, Tq):
    rows, blocks = attention_tile_plan(G, H, Tq)
    tiles = blocks // (G * H)
    assert tiles * G * H == blocks
    covered = np.zeros(Tq, np.int64)
    for t in range(tiles):
        covered[t * rows:(t + 1) * rows] += 1
    assert (covered == 1).all() and (tiles - 1) * rows < Tq


# (G, H, Tq, Tk) of K5_CASES in chip_smoke.py (the train steps' attention
# backward) and ragged ones: rows that are no multiple of a tile
K5_SHAPES = [(320, 4, 1024, 256), (320, 4, 256, 256), (80, 4, 256, 256),
             (5, 4, 1024, 1024), (16, 4, 320, 320), (264, 8, 320, 320),
             (3, 4, 72, 40), (3, 4, 136, 200)]


@pytest.mark.parametrize("G,H,Tq,Tk", K5_SHAPES)
def test_bwd_tile_plan_covers_every_row_once(G, H, Tq, Tk):
    """K5's two grids: every (window, head, query row) has exactly one dq
    block, every (window, head, key) one dk/dv block, and no block's box
    starts past its rows."""
    rows, dq_blocks, dkdv_blocks = bwd_tile_plan(G, H, Tq, Tk)
    assert rows == 64
    for blocks, T in ((dq_blocks, Tq), (dkdv_blocks, Tk)):
        seen = np.zeros((G, H, T), np.int64)
        for b in range(blocks):
            win, h, r0 = bwd_block_coords(b, H, T)
            assert 0 <= r0 < T
            seen[win, h, r0:r0 + rows] += 1
        assert (seen == 1).all()


# K2's branches: (B, n, H, W, h, w, q_win, k_win, nq, grid keys): the six
# of a 5-agent CorpBEVT frame (chip_smoke.py:K2_CASES) and ragged ones: 40
# query rows and 24 keys a window, windows that are not square
K2_SHAPES = [
    (5, 4, 128, 128, 64, 64, (16, 16), (8, 8), 4, False),
    (5, 4, 128, 128, 64, 64, (16, 16), (8, 8), 1, True),
    (5, 4, 64, 64, 32, 32, (16, 16), (8, 8), 1, False),
    (5, 4, 64, 64, 32, 32, (16, 16), (8, 8), 1, True),
    (5, 4, 32, 32, 16, 16, (32, 32), (16, 16), 1, False),
    (5, 4, 32, 32, 16, 16, (32, 32), (16, 16), 1, True),
    (1, 3, 20, 16, 8, 8, (10, 4), (4, 2), 3, True),
    (2, 4, 24, 16, 12, 8, (8, 8), (4, 4), 4, False),
]


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_xattn_row_maps_cover_every_token_once(shape):
    """The rows of K2's K/V, Q and output launches read and write every
    token exactly once, in the layout of the plain version's window
    partitions, and their 64-row tiles cover every row once."""
    B, n, H, W, h, w, q_win, k_win, nq, grid = shape
    key, pos, cam, out = xattn_row_maps(B, n, H, W, h, w, q_win, k_win, nq,
                                        grid)
    part = _grid_windows if grid else _windows
    idx = torch.arange(B * n * h * w).reshape(B, n, h, w, 1)
    assert np.array_equal(key, part(idx, *k_win).reshape(-1).numpy())
    idx = torch.arange(B * nq * H * W).reshape(B, nq, H, W, 1)
    flat = (pos // (H * W) * nq + cam) * H * W + pos % (H * W)
    assert np.array_equal(flat, _windows(idx, *q_win).reshape(-1).numpy())
    idx = torch.arange(B * H * W).reshape(B, 1, H, W, 1)
    assert np.array_equal(out, _windows(idx, *q_win).reshape(-1).numpy())
    assert np.array_equal(np.sort(out), np.arange(B * H * W))
    for rows in (key.size, pos.size, out.size):   # 64-row tiles
        seen = np.zeros(rows, np.int64)
        for t in range(-(-rows // 64)):
            seen[t * 64:(t + 1) * 64] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_xattn_attention_blocks_cover_every_query_once(shape):
    """K2's attention grid (64 query rows of one (window, head) a block,
    every camera segment in it) decomposes blockIdx.x as K5's dq grid; each
    (window, head, row of a segment) is computed once."""
    B, n, H, W, h, w, q_win, k_win, nq, grid = shape
    heads, Tw = 4, q_win[0] * q_win[1]
    G = B * (H // q_win[0]) * (W // q_win[1])
    blocks = G * heads * -(-Tw // 64)
    seen = np.zeros((G, heads, Tw), np.int64)
    for blk in range(blocks):
        win, hd, r0 = bwd_block_coords(blk, heads, Tw)
        seen[win, hd, r0:r0 + 64] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype,D,heads,hidden,nq,path", [
    (torch.bfloat16, 128, 4, 256, 4, "wgmma"),
    (torch.bfloat16, 128, 4, 256, 1, "wgmma"),
    (torch.bfloat16, 128, 8, 0, 1, "wgmma"),
    (torch.bfloat16, 128, 16, 256, 1, "mma"),     # head dim 8
    (torch.bfloat16, 128, 4, 512, 1, "mma"),
    (torch.bfloat16, 128, 4, 256, 3, "mma"),
    (torch.bfloat16, 64, 8, 0, 3, "mma"),
    (torch.float32, 128, 4, 256, 4, "scalar"),
])
def test_xattn_kernel_path(dtype, D, heads, hidden, nq, path):
    assert kernel_path(dtype, D, D, heads, hidden, nq) == path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extras", ["", "bias", "mask", "bias+mask"])
def test_plain_forward_statistics_feed_the_plain_backward(dtype, extras):
    """The row statistics a forward hands K5 (plain version: row max over
    every head, sum of the rounded exp per head) give the plain backward the
    same dq, dk, dv and dbias as its own first sweep, within f32 rounding."""
    rng = np.random.RandomState(3)
    G, H, D, Tq, Tk = 3, 4, 16, 24, 40

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)

    q, k, v, g = (t(G, T, H * D, scale=s_).to(dtype) for T, s_ in
                  ((Tq, 0.3), (Tk, 1.0), (Tk, 1.0), (Tq, 1.0)))
    bias = t(Tq, H * Tk) if "bias" in extras else None
    mask = None
    if "mask" in extras:
        mask = (t(G, Tk) > 0).float()
        mask[1] = 0.0                       # a fully masked window
    out = packed_attention_reference(q, k, v, H, bias, mask)
    stats = packed_row_stats_reference(q, k, H, bias, mask)
    assert stats.shape == (2, G, H, Tq) and stats.dtype == torch.float32
    fed = packed_backward_reference(q, k, v, g, out, H, bias, mask, stats)
    own = packed_backward_reference(q, k, v, g, out, H, bias, mask)
    for a, b in zip(fed, own):
        if b is None:
            assert a is None
            continue
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-6,
                                   atol=1e-6 * scale)


def _block(channels=128, seed=0):
    torch.manual_seed(seed)
    block = BasicBlock(channels, channels).eval()
    with torch.no_grad():
        for bn in (block.bn1, block.bn2):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.2, 0.2)
            bn.running_mean.uniform_(-0.2, 0.2)
            bn.running_var.uniform_(0.5, 1.5)
    return block


def _unfused(block, x):
    """The block's stock modules (training off, K3 off)."""
    return torch.nn.functional.relu(
        port_layers.bn_nhwc(block.bn2, port_layers.conv_nhwc(
            block.conv2, torch.nn.functional.relu(port_layers.bn_nhwc(
                block.bn1, port_layers.conv_nhwc(block.conv1, x)))))
        + x)


def test_fused_eval_equals_the_unfused_block_in_f32():
    block = _block()
    x = torch.rand(2, 8, 8, 128)
    with torch.no_grad():
        got = block(x)
        want = _unfused(block, x)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_block_packs_its_k3_weights_once_per_version(monkeypatch):
    block = _block(seed=1)
    packs = []
    real = port_conv2d.pack_conv3x3_weight

    def counting(w, shift, dtype):
        packs.append(dtype)
        return real(w, shift, dtype)

    monkeypatch.setattr(port_layers, "pack_conv3x3_weight", counting)
    x = torch.rand(1, 4, 4, 128)
    with torch.no_grad():
        a = block(x)
        b = block(x)
        assert len(packs) == 2 and torch.equal(a, b)
        block.conv1.weight.mul_(0.5)          # a new weight version
        c = block(x)
        assert len(packs) == 3 and not torch.equal(a, c)
        block.bn2.running_var.mul_(2.0)       # a new BatchNorm statistic
        d = block(x)
        assert len(packs) == 4 and not torch.equal(c, d)
        torch.testing.assert_close(d, _unfused(block, x), atol=1e-4,
                                   rtol=1e-4)
        block(x.bfloat16())                   # another compute dtype
    assert packs[-2:] == [torch.bfloat16] * 2
    assert not any("pack" in k for k in block.state_dict())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_weight_is_the_folded_weight_in_the_kernels_layouts(dtype):
    rng = np.random.RandomState(2)
    C, O = 64, 32
    w = torch.from_numpy(rng.randn(3, 3, C, O).astype(np.float32)) * 0.1
    shift = torch.from_numpy(rng.randn(O).astype(np.float32))
    p = pack_conv3x3_weight(w, shift, dtype)
    assert p.w.dtype == dtype and torch.equal(p.w, w.to(dtype))
    assert p.shift.dtype == torch.float32 and torch.equal(p.shift, shift)
    if dtype == torch.bfloat16:
        # (O, 9C): K contiguous, tap-major, channel-minor
        assert p.wt.shape == (O, 9 * C) and p.wt.is_contiguous()
        tap, c, o = 5, 17, 3
        assert p.wt[o, tap * C + c] == w[tap // 3, tap % 3, c, o].to(dtype)
    else:
        assert p.wt is None
    x = torch.from_numpy(rng.randn(1, 5, 6, C).astype(np.float32)).to(dtype)
    torch.testing.assert_close(
        fused_conv3x3(x, None, None, packed=p),
        conv3x3_reference(x, w, shift), atol=0, rtol=0)


def test_fold_bn_then_pack_matches_folding_at_every_call():
    block = _block(seed=3)
    x = torch.rand(1, 6, 6, 128)
    w, t = fold_bn(port_layers._conv_hwio(block.conv1),
                   *port_layers._bn_stats(block.bn1))
    with torch.no_grad():
        per_call = fused_conv3x3(x, w, t)
        packed = fused_conv3x3(
            x, None, None, packed=pack_conv3x3_weight(w, t, x.dtype))
    assert torch.equal(per_call, packed)
