"""Host side of K6's and K7's wgmma kernels, on the CPU.

K6 (``ops/fused_swap_fusion.py``): with the grids of ``stream_plan``, the
tile walks of both row launches (mirrored below from the kernels' loops)
over the window-major token rows cover every token of the state exactly
once, in a window half and a grid half, at the LiDAR shape and at a
non-square small one; the output launch's weight ring (its boxes in the
order of the kernel's ``item_of``, mirrored below) streams every weight
element once a pass and each box fits its ring stage, the whole ring within
one block's 227 KB at D 256 / mlp 512 and D 128 / mlp 256; the
(B, L, H, W) -> (G, T) key-mask gather K1's kernel reads equals the JAX
package's window rearrange of the mask for both halves; the route
(``stream_kernel_path``).

K7 (``ops/conv2d.py``): the folded scale (a producer's |max| slot, then the
consumer's prologue arithmetic, as plain PyTorch) gives s_a, 1 / s_a and
s_a * s_w bit-equal to ``act_scale`` and the JAX package's ``_act_scale``
in f32 and bf16; a ResNet stage of int8 BasicBlocks run through the slot
chain (``ResNetTrunk._k7_stage``) equals the block-by-block path with a
max-reduce at every call, bit for bit; the tile plan (``int8_tile_plan``)
fits one block's shared memory and keeps two blocks on an SM at both
trunk shapes.  The
kernels themselves are held to their plain versions on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from einops import rearrange

from cobevt_tpu.ops import conv2d as jax_conv2d
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.nn import layers as port_layers
from cobevt_tpu_torch.nn.resnet import ResNetTrunk
from cobevt_tpu_torch.ops.conv2d import (
    act_scale,
    fold_amax_,
    fused_conv3x3_int8,
    int8_absmax,
    int8_tile_plan,
    new_amax_slots,
    pack_int8_weight,
    scale_from_amax,
)
from cobevt_tpu_torch.ops.fused_cross_attention import SMEM_BYTES
from cobevt_tpu_torch.ops.fused_swap_fusion import (
    STREAM_GROUPS,
    STREAM_TILE,
    gather_key_mask,
    stream_kernel_path,
    stream_plan,
    to_windows,
)

# (B, L, H, W, window): the cooperative-LiDAR map and a small non-square one
STREAM_SHAPES = [(1, 5, 96, 176, 8), (2, 3, 16, 24, 8)]


def stream_tiles(plan, launch):
    """{(block, y, warpgroup): [tiles]} as the kernels' loops walk them:
    ``stream_qkv_wgmma`` tile = 2 block + group, stepping 2 x blocks, for
    each of y = q, k, v; ``stream_out_wgmma`` pair p = block, stepping
    blocks, tile = 2 p + group (a tile past the end is zeros, not stored)."""
    g = STREAM_GROUPS
    walk = {}
    if launch == "qkv":
        for b in range(plan.qkv_blocks):
            for y in range(3):
                for grp in range(g):
                    walk[b, y, grp] = list(range(b * g + grp, plan.tiles,
                                                 plan.qkv_blocks * g))
    else:
        pairs = -(-plan.tiles // g)
        for b in range(plan.out_blocks):
            for grp in range(g):
                walk[b, 0, grp] = [p * g + grp for p in
                                   range(b, pairs, plan.out_blocks)]
    return walk


def stream_items(D, mlp):
    """The output launch's ring boxes in the order of ``item_of``: (weight,
    first row, first column, rows), weight 0 Wout (its k-atoms, all D rows),
    then per 128 hidden columns c: 1 w1 (rows c .. c+127, each k-atom), 2 w2
    (two k-atoms of columns c .. c+127, all D rows)."""
    items = [(0, 0, a * 64, D) for a in range(D // 64)]
    for c in range(0, mlp, 128):
        items += [(1, c, a * 64, 128) for a in range(D // 64)]
        items += [(2, 0, c + k * 64, D) for k in range(2)]
    return items


@pytest.mark.parametrize("shape", STREAM_SHAPES)
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("launch", ["qkv", "out"])
def test_k6_tile_walk_covers_every_token_once(shape, grid, launch):
    B, L, H, W, w = shape
    rows = B * L * H * W
    # the state token of each window-major row, as state_offset maps it
    idx = to_windows(torch.arange(rows).reshape(B, L, H, W), w,
                     grid).reshape(-1)
    plan = stream_plan(rows, 256, 512, 132)
    walk = stream_tiles(plan, launch)
    slices = {key[1] for key in walk}
    assert slices == ({0, 1, 2} if launch == "qkv" else {0})
    for y in slices:
        seen = np.zeros(rows, np.int64)
        for (b, yy, grp), tiles in walk.items():
            if yy != y:
                continue
            for tile in tiles:
                r0 = tile * STREAM_TILE
                seen[idx[r0:min(r0 + STREAM_TILE, rows)].numpy()] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("D,mlp", [(256, 512), (128, 256)])
def test_k6_weight_ring_streams_every_weight_once_and_fits(D, mlp):
    plan = stream_plan(84480, D, mlp, 132)
    assert 2 <= plan.stages <= 4
    assert plan.out_smem <= SMEM_BYTES and plan.qkv_smem <= SMEM_BYTES
    assert plan.stage_bytes == D * 128
    cover = {0: np.zeros((D, D), np.int64), 1: np.zeros((mlp, D), np.int64),
             2: np.zeros((D, mlp), np.int64)}
    items = stream_items(D, mlp)
    for which, row, col, nrows in items:
        # a box is nrows rows x 64 columns of bf16 and fits one stage
        assert nrows * 64 * 2 <= plan.stage_bytes
        cover[which][row:row + nrows, col:col + 64] += 1
    for m in cover.values():
        assert (m == 1).all()
    assert len(items) == D // 64 + mlp // 128 * (D // 64 + 2)


@pytest.mark.parametrize("shape", STREAM_SHAPES)
def test_k6_key_mask_gather_equals_the_jax_rearrange(shape):
    B, L, H, W, w = shape
    m = (np.random.RandomState(3).rand(B, L, H, W) > 0.3).astype(np.float32)
    for grid, pattern in ((False, "b l (x w1) (y w2) -> b (x y) (l w1 w2)"),
                          (True, "b l (w1 x) (w2 y) -> b (x y) (l w1 w2)")):
        got = gather_key_mask(torch.from_numpy(m), w, grid)
        want = np.asarray(rearrange(jnp.asarray(m), pattern, w1=w, w2=w))
        assert got.shape == (B * want.shape[1], L * w * w)
        np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)
        assert torch.equal(got.reshape(want.shape),
                           to_windows(torch.from_numpy(m), w, grid))


@pytest.mark.parametrize("D,heads,mlp,dtype,path", [
    (256, 8, 512, torch.bfloat16, "wgmma"),     # cooperative LiDAR
    (128, 4, 256, torch.bfloat16, "wgmma"),     # CorpBEVT's FuseBEVT
    (256, 8, 512, torch.float32, "rows"),
    (128, 16, 256, torch.bfloat16, "rows"),     # head dim 8
    (192, 6, 384, torch.bfloat16, "rows"),      # D not 128 or 256
    (256, 8, 448, torch.bfloat16, "rows"),      # mlp not a multiple of 128
])
def test_k6_route(D, heads, mlp, dtype, path):
    assert stream_kernel_path(D, heads, mlp, dtype) == path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_folded_scale_equals_act_scale_bit_for_bit(dtype):
    rng = np.random.RandomState(4)
    s_w = torch.from_numpy(rng.rand(64).astype(np.float32) * 0.01 + 1e-4)
    for trial in range(20):
        x = (rng.randn(2, 5, 7, 16) * 10 ** rng.uniform(-3, 2)).astype(
            np.float32)
        if trial == 0:
            x[:] = 0.0                        # the 1e-12 clamp
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        # the producer leaves the |max| of its output in a slot, part by part
        slot = new_amax_slots(1, "cpu")
        for part in tx.split(2, dim=2):
            fold_amax_(slot, part)
        # the consumer's prologue: s_a, 1 / s_a, s_a * s_w from the slot
        s_a = scale_from_amax(slot)
        inv, scale = 1.0 / s_a, s_a * s_w
        want = act_scale(tx)
        assert s_a.dtype == torch.float32 and s_a.dim() == 0
        assert s_a.view(torch.int32) == want.view(torch.int32)
        assert float(s_a) == float(jax_conv2d._act_scale(jnp.asarray(
            x, dtype)))
        # the wrapper before the fold: s_a * s_w and (1 / s_a).reshape(1)
        assert torch.equal(scale, want * s_w)
        assert torch.equal(inv.reshape(1), (1.0 / want).reshape(1))
        # the absmax's plain version fills the same slot
        assert torch.equal(int8_absmax(tx, new_amax_slots(1, "cpu")), slot)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_slot_chain_equals_the_max_reduce_path(monkeypatch, dtype):
    """A stage of ResNet-34's int8 mode at a small map: the strided block,
    then stride-1 blocks on K7 whose scales come from the slots (one absmax,
    then each K7's epilogue), against calling every K7 with its own
    max-reduce, as before the fold."""
    torch.manual_seed(0)
    trunk = ResNetTrunk(34).to(dtype).eval()
    blocks = trunk.layer3
    for m in blocks.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.1, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    x = torch.randn(2, 8, 8, 128).relu().to(dtype)
    monkeypatch.setenv("COBEVT_INT8", "1")
    with torch.no_grad():
        got = trunk._k7_stage(blocks, x)
        want = blocks[0](x)
        for block in blocks[1:]:
            assert block.takes_k7(want.shape[-1])
            p1 = block._folded("k7_conv1", block.conv1, block.bn1,
                               pack_int8_weight)
            p2 = block._folded("k7_conv2", block.conv2, block.bn2,
                               pack_int8_weight)
            out = fused_conv3x3_int8(want, None, None, packed=p1)
            want = fused_conv3x3_int8(out, None, None, residual=want,
                                      packed=p2)
        # the standalone block path (a slot for x, one for conv1) agrees too
        alone = blocks[0](x)
        for block in blocks[1:]:
            alone = block(alone)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(alone, want)
    assert ops.launch_counts()["int8_absmax"] == 0      # CPU: plain versions


def test_k7_trunk_takes_the_slot_chain_only_in_int8_mode(monkeypatch):
    trunk = ResNetTrunk(34).eval()
    calls = []
    monkeypatch.setattr(ResNetTrunk, "_k7_stage",
                        lambda self, blocks, x: calls.append(len(blocks))
                        or torch.nn.Sequential(*blocks)(x))
    x = torch.randn(1, 32, 32, 3)
    monkeypatch.setenv("COBEVT_INT8", "0")
    with torch.no_grad():
        trunk(x)
    assert calls == []
    monkeypatch.setenv("COBEVT_INT8", "1")
    monkeypatch.setenv("COBEVT_INT8_RESIDENT", "0")
    with torch.no_grad():
        trunk(x)
    assert calls == [6, 3]                  # layer3 and layer4
    monkeypatch.setattr(port_layers, "fused_conv_enabled", lambda a, b: False)
    calls.clear()
    with torch.no_grad():
        trunk(x)
    assert calls == []


@pytest.mark.parametrize("H,W,C,path,rows,two", [
    (32, 32, 256, "wgmma", 4, True),        # layer3
    (16, 16, 512, "wgmma", 8, True),        # layer4: two channel groups
    (16, 16, 384, "mma", 8, False),         # 384 is no multiple of 256
    (5, 48, 128, "wgmma", 2, True),
    (9, 7, 64, "mma", 9, False),            # C % 128: the mma.sync kernel
    (128, 128, 64, "mma", 1, False),
])
def test_k7_tile_plan(H, W, C, path, rows, two):
    plan = int8_tile_plan(H, W, C)
    assert plan.path == path and plan.rows == rows
    assert plan.rows * W <= 128 and plan.smem <= SMEM_BYTES
    if path == "wgmma":
        assert 2 <= plan.stages <= 4
        assert (plan.blocks_per_sm == 2) == two
        assert plan.smem * plan.blocks_per_sm <= 228 * 1024 - 1024 * \
            plan.blocks_per_sm
    else:
        assert plan.stages == 0
