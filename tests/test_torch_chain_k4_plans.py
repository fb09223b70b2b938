"""Host side of the int8 chain's strip conv and of K4's wgmma route, on the
CPU.

The chain's conv (``ops/int8_chain.py:s8_plan``, ``csrc/conv3x3_int8.cu``
namespace ``chain``): the persistent blocks' strip walk (mirrored below from
the kernel's loops) covers every output row of every image exactly once,
at layer1, at a height its strips do not divide and where the images
outnumber the blocks; a strip reads each of its halo rows once; the
producer's ring schedule and the consumers' releases never wait on each
other; the swizzled row layout the halo, residual and output rows share is
a bijection whose ldmatrix rows hit distinct banks at every tap shift; and
the block's shared memory (resident weight, halo and residual rings,
staging) keeps two blocks on an SM.

K4 (``ops/fused_swap_fusion.py:k4_plan``, ``csrc/fused_swap_fusion.cu``
``out_k4``): the route by shape; the plan fills the SMs at CorpBEVT's 5,120
rows and fits a block's 227 KB; the output launch's tile walk covers every
token once in both halves; the window-major row its epilogue writes the
next sublayer's q, k, v to (``row_of`` of ``csrc/swap_wgmma.cuh``,
mirrored below) equals the JAX package's window and grid rearranges; its
two warpgroups' weight rings together stream Wout, w1, w2 and the next
Wqkv once a tile.  The kernels themselves are held to their plain versions on
the card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from einops import rearrange

from cobevt_tpu_torch.ops.fused_cross_attention import SMEM_BYTES
from cobevt_tpu_torch.ops.fused_swap_fusion import (
    K4_MAX_STAGES,
    STREAM_TILE,
    k4_kernel_path,
    k4_plan,
    launches_per_call,
    stream_plan,
)
from cobevt_tpu_torch.ops.int8_chain import (
    S8_HALO_BYTES,
    S8_HALO_STAGES,
    S8_MAX_W,
    S8_RES_STAGES,
    S8_SMEM_BYTES,
    S8_WEIGHT_BYTES,
    _TWO_BLOCKS,
    s8_plan,
)

SMS = 132   # the H100's SMs
# (N, H, W): layer1 of a 5-agent frame, a height the strips do not divide
# (strips of 4 and a last one of 1), images beyond the blocks, one image
S8_SHAPES = [(20, 128, 128), (20, 45, 96), (300, 8, 8), (1, 128, 128)]


def strip_walk(plan, N, H):
    """[(block, n, y0, rows)] in the order the kernel's blocks walk them:
    strip st = block, + blocks, ...; image st // per_image."""
    per_image = -(-H // plan.rows)
    walk = []
    for b in range(plan.blocks):
        for st in range(b, N * per_image, plan.blocks):
            n, y0 = divmod(st, per_image)
            y0 *= plan.rows
            walk.append((b, n, y0, min(plan.rows, H - y0)))
    return walk


@pytest.mark.parametrize("shape", S8_SHAPES)
def test_s8_strips_cover_every_output_row_once(shape):
    N, H, W = shape
    plan = s8_plan(N, H, W, 64, 64, SMS)
    assert plan.path == "strip" and plan.blocks <= 2 * SMS
    seen = np.zeros((N, H), np.int64)
    halo_reads = np.zeros((N, H), np.int64)
    for _, n, y0, rows in strip_walk(plan, N, H):
        assert 1 <= rows <= plan.rows
        seen[n, y0:y0 + rows] += 1
        # the halo rows y0 - 1 .. y0 + rows, each loaded once a strip (rows
        # outside the image come back as zeros from TMA)
        halo = [y for y in range(y0 - 1, y0 + rows + 1) if 0 <= y < H]
        assert len(set(halo)) == len(halo)
        halo_reads[n, halo] += 1
    assert (seen == 1).all()
    # an input row is read by its own strip and at most its two neighbours
    assert halo_reads.max() <= 3
    assert halo_reads.sum() <= N * H * (plan.rows + 2) / plan.rows


def test_s8_plan_at_layer1_is_one_wave_of_short_strips():
    plan = s8_plan(20, 128, 128, 64, 64, SMS)
    # 13 strips an image (12 of 10 rows and one of 8): 260 blocks, all
    # resident at once at two an SM
    assert (plan.rows, plan.strips, plan.blocks) == (10, 260, 260)
    tail = s8_plan(20, 45, 96, 64, 64, SMS)
    assert 45 % tail.rows and (tail.rows, tail.strips) == (4, 240)
    # other shapes take K7's mma.sync kernel
    assert s8_plan(2, 9, 7, 64, 24, SMS).path == "mma"
    assert s8_plan(1, 16, 16, 128, 136, SMS).path == "mma"
    assert s8_plan(1, 8, 160, 64, 64, SMS).path == "mma"


def test_s8_shared_memory_keeps_two_blocks_an_sm():
    assert S8_WEIGHT_BYTES == 9 * 64 * 64   # resident: 36 KB
    assert S8_HALO_BYTES >= (S8_MAX_W + 2) * 64 and S8_HALO_BYTES % 512 == 0
    assert S8_SMEM_BYTES <= _TWO_BLOCKS <= SMEM_BYTES
    assert S8_SMEM_BYTES == s8_plan(20, 128, 128, 64, 64, SMS).smem


def ring_schedule_completes(rows_per_strip, has_res, halo_stages,
                            res_stages):
    """Runs the producer's and the consumers' sequences of the kernel (one
    block) against each other: the producer issues halo rows 0, 1 of a
    strip, then per output row j halo row j + 2 and residual row j, waiting
    for a slot's earlier use to be released; the consumers take output row j
    when halo rows j .. j + 2 and residual row j have arrived, then release
    halo row j and residual row j, and the strip's last two halo rows at its
    end.  True when both run to their ends."""
    prod = []
    cons = []
    hi = ri = 0
    for rows in rows_per_strip:
        prod += [("h", hi), ("h", hi + 1)]
        for j in range(rows):
            prod.append(("h", hi + j + 2))
            if has_res:
                prod.append(("r", ri + j))
            need = [("h", hi + j + k) for k in range(3)]
            if has_res:
                need.append(("r", ri + j))
            free = [("h", hi + j)] + ([("r", ri + j)] if has_res else [])
            cons.append((need, free))
        cons.append(([], [("h", hi + rows), ("h", hi + rows + 1)]))
        hi += rows + 2
        ri += rows if has_res else 0
    depth = {"h": halo_stages, "r": res_stages}
    issued, released = set(), set()
    p = c = 0
    while p < len(prod) or c < len(cons):
        moved = False
        while p < len(prod):
            kind, i = prod[p]
            if i >= depth[kind] and (kind, i - depth[kind]) not in released:
                break
            issued.add(prod[p])
            p += 1
            moved = True
        while c < len(cons) and all(x in issued for x in cons[c][0]):
            released.update(cons[c][1])
            c += 1
            moved = True
        if not moved:
            return False
    return True


@pytest.mark.parametrize("has_res", [False, True])
@pytest.mark.parametrize("strips", [[10], [10, 8], [1, 1, 1], [4, 4, 1]])
def test_s8_rings_never_deadlock(has_res, strips):
    assert ring_schedule_completes(strips, has_res, S8_HALO_STAGES,
                                   S8_RES_STAGES)
    # the kernel's depths are not the least that work: two halo rows do not
    assert not ring_schedule_completes(strips, has_res, 2, S8_RES_STAGES)


def sw64(p, c):
    """Byte of (pixel p, channel c) in a row of 64-byte pixels written by
    TMA with SWIZZLE_64B (``chain::sw64``)."""
    return p * 64 + ((((c >> 4) ^ (p >> 1)) & 3) << 4) + (c & 15)


def test_s8_swizzled_rows_are_a_bijection_with_conflict_free_ldmatrix():
    pix = S8_MAX_W + 2
    addrs = {sw64(p, c) for p in range(pix) for c in range(64)}
    assert addrs == set(range(pix * 64))
    # ldmatrix: 8 consecutive pixels (any tap shift) x one 16-byte chunk;
    # the 16-byte bank group of each row differs
    for p0 in range(pix - 7):
        for chunk in range(4):
            groups = {(sw64(p0 + r, 16 * chunk) // 16) % 8 for r in range(8)}
            assert len(groups) == 8


def test_k4_route_by_shape():
    assert k4_kernel_path(128, 4, 256, torch.bfloat16) == "wgmma"  # CorpBEVT
    assert k4_kernel_path(128, 8, 256, torch.bfloat16) == "wgmma"  # hd 16
    assert k4_kernel_path(128, 4, 256, torch.float32) == "rows"
    assert k4_kernel_path(64, 2, 128, torch.bfloat16) == "rows"
    assert k4_kernel_path(128, 16, 256, torch.bfloat16) == "rows"  # hd 8
    assert k4_kernel_path(128, 4, 192, torch.bfloat16) == "rows"
    assert launches_per_call(3, "wgmma") == 14
    assert launches_per_call(3, "rows") == launches_per_call(3) == 19


def test_k4_plan_fills_the_card_at_corpbevt():
    plan = k4_plan(5120, 128, 256, SMS)
    # a block a tile: 80 output blocks (two warpgroups each) and 240 QKV
    # blocks (one warpgroup each), where K6's plan gives 40
    assert (plan.tiles, plan.out_blocks, plan.qkv_blocks) == (80, 80, 80)
    assert stream_plan(5120, 128, 256, SMS).out_blocks == 40
    assert plan.qkv_smem <= SMEM_BYTES and plan.out_smem <= SMEM_BYTES
    # rows beyond the SMs: persistent blocks
    assert k4_plan(20480, 128, 256, SMS).out_blocks == SMS


PATTERNS = {False: "b l (x w1) (y w2) -> b (x y) (l w1 w2)",
            True: "b l (w1 x) (w2 y) -> b (x y) (l w1 w2)"}


def row_of(B, L, H, W, w, grid, tok):
    """The window-major row of state token ``tok`` = ((b L + l) H + y) W + x
    in the partition of ``grid`` (``swapwg::row_of``)."""
    X, Y = H // w, W // w
    x, yl = tok % W, tok // W
    y, bl = yl % H, yl // H
    l, b = bl % L, bl // L
    wx, p = (y % X, y // X) if grid else (y // w, y % w)
    wy, s = (x % Y, x // Y) if grid else (x // w, x % w)
    return ((b * X + wx) * Y + wy) * (L * w * w) + (l * w + p) * w + s


@pytest.mark.parametrize("shape", [(1, 5, 32, 32, 8), (2, 3, 16, 24, 8),
                                   (2, 4, 16, 8, 4)])
def test_k4_next_qkv_rows_equal_the_jax_rearrange(shape):
    B, L, H, W, w = shape
    rows = B * L * H * W
    tokens = np.arange(rows).reshape(B, L, H, W)
    for grid in (False, True):
        # want[r]: the state token at window-major row r of this half
        want = np.asarray(rearrange(jnp.asarray(tokens), PATTERNS[grid],
                                    w1=w, w2=w)).reshape(-1)
        got = row_of(B, L, H, W, w, grid, want)
        np.testing.assert_array_equal(got, np.arange(rows))
        # the output launch of the other half writes every row of this one
        # once: its tiles walk that half's rows, each token goes to row_of
        other = np.asarray(rearrange(jnp.asarray(tokens), PATTERNS[not grid],
                                     w1=w, w2=w)).reshape(-1)
        plan = k4_plan(rows, 128, 256, SMS)
        seen = np.zeros(rows, np.int64)
        for b in range(plan.out_blocks):
            for tile in range(b, plan.tiles, plan.out_blocks):
                r0 = tile * STREAM_TILE
                toks = other[r0:min(r0 + STREAM_TILE, rows)]
                seen[row_of(B, L, H, W, w, grid, toks)] += 1
        assert (seen == 1).all()


def k4_items(D, mlp, nxt, w):
    """Warpgroup w's ring boxes in the order of ``item4_of``, the tile's
    two warpgroups owning cols = D / 2 output columns each and the hidden
    chunks c = w, w + 2, .. of 128 columns: (weight, first row, first
    column, rows); 0 Wout rows cols w .. by k-atom, 1 w1 rows 128 c .. by
    k-atom, 2 w2 rows cols w .. by hidden k-atom, and with a next sublayer
    3 its Wqkv rows 128 s + cols w .. by k-atom for s = q, k, v."""
    cols, ka = D // 2, range(D // 64)
    items = [(0, cols * w, a * 64, cols) for a in ka]
    for c in range(w, mlp // 128, 2):
        items += [(1, 128 * c, a * 64, 128) for a in ka]
    items += [(2, cols * w, k * 64, cols) for k in range(mlp // 64)]
    if nxt:
        items += [(3, sl * D + cols * w, a * 64, cols) for sl in range(3)
                  for a in ka]
    return items


@pytest.mark.parametrize("mlp", [256, 384])
@pytest.mark.parametrize("nxt", [False, True])
def test_k4_weight_rings_stream_every_weight_once(mlp, nxt):
    D = 128
    plan = k4_plan(5120, D, mlp, SMS)
    cover = {0: np.zeros((D, D), np.int64), 1: np.zeros((mlp, D), np.int64),
             2: np.zeros((D, mlp), np.int64),
             3: np.zeros((3 * D, D), np.int64)}
    for w in range(2):
        for which, row, col, nrows in k4_items(D, mlp, nxt, w):
            assert nrows * 64 * 2 <= 16384   # a box fits a ring stage
            cover[which][row:row + nrows, col:col + 64] += 1
    for which, m in cover.items():
        assert (m == (0 if which == 3 and not nxt else 1)).all()
    assert 2 <= plan.stages <= K4_MAX_STAGES
    assert plan.out_smem == 1024 + STREAM_TILE * D * 2 + STREAM_TILE * mlp \
        * 2 + 2 * plan.stages * 16384 + STREAM_TILE * 4 + 2 * 2 * \
        STREAM_TILE * 4 + (4 * K4_MAX_STAGES + 1) * 8
    assert plan.out_smem <= SMEM_BYTES
