"""Host-side plans of K11/K12's routes and of K5's dbias partials.

``ops/ffd_fused.py:kernel_path`` and ``ffd_plan`` decide, before a launch,
which route a shape takes and what its launches get: grids, ring stages,
shared memory and the weight launch's split-K row ranges; the kernels of
``csrc/ffd_fused.cu`` compute the same numbers.  ``ops/window_attention.py:
dbias_plan`` cuts K5's windows into the chunks whose blocks write dbias
partials.  CPU only: the numbers are the kernels' contract.
"""

import pytest
import torch

from cobevt_tpu_torch.ops import ffd_fused
from cobevt_tpu_torch.ops.ffd_fused import ffd_kernel_accepts, ffd_plan
from cobevt_tpu_torch.ops.window_attention import dbias_plan

SMEM_LIMIT = 232448     # an H100 block's shared-memory maximum


def _check_ranges(plan, N):
    """The split-K row ranges cover [0, N) once, in order, each non-empty
    and starting on a 64-row step."""
    ranges = plan.split_rows
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == N
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    for a, b in ranges:
        assert a < b and a % plan.tile_rows == 0
        assert b - a <= plan.split_steps * plan.tile_rows


def test_ffd_plan_at_the_lidar_width():
    N, D, M = 84480, 256, 512
    plan = ffd_plan(N, D, M, torch.bfloat16)
    assert plan.route == "wgmma" and plan.tile_rows == 64
    # 660 pairs of 64-row tiles: five a block on 132 SMs
    pairs = N // 128
    assert plan.blocks == 132
    assert pairs % plan.blocks == 0
    assert (plan.fwd_stages, plan.rows_stages, plan.weight_stages) == (8, 4, 4)
    assert max(plan.fwd_smem, plan.rows_smem, plan.weight_smem) <= SMEM_LIMIT
    # t, g, a and dh tiles of two warpgroups (160 KB) and four 16 KB boxes
    assert plan.rows_smem == 1024 + 2 * (2 * 64 * D * 2 + 2 * 8192) + \
        4 * 16384 + (2 * 8 + 2) * 8
    # 8 output tiles of 128 x 256 times 16 splits: one wave of 128 blocks
    tiles = (D // 128) * (M // 256) + (M // 128) * (D // 256)
    assert tiles == ffd_fused.weight_tiles(D, M) == 8 and plan.splits == 16
    assert tiles * plan.splits <= 132
    assert plan.split_steps == 83
    assert plan.vec_rows == 132 * 2
    assert plan.bwd_ints() == (132, 4, 16, 83, 4, plan.rows_smem,
                               plan.weight_smem)
    _check_ranges(plan, N)


@pytest.mark.parametrize("N,D,M", [
    (1000, 128, 256), (84481, 256, 512), (17, 128, 128), (65, 256, 256),
    (4096, 256, 1024), (130, 128, 512), (1, 256, 128)])
def test_ffd_plan_at_tail_shapes(N, D, M):
    plan = ffd_plan(N, D, M, torch.bfloat16)
    assert plan.route == "wgmma"
    assert max(plan.fwd_smem, plan.rows_smem, plan.weight_smem) <= SMEM_LIMIT
    assert min(plan.fwd_stages, plan.rows_stages, plan.weight_stages) >= 2
    pairs = -(-(-(-N // 64)) // 2)
    assert plan.blocks == min(pairs, 132)
    assert plan.vec_rows == plan.blocks * 2
    assert plan.splits * ffd_fused.weight_tiles(D, M) <= 132
    _check_ranges(plan, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_route_of_every_shape_the_kernels_take(dtype):
    """Every shape the gate takes has a route and a plan within a block's
    shared memory: bf16 at D 128 or 256 with M a multiple of 128 on wgmma,
    everything else the gate takes on the row kernels."""
    taken = 0
    for N in (1, 17, 64, 1000, 84480):
        for D in (32, 64, 128, 192, 256, 320, 512):
            for M in (64, 128, 192, 256, 512, 1024):
                if not ffd_kernel_accepts(N, D, M, dtype):
                    assert (dtype == torch.float16 or D % 64 or D > 256
                            or D < 64)
                    continue
                taken += 1
                route = ffd_fused.kernel_path(N, D, M, dtype)
                want = ("wgmma" if dtype == torch.bfloat16
                        and D in (128, 256) and M % 128 == 0 else "rows")
                assert route == want, (N, D, M)
                plan = ffd_plan(N, D, M, dtype)
                assert plan.route == route
                if route == "wgmma":
                    assert max(plan.fwd_smem, plan.rows_smem,
                               plan.weight_smem) <= SMEM_LIMIT
                    _check_ranges(plan, N)
                else:
                    # the row kernels' shared memory is the gate's own test
                    assert isinstance(plan, ffd_fused.RowsPlan)
                    assert plan.vec_rows == plan.blocks >= 1
    assert taken == (0 if dtype == torch.float16 else 5 * 4 * 6)


@pytest.mark.parametrize("G,H,Tq,Tk,dtype,chunks,wpc,mb", [
    # the camera step's fusion attention: 100 tiles, 4 chunks of 4 windows
    (16, 4, 320, 320, torch.bfloat16, 4, 4, 6.5536),
    # the LiDAR step: 200 tiles, 2 chunks of 132 windows
    (264, 8, 320, 320, torch.bfloat16, 2, 132, 6.5536),
    # the same in f32: the scalar dq kernel's 40 blocks a window
    (264, 8, 320, 320, torch.float32, 13, 21, 42.5984),
    # the camera step's local cross-view attention, were it to carry a bias
    (320, 4, 1024, 256, torch.bfloat16, 2, 160, 8.388608),
    # the dropout-free self-attention with its bias: 1024 tiles, one chunk
    (5, 4, 1024, 1024, torch.bfloat16, 1, 5, 0.0),
    # the GPU tests' ragged shape: a chunk a window
    (3, 4, 72, 40, torch.bfloat16, 3, 1, 0.13824),
    (3, 4, 72, 40, torch.float32, 3, 1, 0.13824),
    # one window: no partials, dbias written directly
    (1, 4, 320, 320, torch.bfloat16, 1, 1, 0.0),
])
def test_k5_dbias_partial_plan(G, H, Tq, Tk, dtype, chunks, wpc, mb):
    got = dbias_plan(G, H, Tq, Tk, dtype)
    assert got[:2] == (chunks, wpc)
    assert got[2] == pytest.approx(mb * 1e6, abs=0.5)
    # every window in exactly one chunk, chunks in window order
    windows = [w for c in range(chunks)
               for w in range(c * wpc, min((c + 1) * wpc, G))]
    assert windows == list(range(G))
    # the blocks a chunk takes: bf16 one per 64 x 64 dbias tile, f32 one
    # per 64 query rows of a head; the chunks' blocks fit one wave of 132
    # SMs x 4 blocks (or are one chunk), with the fewest windows a chunk
    # that do
    per_chunk = H * -(-Tq // 64)
    if dtype == torch.bfloat16:
        per_chunk *= -(-Tk // 64)
    fit = max(1, 528 // per_chunk)
    assert chunks <= fit
    assert wpc == 1 or -(-G // (wpc - 1)) > fit
