"""K9 and K10 (BatchNorm-statistics reductions) of the port against the JAX
tool.

The plain versions of ``cobevt_tpu_torch/ops/bn_stats.py`` against ``xla_fwd``
and ``xla_bwd`` of ``cobevt_tpu/tools/micro_bn_stats.py`` on the same numpy
inputs, in bf16 and f32, with a threshold ``s`` that bites and one that does
not.  The tool's Pallas functions cannot run on the CPU (their
``pallas_call`` has no interpret switch), so its XLA twins are the oracle, as
they are the oracle of its own correctness pass.  Tolerance: 1e-5 of the
largest sum (f32 sums of a few thousand terms in another order).  The
route of a CUDA call (``kernel_path``: the CUDA kernel of
``csrc/bn_stats.cu`` or the Triton kernels) and the CUDA kernel's plan (tile
rows, ring stages, blocks, lanes) are pure Python and are tested here; a
numpy walk of that plan, in the kernel's order, gives the plain sums.  The
kernels themselves are held to the plain versions on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cobevt_tpu.tools.micro_bn_stats import xla_bwd, xla_fwd
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.ops import bn_stats
from cobevt_tpu_torch.ops.bn_stats import bn_stats_bwd, bn_stats_fwd
from cobevt_tpu_torch.tools import micro_bn_stats


def _assert_sums_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(5 * 32 * 32, 128), (3000, 144),
                                   (700, 336)])
@pytest.mark.parametrize("s", [-1e30, 0.25])
def test_plain_versions_match_the_jax_tool(dtype, shape, s):
    rng = np.random.RandomState(0)
    x, dy = rng.randn(*shape), rng.randn(*shape)
    tx, tdy = (torch.from_numpy(a.astype(np.float32)).to(
        getattr(torch, dtype)) for a in (x, dy))
    jx, jdy = (jnp.asarray(a, dtype) for a in (x, dy))
    js = jnp.asarray(s, dtype)
    _assert_sums_close(bn_stats_fwd(tx, s), xla_fwd(jx, js))
    _assert_sums_close(bn_stats_bwd(tdy, tx, s), xla_bwd(jdy, jx, js))
    if s > 0:
        # the threshold bites: the sums differ from the untouched ones
        free = bn_stats_fwd(tx, -1e30)[0]
        assert float((bn_stats_fwd(tx, s)[0] - free).abs().min()) > 1.0


def test_threshold_is_cast_to_the_activations_dtype():
    x = torch.full((4, 8), 0.3).bfloat16()
    # 0.3001 rounds to x's own bf16 value, so max(x, s) is x itself
    a = bn_stats_fwd(x, 0.3001)
    b = bn_stats_fwd(x, torch.tensor(0.3001))
    want = 4 * float(x[0, 0])
    for got in (a, b):
        assert torch.equal(got[0], torch.full((8,), want))


def test_cpu_tensors_run_the_plain_versions():
    x = torch.randn(64, 16)
    ops.reset_launch_counts()
    bn_stats_fwd(x, 0.0)
    bn_stats_bwd(x, x, 0.0)
    counts = ops.launch_counts()
    assert counts["bn_stats_fwd"] == counts["bn_stats_bwd"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        bn_stats_fwd(x, 0.0, impl="kernel")
    with ops.forced_impl("kernel"), pytest.raises(ValueError, match="CUDA"):
        bn_stats_bwd(x, x, 0.0)


def test_row_plan_covers_every_row_in_whole_tiles():
    for R in (1, 7, 31, 32, 33, 5 * 128 * 128, 48 * 112 * 240, 10 ** 7):
        P, rows = bn_stats._plan(R)
        assert rows % bn_stats._BLOCK_R == 0
        assert (P - 1) * rows < R <= P * rows
        assert P <= bn_stats._ROW_PROGRAMS


# the JAX tool's four shapes, and ragged row counts at its widths
PLAN_SHAPES = [s for s, _ in micro_bn_stats.SHAPES] + [
    (1, 144), (7, 192), (1000, 336), (40_000, 144), (81_921, 128), (33, 8)]


@pytest.mark.parametrize("C, dtype, aligned, want", [
    (144, torch.bfloat16, True, "cuda"), (192, torch.bfloat16, True, "cuda"),
    (336, torch.bfloat16, True, "cuda"), (128, torch.bfloat16, True, "cuda"),
    (336, torch.float32, True, "cuda"), (8, torch.bfloat16, True, "cuda"),
    (4, torch.float32, True, "cuda"), (4096, torch.bfloat16, True, "cuda"),
    (2048, torch.float32, True, "cuda"),
    # rows that are not whole 16-byte vectors
    (4, torch.bfloat16, True, "triton"), (6, torch.float32, True, "triton"),
    (100, torch.bfloat16, True, "triton"),
    # more vectors a row than consumer threads
    (4104, torch.bfloat16, True, "triton"),
    (2052, torch.float32, True, "triton"),
    # a base off its 16-byte boundary
    (144, torch.bfloat16, False, "triton"),
    # a dtype neither kernel takes
    (144, torch.float16, True, "triton")])
def test_route_by_shape_dtype_and_alignment(C, dtype, aligned, want):
    assert bn_stats.kernel_path(C, dtype, aligned) == want


def test_route_reads_every_operands_base():
    buf = torch.zeros(3 * 64 * 144 + 8, dtype=torch.bfloat16)
    x = buf[:64 * 144].view(64, 144)
    dy = buf[64 * 144:2 * 64 * 144].view(64, 144)
    off = buf[2 * 64 * 144 + 1:3 * 64 * 144 + 1].view(64, 144)
    assert x.data_ptr() % 16 == 0 and off.data_ptr() % 16 == 2
    assert bn_stats.route(x) == bn_stats.route(dy, x) == "cuda"
    assert bn_stats.route(off) == bn_stats.route(dy, off) == "triton"
    assert bn_stats.route(x[:, :100].contiguous()) == "triton"
    assert bn_stats.route(torch.zeros(7, 36)) == "cuda"       # f32, 144 B


@pytest.mark.parametrize("inputs", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_cuda_plan_covers_every_row_in_whole_tiles(shape, dtype, inputs):
    R, C = shape
    elt = 2 if dtype == torch.bfloat16 else 4
    plan = bn_stats.cuda_plan(R, C, dtype, inputs)
    # columns: whole 16-byte vectors, a multiple of them a pass
    assert plan.vectors * 16 == C * elt
    assert plan.consumers == plan.lanes * plan.vectors <= 512
    # rows: whole tiles of a multiple of the lanes (or all R rows)
    assert plan.tile_rows % plan.lanes == 0 or plan.tile_rows == R
    assert (plan.tiles - 1) * plan.tile_rows < R <= plan.tiles * plan.tile_rows
    # one block an SM at most, each a run of whole tiles, balanced
    assert 1 <= plan.blocks <= min(132, plan.tiles)
    runs = [plan.tiles * (b + 1) // plan.blocks
            - plan.tiles * b // plan.blocks for b in range(plan.blocks)]
    assert sum(runs) == plan.tiles and max(runs) - min(runs) <= 1
    # a stage: every input's tile, in 16-byte multiples, one mbarrier's
    # byte count, the ring and the fold within a block's shared memory
    assert plan.stage_bytes == inputs * plan.tile_rows * C * elt
    assert plan.stage_bytes % 16 == 0 and plan.stage_bytes < 1 << 20
    assert 2 <= plan.stages <= 8
    assert plan.smem == max(plan.stages * plan.stage_bytes,
                            plan.lanes * 2 * C * 4) + 16 * plan.stages
    assert plan.smem <= 232448 - 1024


def _walk_plan(plan, tensors, s):
    """The CUDA kernel's order in numpy: block b sums its tiles lane by lane
    (lane l takes the tile's rows l, l + lanes, ...), folds its lanes in
    order into one partial row, and the blocks' rows are added in order."""
    R, C = tensors[0].shape
    f = [t.float().numpy() for t in tensors]
    d = np.maximum(f[0], np.float32(s))
    other = d if len(f) == 1 else f[1]
    parts = []
    for b in range(plan.blocks):
        t0 = plan.tiles * b // plan.blocks
        t1 = plan.tiles * (b + 1) // plan.blocks
        lanes = np.zeros((plan.lanes, 2, C), np.float32)
        for t in range(t0, t1):
            rows = range(t * plan.tile_rows, min(R, (t + 1) * plan.tile_rows))
            for j, r in enumerate(rows):
                lanes[j % plan.lanes, 0] += d[r]
                lanes[j % plan.lanes, 1] += d[r] * other[r]
        parts.append(lanes.sum(0))
    return np.sum(parts, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1000, 336), (777, 144), (5, 8),
                                   (3000, 192)])
def test_a_walk_of_the_cuda_plan_gives_the_plain_sums(shape, dtype):
    rng = np.random.RandomState(1)
    x, dy = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
             for _ in range(2))
    s = bn_stats._rounded(0.1, dtype)
    for tensors, plain in (((x,), bn_stats_fwd(x, 0.1)),
                           ((dy, x), bn_stats_bwd(dy, x, 0.1))):
        # a card of 4 SMs, so that the blocks own several tiles each
        plan = bn_stats.cuda_plan(*shape, dtype, len(tensors), sms=4)
        got = _walk_plan(plan, tensors, s)
        _assert_sums_close(tuple(torch.from_numpy(g) for g in got), plain)


def test_micro_tool_on_the_cpu(capsys):
    assert micro_bn_stats.main(["--device", "cpu", "--rows", "2048",
                                "--threshold", "0.25"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-1])
    assert report["ok"] and report["device"] == "cpu"
    assert report["clock"] is None and report["kernels"] is None
    assert [r["channels"] for r in report["shapes"]] == [144, 192, 336, 128]
    assert [r["name"] for r in report["shapes"]] == [
        name for _, name in micro_bn_stats.SHAPES]
    for row in report["shapes"]:
        assert row["rows"] == 2048 and row["threshold"] == 0.25
        assert row["err_fwd"] < 1e-5 and row["err_bwd"] < 1e-5
        assert not any(k.endswith("_ms") for k in row)     # no device time
    # the JAX tool's four shapes
    assert [s for s, _ in micro_bn_stats.SHAPES] == [
        (48 * 112 * 240, 144), (48 * 56 * 120, 192), (48 * 28 * 60, 336),
        (5 * 128 * 128, 128)]


def test_micro_tool_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert micro_bn_stats.main([]) == 1
    assert "--device cpu" in capsys.readouterr().err


def test_micro_tool_fails_when_an_error_passes_its_tolerance(monkeypatch,
                                                             capsys):
    monkeypatch.setattr(micro_bn_stats, "TOLERANCE", 1e-12)
    assert micro_bn_stats.main(["--device", "cpu", "--rows", "512"]) == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "ok"] is False
