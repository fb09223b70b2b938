"""K9 and K10 (BatchNorm-statistics reductions) of the port against the JAX
tool.

The plain versions of ``cobevt_tpu_torch/ops/bn_stats.py`` against ``xla_fwd``
and ``xla_bwd`` of ``cobevt_tpu/tools/micro_bn_stats.py`` on the same numpy
inputs, in bf16 and f32, with a threshold ``s`` that bites and one that does
not.  The tool's Pallas functions cannot run on the CPU (their
``pallas_call`` has no interpret switch), so its XLA twins are the oracle, as
they are the oracle of its own correctness pass.  Tolerance: 1e-5 of the
largest sum (f32 sums of a few thousand terms in another order).  The Triton
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
