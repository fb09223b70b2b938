"""The cooperative LiDAR slice as a whole: PointPillarFuseBEVT, port vs JAX.

The small configuration of tests/test_lidar_track.py, widened where the
streaming kernel's JAX gate needs it (fused width 128, window 8, head dim
32; a 32 x 32 pillar grid, so a 16 x 16 fused map of 4 windows, 2 agents).
The JAX model's variables are drawn with numpy and carried across by the
weight bridge (strict, nothing left over); the batch is the benchmark tool's
synthetic one, with colliding pillars, a rotated second agent and masked
voxels.  f32 on the CPU.  Tolerance 5e-4 abs / 5e-4 rel on cls_preds and
reg_preds: a PFN layer, 7 convolutions with BatchNorm, a bilinear warp and
one FuseBEVT block summed in another order (the fusion alone is held to 3e-4
in tests/test_torch_fused_swap_fusion_streaming.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.models.fusion import swap_fusion as js
from cobevt_tpu.models.lidar import point_pillar_models as jm
from cobevt_tpu.tools import benchmark as jax_benchmark
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.models.fusion import swap_fusion as ps
from cobevt_tpu_torch.models.lidar import point_pillar_models as pm
from cobevt_tpu_torch.tools import benchmark, validate_kernels
from cobevt_tpu_torch.utils.weights import jax_tree_to_state_dict
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

TOL = dict(atol=5e-4, rtol=5e-4)
SMALL = dict(
    max_cav=2, voxel_size=(0.4, 0.4, 4.0),
    point_cloud_range=(-6.4, -6.4, -3.0, 6.4, 6.4, 1.0), max_voxels=96,
    max_points_per_voxel=8, pillar_filters=(16,), layer_nums=(1, 1),
    layer_strides=(2, 2), num_filters=(16, 32), upsample_strides=(1, 2),
    num_upsample_filter=(16, 16), shrink_dim=128, fusion_window_size=8,
    fusion_dim_head=32, fusion_mlp_dim=256, fusion_depth=1,
    fusion_dropout=0.0, sttf_downsample_rate=2, anchor_num=2)


def _batch(cfg, n_live=2):
    """The tool's synthetic batch at the small size, the second agent
    rotated and shifted, ``n_live`` agents live."""
    _, batch, key = benchmark.build_pointpillar(config=cfg)
    assert key == "voxel_features"
    a = 0.3
    batch["transformation_matrix"][0, 1, :2, :2] = torch.tensor(
        [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    batch["transformation_matrix"][0, 1, :2, 3] = torch.tensor([1.5, -0.8])
    batch["agent_mask"][0, n_live:] = 0.0
    return batch


def _models(fusion, n_live=2, seed=0):
    cfg_kw = dict(SMALL, fusion=fusion)
    batch = _batch(pm.PointPillarConfig(**cfg_kw), n_live)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jmodel = jm.PointPillarFuseBEVT(jm.PointPillarConfig(**cfg_kw))
    v = jax_variables(jmodel, jbatch, False, seed=seed)
    port = port_from(pm.PointPillarFuseBEVT(pm.PointPillarConfig(**cfg_kw)),
                     v)
    return jmodel, v, jbatch, port, batch


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("n_live", [2, 1])
@pytest.mark.parametrize("switch", ["0", "force-stream"])
def test_swap_fusion_forward_matches_jax(monkeypatch, switch, n_live):
    """Both dispatch branches: the stock modules, and K6 (the JAX package
    runs its Pallas body in interpret mode, the port its plain version)."""
    jmodel, v, jbatch, port, batch = _models("swap", n_live)
    monkeypatch.setenv("COBEVT_FUSED_FUSION", switch)
    jax_calls = _spy(monkeypatch, js, "fused_swap_fusion_streaming")
    want = jax_apply(jmodel, v, jbatch, False)
    port_calls = _spy(monkeypatch, ps, "fused_swap_fusion_streaming")
    with torch.no_grad():
        got = port(batch)
    streamed = switch == "force-stream"
    assert bool(jax_calls) == bool(port_calls) == streamed
    assert got["cls_preds"].shape == (1, 16, 16, 2)
    assert got["reg_preds"].shape == (1, 16, 16, 14)
    assert_close(got, want, **TOL)


def test_default_switch_takes_k4_at_the_small_size_and_k6_at_full_width(
        monkeypatch):
    """At full width the JAX package streams (K6), and so does the port, by
    default and under "force-stream"; "0" takes the stock modules
    (SwapFusionEncoder.fused_kernel)."""
    monkeypatch.delenv("COBEVT_FUSED_FUSION", raising=False)
    _, _, _, port, batch = _models("swap")
    assert port.fusion_net.fused_kernel((1, 2, 16, 16, 128)) == "K4"
    full = pm.PointPillarConfig(
        point_cloud_range=benchmark.POINTPILLAR_RANGE)
    assert full.grid_size == (352, 192, 1)
    enc = ps.SwapFusionEncoder(
        input_dim=full.shrink_dim, mlp_dim=full.fusion_mlp_dim,
        agent_size=full.max_cav, window_size=full.fusion_window_size,
        dim_head=full.fusion_dim_head, depth=full.fusion_depth).eval()
    assert enc.fused_kernel((1, 5, 96, 176, 256)) == "K6"
    monkeypatch.setenv("COBEVT_FUSED_FUSION", "force-stream")
    assert enc.fused_kernel((1, 5, 96, 176, 256)) == "K6"
    monkeypatch.setenv("COBEVT_FUSED_FUSION", "0")
    assert enc.fused_kernel((1, 5, 96, 176, 256)) is None


def test_max_fusion_forward_matches_jax():
    jmodel, v, jbatch, port, batch = _models("max", seed=1)
    assert not hasattr(port, "fusion_net")
    with torch.no_grad():
        got = port(batch)
    assert_close(got, jax_apply(jmodel, v, jbatch, False), **TOL)


def test_train_mode_forward_and_batch_statistics_match_jax(monkeypatch):
    """Train mode: batch statistics in the PFN, the backbone and the shrink
    conv (fusion dropout 0), and the running statistics they leave."""
    jmodel, v, jbatch, port, batch = _models("swap", seed=2)
    want, updates = jax_apply(jmodel, v, jbatch, True,
                              mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got = port(batch)
    assert_close(got, want, **TOL)
    stats = jax_tree_to_state_dict(port, {"batch_stats":
                                          updates["batch_stats"]})
    state = port.state_dict()
    assert len(stats) == 2 * 9           # PFN 1, backbone 4 + 2, shrink 2
    for k, w in stats.items():
        np.testing.assert_allclose(state[k].numpy(), w, err_msg=k, atol=1e-5,
                                   rtol=1e-4)


def test_bridge_is_strict_with_nothing_left_over():
    jmodel, v, jbatch, port, _ = _models("swap", seed=3)
    n_leaves = len(jax.tree.leaves(v))
    state = {k: t for k, t in port.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert n_leaves == len(state)
    mapped = jax_tree_to_state_dict(port, v)
    assert set(mapped) == set(state)
    # the transposed conv of stride 2 went through its own rule
    up = v["params"]["backbone"]["deblocks_1_0"]["kernel"]    # (2, 2, I, O)
    np.testing.assert_array_equal(
        mapped["backbone.deblocks.1.0.weight"],
        up[::-1, ::-1].transpose(2, 3, 0, 1))
    # a leaf too many on the JAX side raises
    extra = {"params": dict(v["params"], stray={"kernel": np.zeros((1, 1))}),
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        jax_tree_to_state_dict(port, extra)


def test_two_forwards_of_one_request_agree_bit_for_bit():
    _, _, _, port, batch = _models("swap", seed=4)
    with torch.no_grad():
        a, b = port(batch), port(batch)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_synthetic_batch_is_the_jax_tools_own():
    """Full width: the same numpy draws in the same order as
    cobevt_tpu/tools/benchmark.py:build_pointpillar."""
    _, want, key = jax_benchmark.build_pointpillar(False, 5)
    model, got, port_key = benchmark.build_pointpillar(5)
    assert key == port_key == "voxel_features"
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), k)
    assert got["voxel_features"].shape == (1, 5, 8000, 32, 4)
    cfg = model.config
    assert cfg.grid_size == (352, 192, 1) and cfg.shrink_dim == 256
    # a few hundred of an agent's 8000 pillars share a cell with another
    c = got["voxel_coords"][0, 0]
    cells = (c[:, 2] * 352 + c[:, 3]).numpy()
    assert 100 < 8000 - len(np.unique(cells)) < 1000


def test_measure_eval_on_the_cpu_reports_no_device_time(monkeypatch):
    monkeypatch.setenv("COBEVT_FUSED_FUSION", "force-stream")
    cfg = pm.PointPillarConfig(**SMALL)
    model, batch, _ = benchmark.build_pointpillar(config=cfg)
    opt = benchmark.parse_args(["--model", "pointpillar", "--iters", "2",
                                "--warmup", "1", "--fp32"])
    row = benchmark.measure_eval(model, "pointpillar", batch, opt,
                                 torch.device("cpu"))
    assert row["device"] == "cpu" and row["clock"] == "host"
    assert "ms_per_frame" not in row and "peak_memory_gb" not in row
    assert row["host_ms_per_frame"] > 0 and row["finite"]
    assert row["fused_fusion_switch"] == "force-stream"
    assert row["outputs"] == {"cls_preds": [1, 16, 16, 2],
                              "reg_preds": [1, 16, 16, 14]}
    # CPU tensors run the plain versions: no launch is counted
    assert set(row["launches_per_frame"].values()) == {0.0}


def test_forward_gate_at_the_small_config_on_the_cpu(monkeypatch):
    report = validate_kernels.validate_forward(
        torch.device("cpu"), bf16=False, config=pm.PointPillarConfig(**SMALL))
    assert report["ok"] and report["precision"] == "fp32"
    assert set(report["outputs"]) == {"cls_preds", "reg_preds"}
    # in f32 the fused and the stock path are the same arithmetic
    assert report["max_rel"] < 1e-4
    assert set(report["launches"]["fused"].values()) == {0}
    # and the gate trips on a wrong output
    good = {"a": torch.ones(4)}
    bad = {"a": torch.tensor([1.0, 1.0, 1.0, 1.2])}
    assert validate_kernels.compare_outputs("x", good, good, 0.05)["ok"]
    assert not validate_kernels.compare_outputs("x", bad, good, 0.05)["ok"]
    nan = {"a": torch.tensor([1.0, float("nan"), 1.0, 1.0])}
    assert not validate_kernels.compare_outputs("x", nan, good, 0.05)["ok"]


@pytest.mark.parametrize("module", [benchmark, validate_kernels])
def test_lidar_entry_points_refuse_to_run_without_a_card(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert module.main(["--model", "pointpillar"]) == 1
    assert "--device cpu" in capsys.readouterr().err
    # the LiDAR train step is ported: it too refuses without a card
    assert module.main(["--train", "--model", "pointpillar"]) == 1
    assert "--device cpu" in capsys.readouterr().err
