"""The int8 serving mode (``COBEVT_INT8=1``) of the ported CorpBEVT against
the JAX package, end to end, and the port's int8 tools on the CPU.

Geometry: the dry-run config of ``tests/test_torch_train_step.py`` with the
ResNet-34 trunk, so that layer3 and layer4 hold K7-eligible blocks (stride 1,
256 and 512 channels) and layer1 runs int8-resident: 64^2 images, max_cav 2,
4 cameras, f32 on the CPU, the same numpy weights and inputs on both sides.
The JAX forward runs op by op (inside one ``jit`` XLA turns the scales'
division by 127 into a multiplication by the reciprocal, which moves a scale
in its last bit and, at a tie, a quantized value by one).

Tolerance on the seg logits: 5e-3 of the largest logit everywhere (measured
1.0e-3 with two live agents, 1.7e-3 with one).  Both
sides quantize the same values to the same integers except where float sums
taken in another order land a value on the other side of a rounding tie;
such a flip is one 127th of a tensor's range at one pixel and reaches the
logits far below the quantization drift itself (percents, bounded below
against the stock path).
"""

import dataclasses
import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cobevt_tpu.models.corpbevt import CorpBEVT as JaxCorpBEVT
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.models.corpbevt import CorpBEVT
from cobevt_tpu_torch.nn import layers as port_layers
from cobevt_tpu_torch.tools import benchmark, serve_camera, validate_kernels
from cobevt_tpu_torch.utils.serving import StagedBucketedRunner
from tests.test_torch_train_step import dryrun_config, port_config
from tests.torch_parity import jax_variables, jnp_tree, port_from

INT8_VARS = ("COBEVT_INT8", "COBEVT_INT8_RESIDENT")


def int8_config():
    return dataclasses.replace(dryrun_config(), encoder_num_layers=34)


def make_batch(cfg, n_live, seed=0):
    rng = np.random.RandomState(seed)
    L, M, S = cfg.max_cav, 4, cfg.image_height
    inputs = np.zeros((1, L, M, S, S, 3), np.float32)
    inputs[:, :n_live] = rng.rand(1, n_live, M, S, S, 3)
    intr = np.tile(np.eye(3, dtype=np.float32), (1, L, M, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = 60.0
    intr[..., 0, 2] = intr[..., 1, 2] = S / 2
    extr = np.tile(np.eye(4, dtype=np.float32), (1, L, M, 1, 1))
    extr[..., :3, 3] = rng.randn(1, L, M, 3) * 0.5
    tmat = np.tile(np.eye(4, dtype=np.float32), (1, L, 1, 1))
    tmat[0, 1:, :2, 3] = rng.uniform(-2, 2, (L - 1, 2))
    mask = (np.arange(L) < n_live)[None].astype(np.float32)
    return {"inputs": inputs, "intrinsic": intr, "extrinsic": extr,
            "transformation_matrix": tmat, "agent_mask": mask}


@pytest.fixture(scope="module")
def models():
    jcfg = int8_config()
    jm = JaxCorpBEVT(jcfg)
    v = jax_variables(jm, jnp_tree(make_batch(jcfg, 2)), False, seed=5)
    port = port_from(CorpBEVT(port_config(jcfg)), v)
    return jm, v, port


@pytest.fixture
def conv_calls(monkeypatch):
    """Counts the trunk's calls of the K3, K7 and chain-conv wrappers."""
    calls = {"K3": 0, "K7": 0, "s8": 0}
    for name, attr in (("K3", "fused_conv3x3"), ("K7", "fused_conv3x3_int8"),
                       ("s8", "conv3x3_s8")):
        def wrapped(*a, _real=getattr(port_layers, attr), _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(port_layers, attr, wrapped)
    return calls


def _port_forward(port, batch):
    with torch.no_grad():
        return port({k: torch.from_numpy(a) for k, a in batch.items()})


@pytest.mark.parametrize("n_live", [2, 1])
def test_int8_forward_matches_jax(models, n_live, monkeypatch, conv_calls):
    jm, v, port = models
    batch = make_batch(jm.config, n_live, seed=n_live)
    stock = _port_forward(port, batch)["dynamic_seg"]
    assert conv_calls == {"K3": 20, "K7": 0, "s8": 0}
    monkeypatch.setenv("COBEVT_INT8", "1")
    want = np.asarray(jm.apply(v, jnp_tree(batch), False)["dynamic_seg"])
    got = _port_forward(port, batch)["dynamic_seg"]
    # ResNet-34: layer1 3 blocks x 2 chain convs; layer2 3 stride-1 blocks on
    # K3; layer3 5 + layer4 2 stride-1 blocks on K7
    assert conv_calls == {"K3": 20 + 6, "K7": 14, "s8": 6}
    assert got.shape == (1, 1, 32, 32, 2) and got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 5e-3 * scale
    # the mode is lossy, and bounded: percents of the stock logits
    rel = float((got - stock).abs().max() / stock.abs().max())
    assert 1e-4 < rel < 0.1, rel


def test_int8_staged_runner_equals_the_full_forward(models, monkeypatch):
    _, _, port = models
    batch = make_batch(port.config, 1, seed=7)
    monkeypatch.setenv("COBEVT_INT8", "1")
    full = _port_forward(port, batch)["dynamic_seg"]
    staged = StagedBucketedRunner(port, port.config.max_cav)(batch)
    # the staged runner encodes the live agent alone; the full forward's
    # per-tensor scales also see the padded agent's zero images, which do not
    # move the maxima here: the same integers, so exact bucketing holds
    torch.testing.assert_close(staged["dynamic_seg"], full, atol=1e-5,
                               rtol=1e-5)


def test_int8_gate_at_the_small_config_on_the_cpu(monkeypatch):
    for var in INT8_VARS:
        monkeypatch.delenv(var, raising=False)
    report = validate_kernels.validate_int8(
        torch.device("cpu"), bf16=False, config=port_config(int8_config()),
        max_cav=2)
    assert report["component"] == "corpbevt_int8_ptq"
    assert report["precision"] == "fp32" and report["budget"] == 0.15
    assert set(report["outputs"]) == {"dynamic_seg", "static_seg"}
    assert set(report["argmax_iou"]) == {"dynamic_seg", "static_seg"}
    assert report["iou_floor"] == 0.99
    assert 0 < report["outputs"]["dynamic_seg"]["rel"] == report["max_rel"]
    sat = report["saturation"]
    assert sat["blocks_sampled"] == 3 and sat["budget"] == 0.01
    assert 0 <= sat["max_sat_frac"] <= 1
    assert report["ok"] == (report["max_rel"] <= 0.15 and sat["ok"] and all(
        i >= 0.99 for i in report["argmax_iou"].values()))
    assert set(report["launches"].values()) == {0}      # CPU: plain versions
    assert not any(v in __import__("os").environ for v in INT8_VARS)


def test_int8_gate_trips():
    good = {"dynamic_seg": torch.tensor([[0.0, 1.0], [1.0, 0.0], [0.2, 0.9]]),
            "static_seg": torch.zeros(3, 2)}
    assert validate_kernels.compare_int8(good, good, [0.001, 0.0])["ok"]
    # clipping beyond 1% of a block's values
    report = validate_kernels.compare_int8(good, good, [0.001, 0.02])
    assert not report["ok"] and not report["saturation"]["ok"]
    assert report["saturation"]["blocks_sampled"] == 2
    # a flipped argmax with a small logit drift: the IoU floor catches it
    flipped = dict(good, dynamic_seg=torch.tensor(
        [[0.0, 1.0], [1.0, 0.0], [0.91, 0.9]]))
    report = validate_kernels.compare_int8(flipped, good, [0.0], budget=0.9)
    assert not report["ok"] and report["argmax_iou"]["dynamic_seg"] < 0.99
    # a drifted logit with the argmax kept: the budget catches it
    drift = dict(good, dynamic_seg=good["dynamic_seg"] * 1.2)
    report = validate_kernels.compare_int8(drift, good, [0.0])
    assert not report["ok"] and report["argmax_iou"]["dynamic_seg"] == 1.0
    assert validate_kernels.argmax_iou(good["dynamic_seg"],
                                       good["dynamic_seg"]) == 1.0


@pytest.mark.parametrize("caller_value", [None, "0"])
def test_benchmark_int8_flag_sets_and_restores_the_switch(
        monkeypatch, capsys, caller_value):
    import os
    if caller_value is None:
        monkeypatch.delenv("COBEVT_INT8", raising=False)
    else:
        monkeypatch.setenv("COBEVT_INT8", caller_value)
    small = port_config(int8_config())
    monkeypatch.setattr(benchmark, "corpbevt_default",
                        lambda max_cav=5: small)
    args = ["--model", "corpbevt", "--device", "cpu", "--fp32", "--iters",
            "1", "--warmup", "0", "--max_cav", "2"]
    assert benchmark.main(args + ["--int8"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["int8"] is True and row["device"] == "cpu" and row["finite"]
    assert row["launches_per_frame"]["fused_conv3x3_int8"] == 0   # CPU
    assert os.environ.get("COBEVT_INT8") == caller_value
    assert benchmark.main(args) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["int8"] is False
    assert benchmark.main(args + ["--int8", "--train"]) == 2
    assert "serving mode" in capsys.readouterr().err


def test_serve_camera_int8_flag(monkeypatch, capsys):
    import os
    monkeypatch.delenv("COBEVT_INT8", raising=False)
    small = port_config(int8_config())
    from cobevt_tpu_torch.configs import presets
    monkeypatch.setattr(presets, "corpbevt_default", lambda: small)
    summary = serve_camera.main(["--synthetic", "2", "--device", "cpu",
                                 "--int8"])
    assert summary["int8"] is True and summary["frames"] == 2
    # CPU tensors: no kernel launches, whatever the mode
    assert summary["conv_launches_per_frame"] == {"K3": 0.0, "K7": 0.0,
                                                  "int8_chain": 0.0}
    assert "COBEVT_INT8" not in os.environ
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "int8"] is True
    summary = serve_camera.main(["--synthetic", "1", "--device", "cpu"])
    assert summary["int8"] is False


def test_env_switches_restores_set_and_unset_values(monkeypatch):
    import os
    monkeypatch.setenv("COBEVT_INT8", "0")
    monkeypatch.delenv("COBEVT_INT8_RESIDENT", raising=False)
    with pytest.raises(RuntimeError):
        with ops.dispatch.env_switches(COBEVT_INT8="1",
                                       COBEVT_INT8_RESIDENT="0"):
            assert os.environ["COBEVT_INT8"] == "1"
            assert os.environ["COBEVT_INT8_RESIDENT"] == "0"
            raise RuntimeError("inside")
    assert os.environ["COBEVT_INT8"] == "0"
    assert "COBEVT_INT8_RESIDENT" not in os.environ
    with ops.dispatch.env_switches(COBEVT_INT8=None):
        assert "COBEVT_INT8" not in os.environ
    assert os.environ["COBEVT_INT8"] == "0"
