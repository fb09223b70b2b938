"""The port's train-side tools on the CPU: the packed-weight cache across
an optimizer update, the benchmark and gradient-gate entry points at a
small config, and that the port's sources import nothing of JAX.

No JAX oracle here: the step itself is held against JAX in
``test_torch_train_step.py``.  Fused against stock eval outputs: 1e-4 abs /
1e-3 rel (the two paths sum in another order, as in
``test_torch_corpbevt.py``).
"""

import glob
import math
import os
import re

import pytest
import torch

from cobevt_tpu_torch import ops
from cobevt_tpu_torch.models import fax as port_fax
from cobevt_tpu_torch.models.corpbevt import CorpBEVT
from cobevt_tpu_torch.models.fusion import swap_fusion as port_fusion
from cobevt_tpu_torch.tools import benchmark, validate_kernels
from cobevt_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from cobevt_tpu_torch.train.optim import constant_schedule
from tests.test_corpbevt_parity import our_config
from tests.test_torch_train_step import dryrun_config, port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pack_cache_follows_the_optimizer_update(monkeypatch):
    """K2 and K4 pack their weights once and reuse them while the
    parameters' versions stand.  An in-place AdamW update must rebuild
    them: after a train step the fused eval forward equals the stock one
    on the updated weights."""
    cfg = port_config(our_config())
    model, batch, _ = benchmark.build_corpbevt(config=cfg)
    criterion, train_batch = benchmark.make_criterion("corpbevt", model,
                                                      batch)
    calls = {"K2": 0, "K4": 0}
    for name, module, attr in (("K2", port_fax, "fused_cross_view_attention"),
                               ("K4", port_fusion, "fused_swap_fusion")):
        def wrapped(*a, _real=getattr(module, attr), _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(module, attr, wrapped)

    def eval_forward(fused):
        monkeypatch.setenv("COBEVT_FUSED_XATTN", "1" if fused else "0")
        monkeypatch.setenv("COBEVT_FUSED_FUSION", "force" if fused else "0")
        model.eval()
        with torch.no_grad():
            return model(batch)["dynamic_seg"]

    before = eval_forward(fused=True)            # fills the caches
    assert calls == {"K2": 6, "K4": 1}
    schedule = constant_schedule(1e-2)           # a step that shows
    state = create_train_state(
        model, make_optimizer(model.parameters(), schedule), schedule)
    logs = make_train_step(model, criterion)(state, train_batch)
    assert math.isfinite(float(logs["loss"]))
    assert calls == {"K2": 6, "K4": 1}           # training takes neither
    fused = eval_forward(fused=True)
    stock = eval_forward(fused=False)
    assert calls == {"K2": 12, "K4": 2}
    torch.testing.assert_close(fused, stock, atol=1e-4, rtol=1e-3)
    assert float((fused - before).abs().max()) > 1e-2   # the weights moved


def _small_args(*extra):
    return benchmark.parse_args(["--train", "--iters", "2", "--warmup", "1",
                                 "--fp32", "--batch", "2", *extra])


def test_measure_train_on_the_cpu_reports_no_device_time():
    cfg = port_config(dryrun_config())
    model, batch, key = benchmark.build_corpbevt(config=cfg)
    assert key == "inputs" and batch["inputs"].shape == (1, 2, 4, 64, 64, 3)
    row = benchmark.measure_train(model, "corpbevt", batch, _small_args(),
                                  torch.device("cpu"))
    assert row["device"] == "cpu" and row["clock"] == "host"
    assert "ms_per_step" not in row and "peak_memory_gb" not in row
    assert row["host_ms_per_step"] > 0 and row["steps"] == 3
    assert row["batch"] == 2 and row["precision"] == "fp32"
    # CPU tensors run the plain versions: no launch is counted
    assert row["k1_launches_per_step"] == row["k5_launches_per_step"] == 0
    assert math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])


@pytest.mark.parametrize("module", [benchmark, validate_kernels])
def test_entry_points_refuse_to_run_without_a_card(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert module.main(["--train"]) == 1
    assert "--device cpu" in capsys.readouterr().err


def test_gradient_gate_at_a_small_config_on_the_cpu():
    report = validate_kernels.validate_train(
        torch.device("cpu"), bf16=False, config=port_config(dryrun_config()))
    assert report["ok"] and report["precision"] == "fp32"
    # in f32 the three backward paths are the same arithmetic
    assert report["loss"]["rel"] < 1e-6
    assert report["grad_norm"]["rel"] < 1e-4
    assert report["bf16_cast_drift"]["gnorm_rel"] < 1e-4
    assert set(report["launches"].values()) == {0}
    assert not os.environ.get("COBEVT_FLASH_BWD")
    assert not os.environ.get("COBEVT_FLASH_BWD_F32")


def test_gradient_gate_trips_on_a_wrong_backward():
    def step(loss, norms):
        # (loss, parts, gradients): one-element gradients of these norms
        return loss, {}, {k: torch.tensor([v], dtype=torch.float64)
                          for k, v in norms.items()}

    def compare(got, ref):
        return validate_kernels.compare_step(
            got, ref, *validate_kernels.TRAIN_BUDGETS["corpbevt"],
            metric="norm")

    norms = {"a.weight": 3.0, "b.weight": 4.0, "k.bias": 1e-6}
    stock = step(1.0, norms)
    assert compare(stock, stock)["ok"]
    # one large layer off by a fifth: relative and material
    report = compare(step(1.0, dict(norms, **{"a.weight": 3.6})), stock)
    assert not report["ok"] and report["param_failures"] == ["a.weight"]
    # a noise-tier gradient that grew beyond three signal floors
    report = compare(step(1.0, dict(norms, **{"k.bias": 0.02})), stock)
    assert not report["ok"] and report["noise_tier_failures"] == ["k.bias"]
    # a drifted loss, and a non-finite one
    assert not compare(step(1.02, norms), stock)["ok"]
    assert not compare(step(float("nan"), norms), stock)["ok"]


def test_port_sources_name_no_jax_import():
    files = glob.glob(os.path.join(REPO, "cobevt_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 30
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|cobevt_tpu)(\.|\s|$)", re.M)
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_launch_counters_cover_every_ported_kernel():
    names = set(ops.launch_counts())
    assert names == {"fused_window_attention_packed",
                     "fused_window_attention_packed_bwd",
                     "fused_window_attention", "fused_cross_view_attention",
                     "fused_conv3x3", "fused_swap_fusion",
                     "fused_swap_fusion_streaming", "fused_conv3x3_int8",
                     "conv3x3_s8", "int8_absmax",
                     "bn_stats_fwd", "bn_stats_bwd",
                     "fused_ffd", "fused_ffd_bwd"}
    with open(os.path.join(REPO, "cobevt_tpu_torch", "csrc",
                           "fused_swap_fusion_streaming.cu")) as f:
        text = f.read()
    assert 'extern "C" int cobevt_fusion_stream_sublayer(' in text
    assert "torch/extension.h" not in text
    for name in ("window_attention", "window_attention_bwd"):
        with open(os.path.join(REPO, "cobevt_tpu_torch", "csrc",
                               f"{name}.cu")) as f:
            text = f.read()
        assert f'extern "C" int cobevt_{name}(' in text
        assert "torch/extension.h" not in text
        if name == "window_attention":           # K8 shares K1's source
            assert 'extern "C" int cobevt_window_attention_hm(' in text
