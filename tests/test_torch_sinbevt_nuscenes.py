"""The ported SinBEVT-nuScenes model against the JAX package.

Small config of tests/test_nuscenes_model.py (EfficientNet-b0, 2 cameras
of 64 x 128, dims 16/32/64, BEV 40^2), with rotated and shifted camera
poses so the encoder's inversion of intrinsics and extrinsics matters.
The same numpy weights (BatchNorm statistics from a calibration batch, so
the random net is not saturated) and inputs go through the flax module and
the port, f32 on the CPU.  Every model test runs in two configurations
(the ``switches`` fixture): "stock", both packages at
COBEVT_FUSED_XATTN=0 (the port's window attentions through K1's plain
version), and "fused", the serving default, where the port takes K2's
plain version for every cross-view branch.  Tolerance 1e-4 abs / 1e-3
rel on features and logits.  Also: the two resizes, the antialiased
down-scale at scale 0.5, the experiment presets, the weight bridge's round
trip, an import without JAX, the kernels' shape gates at the full-width
nuScenes stage shapes (device-independent), and tools/benchmark.py and the
SinBEVT gate of tools/validate_kernels.py at the small config, with the
faults it plants.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.configs import nuscenes_experiments as jexp
from cobevt_tpu.models import sinbevt_nuscenes as jsn
from cobevt_tpu.utils.torch_port import (
    fit_to_template,
    state_dict_to_numpy,
    torch_to_flax,
)
from cobevt_tpu_torch.configs import nuscenes_experiments as pexp
from cobevt_tpu_torch.models import fax as port_fax
from cobevt_tpu_torch.models import sinbevt_nuscenes as psn
from cobevt_tpu_torch.ops import fused_cross_attention as k2
from cobevt_tpu_torch.ops import window_attention as k1
from cobevt_tpu_torch.tools import benchmark, validate_kernels
from cobevt_tpu_torch.utils.weights import load_jax_variables
from tests.test_nuscenes_model import small_cfg
from tests.torch_parity import (
    assert_close,
    calibrate_bn,
    jax_apply,
    jax_variables,
    jnp_tree,
)

TOL = dict(atol=1e-4, rtol=1e-3)
OUTPUTS = (("bev", (0, 1)), ("center", (1, 2)))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["stock", "fused"])
def switches(request, monkeypatch):
    if request.param == "stock":
        monkeypatch.setenv("COBEVT_FUSED_XATTN", "0")
    else:
        monkeypatch.delenv("COBEVT_FUSED_XATTN", raising=False)
    return request.param


@pytest.fixture
def calls(monkeypatch):
    """Counts the port's calls of the K1 and K2 wrappers in models/fax.py."""
    counts = {"K1": 0, "K2": 0}

    def spy(name, attr):
        real = getattr(port_fax, attr)

        def wrapped(*args, **kwargs):
            counts[name] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(port_fax, attr, wrapped)

    spy("K1", "fused_window_attention_packed")
    spy("K2", "fused_cross_view_attention")
    return counts


def expected_calls(switches):
    """Three stages of two cross-view branches: K2 each on the fused path,
    K1 each on the stock one (no final self-attention on nuScenes)."""
    return {"K1": 0, "K2": 6} if switches == "fused" else {"K1": 6, "K2": 0}


def port_config(jcfg) -> psn.PyramidAxialConfig:
    return psn.PyramidAxialConfig(**dataclasses.asdict(jcfg))


def make_batch(B=2, n=2, h=64, w=128, seed=0):
    """Images in [0, 1], pinhole intrinsics, camera poses rotated about the
    vertical axis and shifted."""
    rng = np.random.RandomState(seed)
    intr = np.zeros((B, n, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = 60.0
    intr[..., 0, 2] = w / 2
    intr[..., 1, 2] = h / 2
    intr[..., 2, 2] = 1.0
    extr = np.tile(np.eye(4, dtype=np.float32), (B, n, 1, 1))
    a = rng.uniform(-np.pi, np.pi, (B, n))
    extr[..., 0, 0] = extr[..., 2, 2] = np.cos(a)
    extr[..., 0, 2] = np.sin(a)
    extr[..., 2, 0] = -np.sin(a)
    extr[..., :3, 3] = rng.randn(B, n, 3) * 0.5
    return {"image": rng.rand(B, n, h, w, 3).astype(np.float32),
            "intrinsics": intr, "extrinsics": extr}


def _torch_batch(batch):
    return {k: torch.from_numpy(a) for k, a in batch.items()}


@pytest.fixture(scope="module")
def models():
    jcfg = small_cfg()
    jm = jsn.CrossViewTransformer(jcfg, decoder_blocks=(64, 64, 32),
                                  dim_last=32, outputs=OUTPUTS)
    v = jax_variables(jm, jnp_tree(make_batch()), False, seed=5)
    port = psn.CrossViewTransformer(port_config(jcfg), (64, 64, 32), 32,
                                    OUTPUTS)
    load_jax_variables(port, v)
    v = calibrate_bn(port, v, _torch_batch(make_batch(B=4, seed=9)))
    return jm, v, port


def test_encoder_matches_jax(models, switches, calls):
    jm, v, port = models
    batch = make_batch(seed=1)
    enc = jsn.PyramidAxialEncoder(jm.encoder_config)
    ev = {col: v[col]["encoder"] for col in v}
    want = jax_apply(enc, ev, jnp_tree(batch), False)
    with torch.no_grad():
        got = port.encoder(_torch_batch(batch))
    assert got.shape == (2, 5, 5, 64)
    assert_close(got, want, **TOL)
    assert calls == expected_calls(switches)


def test_cvt_forward_matches_jax(models, switches, calls):
    jm, v, port = models
    batch = make_batch(seed=2)
    want = jax_apply(jm, v, jnp_tree(batch), False)
    with torch.no_grad():
        got = port(_torch_batch(batch))
    assert {k: tuple(t.shape) for k, t in got.items()} == {
        "bev": (2, 40, 40, 1), "center": (2, 40, 40, 1)}
    assert_close(got, want, **TOL)
    assert calls == expected_calls(switches)


def test_cvt_output_moves_with_its_input(models, switches):
    """Vacuity guard: the logits follow the images."""
    _, _, port = models
    batch = make_batch(seed=3)
    moved = dict(batch, image=np.clip(batch["image"] + 0.1 * np.random
                                      .RandomState(4).rand(
                                          *batch["image"].shape), 0, 1)
                 .astype(np.float32))
    with torch.no_grad():
        a = port(_torch_batch(batch))["bev"]
        b = port(_torch_batch(moved))["bev"]
    assert float((a - b).abs().max()) > 0.01


def test_bridge_round_trip_gives_the_jax_tree(models):
    _, v, port = models
    converted = torch_to_flax(state_dict_to_numpy(port.state_dict()))
    assert set(converted) == set(v)
    for col in v:
        back = fit_to_template(converted[col], v[col])
        jax.tree.map(np.testing.assert_array_equal, back, v[col])


def test_resizes_match_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    # the same two-tap weights, rounded in another order: f32 ulps
    assert_close(psn.upsample_bilinear_2x_align_corners(torch.from_numpy(x)),
                 jsn.upsample_bilinear_2x_align_corners(jnp.asarray(x)),
                 atol=1e-5, rtol=1e-5)
    # 5 -> 13 and 7 -> 10: non-integer ratios, where F.interpolate's
    # nearest rounds differently
    for hw in ((13, 10), (20, 28), (3, 4)):
        got = psn.resize_nearest(torch.from_numpy(x), hw)
        want = jsn.resize_nearest(jnp.asarray(x), hw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_downscale_at_half_matches_jax_resize():
    """scale < 1 shrinks the backbone maps with JAX's antialiased bilinear
    resize; F.interpolate(antialias=True) computes the same filter."""
    rng = np.random.RandomState(7)
    for h, w in ((16, 32), (15, 31), (8, 16)):
        f = rng.randn(2, h, w, 4).astype(np.float32)
        want = jax.image.resize(jnp.asarray(f), (2, h // 2, w // 2, 4),
                                "bilinear")
        assert_close(psn.downscale_features(torch.from_numpy(f), 0.5), want,
                     atol=1e-5, rtol=1e-5)


def test_cvt_at_scale_half_matches_jax(switches):
    jcfg = dataclasses.replace(small_cfg(), scale=0.5,
                               feat_win_size=((2, 4), (2, 4), (2, 4)))
    jm = jsn.CrossViewTransformer(jcfg, decoder_blocks=(32, 32, 16),
                                  dim_last=16)
    batch = make_batch(B=1, seed=8)
    v = jax_variables(jm, jnp_tree(batch), False, seed=6)
    port = psn.CrossViewTransformer(port_config(jcfg), (32, 32, 16), 16)
    load_jax_variables(port, v)
    v = calibrate_bn(port, v, _torch_batch(make_batch(B=2, seed=10)))
    want = jax_apply(jm, v, jnp_tree(batch), False)
    with torch.no_grad():
        got = port(_torch_batch(batch))
    assert_close(got, want, **TOL)


def test_dense_cvt_encoder_builds_at_full_width():
    from cobevt_tpu_torch.models.cvt_nuscenes import (
        CVTNuScenesConfig,
        CVTNuScenesEncoder,
    )
    model = psn.CrossViewTransformer(CVTNuScenesConfig())
    assert isinstance(model.encoder, CVTNuScenesEncoder)
    assert [type(m).__name__ for m in model.encoder.cross_views] == [
        "DenseCrossViewAttention"] * 2
    assert model.decoder.layers[0].up.in_channels == 128


@pytest.mark.parametrize("name", ["cvt_pyramid_axial_nuscenes_vehicle",
                                  "cvt_nuscenes_vehicle",
                                  "cvt_pyramid_axial_nuscenes_road"])
def test_presets_match_jax(name):
    jx, pt = jexp.nuscenes_experiment(name), pexp.nuscenes_experiment(name)
    assert pexp.experiment_to_dict(pt) == jexp.experiment_to_dict(jx)
    assert pt.outputs == jx.outputs and pt.losses == tuple(
        (n, pexp.LossSpec(**dataclasses.asdict(s))) for n, s in jx.losses)
    model = pexp.build_model(pt, half=True)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert model.outputs == jx.outputs
    assert dataclasses.asdict(pt.encoder) == dataclasses.asdict(jx.encoder)
    with pytest.raises(KeyError, match="available"):
        pexp.nuscenes_experiment("no_such_experiment")


def test_module_imports_without_jax():
    code = ("import sys\n"
            "import cobevt_tpu_torch.models.sinbevt_nuscenes\n"
            "import cobevt_tpu_torch.configs.nuscenes_experiments\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('jax', 'flax', 'cobevt_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# The full-width nuScenes stages (PyramidAxialConfig at 224 x 480, BEV 200,
# b4 endpoints padded to window multiples): (BEV H = W, q_win, keys (h, w)
# after padding, k_win, dim, heads, query segments of the local branch)
STAGES = [(100, 10, (60, 120), (6, 12), 32, 1, 6),
          (50, 10, (30, 60), (6, 12), 64, 2, 1),
          (25, 25, (14, 30), (14, 30), 128, 4, 1)]


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_full_width_stages_take_k2(stage, switches):
    """On the serving default the port's gate sends both branches of every
    full-width stage to K2 (the JAX gate's VMEM budget sends stage 2 to the
    stock modules on a TPU; the port's ``kernel_accepts`` has no such
    term), and ``kernel_path`` routes every stage's bf16 branches to the
    wgmma kernels (stages 0 and 1 at D 32 / 64 since their redesign; the
    mma.sync kernels before); COBEVT_FUSED_XATTN=0 sends none."""
    H, qw, (h, w), kw, dim, heads, nq = STAGES[stage]
    cfg = psn.PyramidAxialConfig()
    fh, fw, _ = cfg.feature_shapes()[stage]
    assert (fh, fw) == ((56, 120), (28, 60), (14, 30))[stage]
    assert (-(-fh // kw[0]) * kw[0], -(-fw // kw[1]) * kw[1]) == (h, w)
    assert k2.kernel_accepts(dim, heads * 32, heads, 6 * kw[0] * kw[1],
                             2 * dim)
    assert port_fax.fused_xattn_ok(H, H, (qw, qw), h, w, kw, dim, heads,
                                   32, 6, 2 * dim) == (switches == "fused")
    routes = {k2.kernel_path(torch.bfloat16, dim, heads * 32, heads,
                             2 * dim, q) for q in {nq, 1}}
    assert routes == {"wgmma"}
    assert k2.kernel_path(torch.float32, dim, heads * 32, heads, 2 * dim,
                          1) == "scalar"


@pytest.mark.parametrize("Tq,Tk", [(100, 432), (600, 432), (625, 2520),
                                   (1, 8), (63, 64)])
def test_k1_takes_ragged_query_windows(Tq, Tk):
    """K1 takes any Tq >= 1 (rows past Tq are neither read as live queries
    nor written); Tk stays a multiple of 8.  K5 takes the same shapes since
    the nuScenes training slice; K8 keeps its multiples of 8."""
    k1.check_k1_shapes(torch.bfloat16, Tq, Tk, 32)
    with pytest.raises(ValueError, match="multiples of 8"):
        k1.check_k1_shapes(torch.bfloat16, Tq, Tk + 4, 32)
    k1.check_k5_shapes(torch.bfloat16, Tq, Tk, 32)
    with pytest.raises(ValueError, match="multiples of 8"):
        k1.check_k5_shapes(torch.bfloat16, Tq, Tk + 4, 32)
    if Tq % 8:
        with pytest.raises(ValueError, match="multiples of 8"):
            k1.check_k8_shapes(torch.bfloat16, Tq, Tk, 32)


def small_experiment():
    return pexp.NuScenesExperiment(
        name="small", encoder=port_config(small_cfg()),
        decoder_blocks=(64, 64, 32), dim_last=32, outputs=OUTPUTS)


def test_benchmark_sinbevt_at_a_small_config_on_the_cpu():
    model, batch, key = benchmark.build_sinbevt(config=small_experiment())
    assert key == "image" and tuple(batch["image"].shape) == (
        1, 6, 64, 128, 3)
    opt = benchmark.parse_args(["--model", "sinbevt", "--iters", "1",
                                "--warmup", "0", "--device", "cpu"])
    row = benchmark.measure_eval(model, "sinbevt", batch, opt,
                                 torch.device("cpu"))
    assert row["outputs"] == {"bev": [1, 40, 40, 1], "center": [1, 40, 40, 1]}
    assert row["finite"] and row["clock"] == "host"
    assert "ms_per_frame" not in row
    assert not any(row["launches_per_frame"].values())


def test_sinbevt_gate_at_a_small_config_on_the_cpu():
    report = validate_kernels.validate_sinbevt(
        torch.device("cpu"), seeds=(0,), config=small_experiment())
    seed = report["per_seed"][0]
    for name in ("bf16_default_vs_f32_plain", "default_vs_stock"):
        assert np.isfinite(seed[name]["max_rel"])
        assert 0.0 <= seed[name]["argmax_iou"]["bev"] <= 1.0
    assert not any(n for c in seed["launches"].values() for n in c.values())


def test_sinbevt_gate_trips_on_a_wrong_branch(monkeypatch):
    """A cross-view branch that returns its input unchanged on the default
    path shows as default-vs-stock drift beyond the budget."""
    monkeypatch.setattr(port_fax, "fused_cross_view_attention",
                        lambda x, *args, **kwargs: x)
    report = validate_kernels.validate_sinbevt(
        torch.device("cpu"), seeds=(0,), config=small_experiment())
    assert not report["ok"]
    assert report["max_rel"]["default_vs_stock"] > report["budget"]


def test_planted_faults_reach_their_call():
    """Each planted fault of the gate changes only the run whose wrapper it
    changes: a K2 fault both comparisons, a K1 fault default vs stock only
    (the default path runs no K1); a dropped head moves the drift far past
    the sound run's."""
    cpu = torch.device("cpu")
    sound = validate_kernels.validate_sinbevt(cpu, seeds=(0,),
                                              config=small_experiment())
    planted = validate_kernels.validate_sinbevt_faults(
        cpu, config=small_experiment())
    assert set(planted["faults"]) == set(validate_kernels.SINBEVT_FAULTS)
    for name, r in planted["faults"].items():
        hit = (("bf16_default_vs_f32_plain", "default_vs_stock")
               if name.startswith("k2") else ("default_vs_stock",))
        for c, drift in r["max_rel"].items():
            if c in hit:
                assert drift != sound["max_rel"][c], (name, c)
            else:
                assert drift == sound["max_rel"][c], (name, c)
            if c in hit and "dropped_head" in name:
                assert drift > 5 * sound["max_rel"][c], (name, c)
