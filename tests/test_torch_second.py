"""SECOND in the port against the JAX package: the three LiDAR hypes
parsers, the dense voxel scatter, ``DenseVoxelBackbone8x``, the Conv3d
weight rule, ``SecondDetector`` (fusion none, max and swap) and one train
step with ``PointPillarLoss``.

Same numpy weights (through the weight bridge) and inputs on both sides,
f32 on the CPU unless stated.  Tolerances: the parsers are equal; the
scatter and the Conv3d rule 1e-5 abs/rel (a single layer); the conv stacks
and the detector 1e-4 abs/rel (sums in another order through many convs and
BatchNorms); the updated BatchNorm statistics 1e-5 (the same f32 means
summed in another order).  The train step runs both sides in f64, since
train-mode BatchNorm over these small maps amplifies f32 rounding far past
the arithmetic under test (``tests/test_torch_camera_zoo_train.py``); its
loss and every gradient 1e-4 of the largest gradient of the model.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobevt_tpu.configs import hypes as jh
from cobevt_tpu.losses.detection_loss import PointPillarLoss as JaxLoss
from cobevt_tpu.models.lidar import second_models as jsm
from cobevt_tpu.models.lidar import voxel_backbone as jvb
from cobevt_tpu_torch.configs import hypes as ph
from cobevt_tpu_torch.losses.detection_loss import PointPillarLoss
from cobevt_tpu_torch.models.lidar import second_models as psm
from cobevt_tpu_torch.models.lidar import voxel_backbone as pvb
from cobevt_tpu_torch.utils.weights import (
    jax_tree_to_state_dict,
    load_jax_variables,
)
from tests.test_second_pipeline import TINY_SECOND_HYPES
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

TOL = dict(atol=1e-5, rtol=1e-5)
CONV_TOL = dict(atol=1e-4, rtol=1e-4)
GRID = (32, 16, 16)


def _lidar_dict():
    """One dict that every parser reads: the SECOND tiny hypes with an
    anchor range of its own and 0.4 x 0.4 x 0.3 m voxels, so
    ``np.round`` (12.8 / 0.3 = 42.67 -> 43) and ``math.ceil`` (-> 43) and
    truncation (-> 42) all show."""
    d = copy.deepcopy(TINY_SECOND_HYPES)
    d["preprocess"]["args"]["voxel_size"] = [0.4, 0.4, 0.3]
    d["preprocess"]["cav_lidar_range"] = [-6.4, -6.4, -6.4, 6.4, 6.4, 6.4]
    d["postprocess"]["anchor_args"]["cav_lidar_range"] = [
        -6.4, -6.4, -6.4, 6.4, 6.4, 6.4]
    return d


@pytest.mark.parametrize("parser", ["load_voxel_params",
                                    "load_second_params",
                                    "load_point_pillar_params"])
def test_lidar_parsers_match(parser, tmp_path):
    d = dict(_lidar_dict(), yaml_parser=parser)
    want = jh.PARSER_REGISTRY[parser](copy.deepcopy(d))
    # the port's load_hypes takes the parser named in the file
    path = os.path.join(tmp_path, "h.yaml")
    with open(path, "w") as f:
        json.dump(d, f)
    got = ph.load_hypes(path)
    assert got == want
    aa = got["postprocess"]["anchor_args"]
    if parser == "load_voxel_params":
        assert aa["D"] == 42 and got["model"]["args"]["D"] == 42
    else:
        assert aa["D"] == 43


def _voxels(n=48, c=4, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(n, c).astype(np.float32)
    coords = np.stack([rng.randint(0, 2, n), rng.randint(0, GRID[0], n),
                       rng.randint(0, GRID[1], n),
                       rng.randint(0, GRID[2], n)], 1).astype(np.int32)
    coords[1:6] = coords[0]                       # duplicates add up
    mask = rng.rand(n) > 0.25
    mask[0] = mask[2] = True
    mask[3] = False                               # a masked duplicate
    return feats, coords, mask


def test_scatter_voxels_dense_matches():
    feats, coords, mask = _voxels()
    want = jvb.scatter_voxels_dense(jnp.asarray(feats), jnp.asarray(coords),
                                    2, GRID, jnp.asarray(mask))
    got = pvb.scatter_voxels_dense(torch.from_numpy(feats),
                                   torch.from_numpy(coords), 2, GRID,
                                   torch.from_numpy(mask))
    assert_close(got, want, **TOL)
    c = coords[0]
    assert np.isclose(got[c[0], c[1], c[2], c[3]].numpy(),
                      feats[[0, 1, 2, 4, 5]][mask[[0, 1, 2, 4, 5]]].sum(0),
                      atol=1e-5).all()


def _grid(seed=1):
    feats, coords, mask = _voxels(n=300, seed=seed)
    return np.asarray(jvb.scatter_voxels_dense(
        jnp.asarray(feats), jnp.asarray(coords), 2, GRID, jnp.asarray(mask)))


def test_conv3d_weight_rule_asymmetric_kernel():
    """conv_out's (3, 1, 1) kernel and the stage convs' distinct taps: a
    transpose in the wrong order breaks either the shapes or the values."""
    jm = jvb.DenseVoxelBackbone8x(4)
    x = jnp.asarray(_grid())
    v = jax_variables(jm, x, False, seed=2)
    port = port_from(pvb.DenseVoxelBackbone8x(4), v)
    kern = v["params"]["conv_out_conv"]["kernel"]         # D, H, W, I, O
    w = port.conv_out_conv.weight.detach().numpy()        # O, I, D, H, W
    assert kern.shape == (3, 1, 1, 64, 128) and w.shape == (128, 64, 3, 1, 1)
    np.testing.assert_array_equal(w[5, 7, :, 0, 0], kern[:, 0, 0, 7, 5])
    k3 = v["params"]["conv2_conv"]["kernel"]
    np.testing.assert_array_equal(port.conv2_conv.weight.detach().numpy()[
        3, 2, 0, 1, 2], k3[0, 1, 2, 2, 3])
    rng = np.random.RandomState(0)
    one = rng.randn(1, 5, 4, 6, 64).astype(np.float32)
    conv = port.conv_out_conv
    want = jax.lax.conv_general_dilated(
        jnp.asarray(one), jnp.asarray(kern), (2, 1, 1), "VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    with torch.no_grad():
        got = conv(torch.from_numpy(one).permute(0, 4, 1, 2, 3)).permute(
            0, 2, 3, 4, 1)
    assert_close(got, want, **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_dense_voxel_backbone_matches(train):
    """Eval in f32; train mode (batch statistics, the updated running
    statistics) in f64 on both sides: conv_out's BatchNorm normalizes over
    2 x 1 x 2 x 2 = 8 values a channel, which amplifies f32 rounding to
    4e-4."""
    jm = jvb.DenseVoxelBackbone8x(4)
    x = _grid()
    v = jax_variables(jm, jnp.asarray(x), False, seed=3)
    port = port_from(pvb.DenseVoxelBackbone8x(4), v)
    if train:
        with jax.enable_x64(True):
            v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
            want, updates = jax_apply(jm, v64, jnp.asarray(x, jnp.float64),
                                      True, mutable=["batch_stats"])
            want, updates = jax.tree.map(np.asarray, (want, updates))
        port = port.double().train()
        x = x.astype(np.float64)
    else:
        want = jax_apply(jm, v, jnp.asarray(x), False)
    with torch.no_grad():
        got = port(torch.from_numpy(x.copy()))
    assert got["encoded_voxel"].shape == (2, 1, 2, 2, 128)
    assert pvb.DenseVoxelBackbone8x.output_depth(GRID[0]) == 1
    assert_close(got["encoded_voxel"], want["encoded_voxel"], **CONV_TOL)
    assert_close(got["multi_scale_3d"], want["multi_scale_3d"], **CONV_TOL)
    if train:
        stats = jax_tree_to_state_dict(
            port, {"batch_stats": updates["batch_stats"]})
        assert len(stats) == 2 * 12
        state = port.state_dict()
        for k, w in stats.items():
            np.testing.assert_allclose(state[k].numpy(), w, err_msg=k, **TOL)


def _hypes(fusion):
    d = copy.deepcopy(TINY_SECOND_HYPES)
    d["model"]["args"]["fusion"] = {"core_method": fusion,
                                    "window_size": 4, "dim_head": 32,
                                    "mlp_dim": 64, "depth": 1}
    return d


def _configs(fusion, tmp_path):
    path = os.path.join(tmp_path, "second.json")
    with open(path, "w") as f:
        json.dump(_hypes(fusion), f)
    pcfg = psm.second_config_from_hypes(ph.load_hypes(path))
    jcfg = jsm.second_config_from_hypes(
        jh.load_second_params(_hypes(fusion)))
    assert dataclasses_equal(pcfg, jcfg)
    return pcfg, jcfg


def dataclasses_equal(p, j):
    import dataclasses
    return dataclasses.asdict(p) == dataclasses.asdict(j)


def _batch(cfg, seed=0):
    """2 agents, the second padded (agent_mask 0, its voxels masked), the
    first's voxels partly masked and colliding; the second turned and
    shifted."""
    rng = np.random.RandomState(seed)
    B, L, N, P = 1, cfg.max_cav, 24, 8
    W, H, D = cfg.grid_size
    coords = np.stack([np.zeros((B, L, N)), rng.randint(0, D, (B, L, N)),
                       rng.randint(0, H, (B, L, N)),
                       rng.randint(0, W, (B, L, N))], -1).astype(np.int32)
    coords[0, 0, 1] = coords[0, 0, 0]
    mask = (rng.rand(B, L, N) > 0.2).astype(np.float32)
    mask[:, 1] = 0.0
    tm = np.tile(np.eye(4, dtype=np.float32), (B, L, 1, 1))
    c, s = np.cos(0.3), np.sin(0.3)
    tm[0, 1, :2, :2] = [[c, -s], [s, c]]
    tm[0, 1, :2, 3] = [1.6, -0.8]
    vf = rng.rand(B, L, N, P, 4).astype(np.float32)
    nums = rng.randint(1, P + 1, (B, L, N)).astype(np.int32)
    vf[np.arange(P)[None, None, None] >= nums[..., None]] = 0.0
    return {"voxel_features": vf, "voxel_num_points": nums,
            "voxel_coords": coords, "voxel_mask": mask,
            "transformation_matrix": tm,
            "agent_mask": np.array([[1.0, 0.0]], np.float32)}


def _models(fusion, tmp_path, seed=4):
    pcfg, jcfg = _configs(fusion, tmp_path)
    batch = _batch(pcfg)
    jm = jsm.SecondDetector(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = jax_variables(jm, jb, False, seed=seed)
    port = psm.SecondDetector(pcfg)
    load_jax_variables(port, v)
    return jm, v, port, batch


@pytest.mark.parametrize("fusion", ["none", "max", "swap"])
def test_second_detector_matches(fusion, tmp_path):
    jm, v, port, batch = _models(fusion, tmp_path)
    want = jax_apply(jm, v, {k: jnp.asarray(a) for k, a in batch.items()},
                     False)
    with torch.no_grad():
        got = port.eval()({k: torch.from_numpy(a) for k, a in batch.items()})
    assert got["cls_preds"].shape == (1, 4, 4, 2)
    assert got["reg_preds"].shape == (1, 4, 4, 14)
    if fusion == "swap":
        # a 4 x 4 map of 64 channels fits K4's gate: the fused path's plain
        # version, as on the card at this size
        assert port.fusion_net.fused_kernel((1, 2, 4, 4, 64)) is not None
    assert_close(got, want, **CONV_TOL)


def _labels(shape_cls, shape_reg, seed=1):
    rng = np.random.RandomState(seed)
    pos = (rng.rand(*shape_cls) < 0.2).astype(np.float32)
    neg = ((1 - pos) * (rng.rand(*shape_cls) < 0.8)).astype(np.float32)
    return {"pos_equal_one": pos, "neg_equal_one": neg,
            "targets": rng.randn(*shape_reg).astype(np.float32)}


def test_second_train_step_loss_and_gradients(tmp_path):
    """One train-mode forward and backward of SECOND + swap fusion with
    the detection loss: loss, its parts and every gradient, f64."""
    jm, v, port, batch = _models("swap", tmp_path, seed=6)
    labels = _labels((1, 4, 4, 2), (1, 4, 4, 14))
    with jax.enable_x64(True):
        jb = {k: jnp.asarray(a, jnp.float64 if a.dtype == np.float32
                             else None) for k, a in batch.items()}
        jl = {k: jnp.asarray(a, jnp.float64) for k, a in labels.items()}
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        loss_fn_j = JaxLoss()

        def loss_fn(params):
            out, _ = jm.apply({"params": params,
                               "batch_stats": v64["batch_stats"]}, jb, True,
                              mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
            total, parts = loss_fn_j(out, jl)
            return total, parts

        (want, want_parts), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v64["params"])
        want = float(want)
        grads = jax.tree.map(np.asarray, grads)
    port = port.double().train()
    tb = {k: torch.from_numpy(a.astype(np.float64) if a.dtype == np.float32
                              else a) for k, a in batch.items()}
    tl = {k: torch.from_numpy(a.astype(np.float64))
          for k, a in labels.items()}
    total, parts = PointPillarLoss()(port(tb), tl)
    total.backward()
    assert np.isfinite(total.item())
    np.testing.assert_allclose(total.item(), want, rtol=1e-4)
    for k in ("cls_loss", "reg_loss"):
        np.testing.assert_allclose(parts[k].item(), float(want_parts[k]),
                                   rtol=1e-4)
    want_g = jax_tree_to_state_dict(port, {"params": grads})
    scale = max(float(np.abs(g).max()) for g in want_g.values())
    params = dict(port.named_parameters())
    assert set(want_g) == set(params)
    for k, g in want_g.items():
        got = params[k].grad
        got = np.zeros_like(g) if got is None else got.numpy()
        np.testing.assert_allclose(got, g, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=k)
