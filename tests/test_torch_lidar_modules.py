"""LiDAR-track modules of the port against the JAX package.

Same numpy weights (via the weight bridge) and inputs on both sides, f32 on
the CPU.  Tolerances: 1e-5 abs/rel for single layers and geometry; 1e-4 for
the conv backbones (sums in another order through several convs and
BatchNorms); updated BatchNorm statistics 1e-5 (the same f32 means summed in
another order).
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobevt_tpu.geometry import warp as jw
from cobevt_tpu.models.fusion import zoo as jz
from cobevt_tpu.models.lidar import bev_backbone as jb
from cobevt_tpu.models.lidar import misc as jmisc
from cobevt_tpu.models.lidar import pillar_encoder as jp
from cobevt_tpu_torch.geometry import warp as pw
from cobevt_tpu_torch.models.fusion import zoo as pz
from cobevt_tpu_torch.models.lidar import bev_backbone as pb
from cobevt_tpu_torch.models.lidar import misc as pmisc
from cobevt_tpu_torch.models.lidar import pillar_encoder as pp
from cobevt_tpu_torch.utils.weights import (
    jax_tree_to_state_dict,
    seeded_init_,
)
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

TOL = dict(atol=1e-5, rtol=1e-5)
CONV_TOL = dict(atol=1e-4, rtol=1e-4)
VOXEL_SIZE = (0.4, 0.4, 4.0)
PC_RANGE = (-8.0, -8.0, -3.0, 8.0, 8.0, 1.0)


def _voxels(n_vox=40, P=16, seed=0):
    rng = np.random.RandomState(seed)
    feats = np.zeros((n_vox, P, 4), np.float32)
    nums = rng.randint(1, P + 1, n_vox).astype(np.int32)
    coords = np.zeros((n_vox, 4), np.int32)
    coords[:, 2] = rng.randint(0, 40, n_vox)
    coords[:, 3] = rng.randint(0, 40, n_vox)
    for i in range(n_vox):
        feats[i, :nums[i]] = rng.randn(nums[i], 4)
    return feats, nums, coords


def _check_statistics(port, updates):
    want = jax_tree_to_state_dict(port, {"batch_stats":
                                         updates["batch_stats"]})
    got = port.state_dict()
    assert want and all("running_" in k for k in want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k, **TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("last_layer", [False, True])
def test_pfn_layer(train, last_layer):
    rng = np.random.RandomState(1)
    x = rng.randn(12, 6, 10).astype(np.float32)
    x[:, 4:] = 0.0                      # padded point rows, zeroed before
    mask = np.ones((12, 6), np.float32)
    jm = jp.PFNLayer(16, True, last_layer)
    v = jax_variables(jm, jnp.asarray(x), jnp.asarray(mask), False)
    port = port_from(pp.PFNLayer(10, 16, True, last_layer), v)
    if train:
        want, updates = jax_apply(jm, v, jnp.asarray(x), jnp.asarray(mask),
                                  True, mutable=["batch_stats"])
        port.train()
    else:
        want = jax_apply(jm, v, jnp.asarray(x), jnp.asarray(mask), False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == ((12, 1, 16) if last_layer else (12, 6, 16))
    assert_close(got, want, **TOL)
    if train:
        _check_statistics(port, updates)
        # torch momentum 0.01 is flax momentum 0.99
        assert port.norm.momentum == 0.01 and port.norm.eps == 1e-3


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("filters", [(32,), (16, 32)])
def test_pillar_vfe(train, filters):
    feats, nums, coords = _voxels()
    jm = jp.PillarVFE(filters, True, False, True, VOXEL_SIZE, PC_RANGE)
    jargs = (jnp.asarray(feats), jnp.asarray(nums), jnp.asarray(coords))
    v = jax_variables(jm, *jargs, False)
    port = port_from(pp.PillarVFE(filters, True, False, True, VOXEL_SIZE,
                                  PC_RANGE), v)
    if train:
        want, updates = jax_apply(jm, v, *jargs, True,
                                  mutable=["batch_stats"])
        port.train()
    else:
        want = jax_apply(jm, v, *jargs, False)
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(nums),
                   torch.from_numpy(coords))
    assert got.shape == (40, filters[-1])
    assert_close(got, want, **TOL)
    if train:
        _check_statistics(port, updates)


def test_pillar_vfe_with_distance_and_relative_xyz():
    feats, nums, coords = _voxels(seed=2)
    jm = jp.PillarVFE((16,), True, True, False, VOXEL_SIZE, PC_RANGE)
    jargs = (jnp.asarray(feats), jnp.asarray(nums), jnp.asarray(coords))
    v = jax_variables(jm, *jargs, False)
    port = port_from(pp.PillarVFE((16,), True, True, False, VOXEL_SIZE,
                                  PC_RANGE), v)
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(nums),
                   torch.from_numpy(coords))
    assert_close(got, jax_apply(jm, v, *jargs, False), **TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_pillar_scatter_with_collisions_and_masked_voxels(masked):
    rng = np.random.RandomState(3)
    N, C, nx, ny, B = 60, 8, 6, 5, 2        # 60 pillars into 60 cells
    feats = rng.randn(N, C).astype(np.float32)
    coords = np.zeros((N, 4), np.int32)
    coords[:, 0] = rng.randint(0, B, N)
    coords[:, 2] = rng.randint(0, ny, N)
    coords[:, 3] = rng.randint(0, nx, N)
    cells = coords[:, 0] * nx * ny + coords[:, 2] * nx + coords[:, 3]
    assert len(np.unique(cells)) < N        # some pillars collide
    mask = rng.rand(N) > 0.3 if masked else None
    want = jp.pillar_scatter(jnp.asarray(feats), jnp.asarray(coords), B,
                             (nx, ny, 1),
                             None if mask is None else jnp.asarray(mask))
    got = pp.pillar_scatter(torch.from_numpy(feats), torch.from_numpy(coords),
                            B, (nx, ny, 1),
                            None if mask is None else torch.from_numpy(mask))
    assert got.shape == (B, ny, nx, C)
    assert_close(got, want, **TOL)
    # by hand: masked pillars add nothing, colliding ones add up
    ref = np.zeros((B, ny, nx, C), np.float32)
    for i in range(N):
        if mask is None or mask[i]:
            ref[coords[i, 0], coords[i, 2], coords[i, 3]] += feats[i]
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_pillar_scatter_is_deterministic_and_rounds_once():
    """bf16 features: the colliding pillars are summed in f32 and rounded
    once; a repeat gives the same bits."""
    rng = np.random.RandomState(4)
    N, C = 200, 4
    feats = torch.from_numpy(rng.randn(N, C).astype(np.float32)).bfloat16()
    coords = np.zeros((N, 4), np.int64)
    coords[:, 2] = rng.randint(0, 4, N)
    coords[:, 3] = rng.randint(0, 4, N)
    coords = torch.from_numpy(coords)
    got = pp.pillar_scatter(feats, coords, 1, (4, 4, 1))
    again = pp.pillar_scatter(feats, coords, 1, (4, 4, 1))
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    ref = torch.zeros(16, C)
    ref.index_add_(0, coords[:, 2] * 4 + coords[:, 3], feats.float())
    # ~12 addends a cell, sums up to ~8: one bf16 rounding of the f32 sum
    torch.testing.assert_close(got.float().reshape(16, C),
                               ref.bfloat16().float(), atol=0.0625, rtol=0)
    with pytest.raises(ValueError, match="nz == 1"):
        pp.pillar_scatter(feats, coords, 1, (4, 4, 2))


BACKBONES = {
    "two_levels": dict(layer_nums=(2, 1), layer_strides=(2, 2),
                       num_filters=(16, 32), upsample_strides=(1, 2),
                       num_upsample_filter=(16, 16)),
    "three_levels_stride_4": dict(
        layer_nums=(1, 1, 1), layer_strides=(2, 2, 2),
        num_filters=(8, 16, 16), upsample_strides=(1, 2, 4),
        num_upsample_filter=(8, 8, 8)),
    "downsampling_deblock": dict(
        layer_nums=(1, 1), layer_strides=(2, 2), num_filters=(8, 16),
        upsample_strides=(0.5, 1), num_upsample_filter=(8, 8)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_base_bev_backbone(train, name):
    kw = BACKBONES[name]
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, 24, 8).astype(np.float32)
    jm = jb.BaseBEVBackbone(**kw)
    v = jax_variables(jm, jnp.asarray(x), False)
    port = port_from(pb.BaseBEVBackbone(8, **kw), v)
    if train:
        want, updates = jax_apply(jm, v, jnp.asarray(x), True,
                                  mutable=["batch_stats"])
        port.train()
    else:
        want = jax_apply(jm, v, jnp.asarray(x), False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape[-1] == sum(kw["num_upsample_filter"])
    assert_close(got, want, **CONV_TOL)
    if train:
        _check_statistics(port, updates)


def test_base_bev_backbone_multiscale_levels():
    kw = BACKBONES["two_levels"]
    rng = np.random.RandomState(6)
    x = rng.randn(1, 16, 16, 8).astype(np.float32)
    jm = jb.BaseBEVBackbone(**kw)
    v = jax_variables(jm, jnp.asarray(x), False)
    port = port_from(pb.BaseBEVBackbone(8, **kw), v)
    want, want_levels = jax_apply(jm, v, jnp.asarray(x), False,
                                  return_multiscale=True)
    with torch.no_grad():
        got, levels = port(torch.from_numpy(x), return_multiscale=True)
    assert_close(got, want, **CONV_TOL)
    assert [tuple(t.shape) for t in levels] == [(1, 8, 8, 16), (1, 4, 4, 32)]
    for g, w in zip(levels, want_levels):
        assert_close(g, w, **CONV_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_downsample_conv(train):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 12, 8, 24).astype(np.float32)
    kw = dict(dims=(16, 8), kernel_sizes=(3, 1), strides=(2, 1))
    jm = jb.DownsampleConv(input_dim=24, **kw)
    v = jax_variables(jm, jnp.asarray(x), False)
    port = port_from(pb.DownsampleConv(24, **kw), v)
    if train:
        want, updates = jax_apply(jm, v, jnp.asarray(x), True,
                                  mutable=["batch_stats"])
        port.train()
    else:
        want = jax_apply(jm, v, jnp.asarray(x), False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 6, 4, 8)
    assert_close(got, want, **CONV_TOL)
    if train:
        _check_statistics(port, updates)


@pytest.mark.parametrize("stride", [2, 4])
def test_conv_transpose_weight_rule(stride):
    """A random (asymmetric) kernel: a missing spatial flip or a swapped
    in/out axis shows at once."""
    rng = np.random.RandomState(8 + stride)
    x = rng.randn(2, 5, 3, 6).astype(np.float32)
    jm = fnn.ConvTranspose(4, (stride, stride), strides=(stride, stride),
                           padding="VALID", use_bias=False)
    v = jax_variables(jm, jnp.asarray(x))
    port = port_from(torch.nn.ConvTranspose2d(6, 4, stride, stride,
                                              bias=False), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3,
                                                                    1)
    assert got.shape == (2, 5 * stride, 3 * stride, 4)
    assert_close(got, jax_apply(jm, v, jnp.asarray(x)), **TOL)
    # the rule is not the Conv2d one, and the flip matters
    k = v["params"]["kernel"]
    assert not np.allclose(k, k[::-1, ::-1])


def test_seeded_init_covers_the_lidar_module_types():
    m = torch.nn.Sequential(
        pb.BaseBEVBackbone(8, **BACKBONES["two_levels"]),
        pp.PFNLayer(10, 16, True, True))
    before = {k: t.clone() for k, t in m.state_dict().items()}
    seeded_init_(m, 3)
    after = m.state_dict()
    for k, t in before.items():
        if not k.endswith("num_batches_tracked"):
            assert not torch.equal(t, after[k]), k
    up = m[0].deblocks[1][0]
    assert isinstance(up, torch.nn.ConvTranspose2d)
    # fan-in of a stride-2 2x2 transposed conv: its 32 input channels
    assert abs(float(up.weight.detach().std()) - 32 ** -0.5) < 0.03
    again = torch.nn.Sequential(
        pb.BaseBEVBackbone(8, **BACKBONES["two_levels"]),
        pp.PFNLayer(10, 16, True, True))
    seeded_init_(again, 3)
    for k, t in again.state_dict().items():
        assert torch.equal(t, after[k]), k


@pytest.mark.parametrize("masked", [False, True])
def test_max_fusion(masked):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 3, 4, 5, 6).astype(np.float32)
    mask = np.array([[1, 0, 1], [1, 1, 0]], np.float32) if masked else None
    got = pz.max_fusion(torch.from_numpy(x),
                        None if mask is None else torch.from_numpy(mask))
    want = jz.max_fusion(jnp.asarray(x),
                         None if mask is None else jnp.asarray(mask))
    assert_close(got, want, atol=0, rtol=0)


def test_mean_vfe_and_height_compression():
    feats, nums, _ = _voxels(seed=10)
    nums[3] = 0                               # an empty voxel divides by 1
    assert_close(pmisc.mean_vfe(torch.from_numpy(feats),
                                torch.from_numpy(nums)),
                 jmisc.mean_vfe(jnp.asarray(feats), jnp.asarray(nums)), **TOL)
    grid = np.random.RandomState(11).randn(2, 3, 4, 5, 6).astype(np.float32)
    assert_close(pmisc.height_compression(torch.from_numpy(grid)),
                 jmisc.height_compression(jnp.asarray(grid)), atol=0, rtol=0)


def _poses(B, L, seed):
    """Agent 0 the ego (identity); the others a rotation plus a translation
    in metres."""
    rng = np.random.RandomState(seed)
    tmat = np.tile(np.eye(4, dtype=np.float32), (B, L, 1, 1))
    for b in range(B):
        for l in range(1, L):
            a = rng.uniform(-0.5, 0.5)
            tmat[b, l, :2, :2] = [[np.cos(a), -np.sin(a)],
                                  [np.sin(a), np.cos(a)]]
            tmat[b, l, :2, 3] = rng.uniform(-3, 3, 2)
    return tmat


@pytest.mark.parametrize("hw", [(12, 22), (22, 12)])
def test_sttf_warp_and_roi_mask_on_a_non_square_map(hw):
    """The LiDAR map is 96 x 176 at discrete_ratio 0.4 and downsample_rate
    2; here the same ratio at 12 x 22 (and transposed), L 2."""
    H, W = hw
    rng = np.random.RandomState(12)
    tmat = _poses(2, 2, seed=13)
    x = rng.randn(2, 2, H, W, 3).astype(np.float32)
    agent_mask = np.array([[1.0, 1.0], [1.0, 0.0]], np.float32)
    got = pw.sttf_warp(torch.from_numpy(x), torch.from_numpy(tmat), 0.4, 2)
    want = jw.sttf_warp(jnp.asarray(x), jnp.asarray(tmat), 0.4, 2)
    assert got.shape == (2, 2, H, W, 3)
    assert_close(got, want, **TOL)
    # the ego's map comes through untouched; the other agent's is moved
    np.testing.assert_allclose(got[:, 0].numpy(), x[:, 0], **TOL)
    assert not np.allclose(got[:, 1].numpy(), x[:, 1], atol=1e-3)
    got_m = pw.roi_and_agent_mask((2, 2, H, W), torch.from_numpy(agent_mask),
                                  torch.from_numpy(tmat), 0.4, 2)
    want_m = jw.roi_and_agent_mask((2, 2, H, W), jnp.asarray(agent_mask),
                                   jnp.asarray(tmat), 0.4, 2)
    assert_close(got_m, want_m, atol=0, rtol=0)
    assert 0 < float(got_m[0, 1].mean()) < 1     # the warp cut the ROI
    assert float(got_m[1, 1].max()) == 0         # a padded agent has none
