"""The port's dense CVT (``models/cvt_dense.py``, ``models/cvt_nuscenes.py``)
against the JAX package's, on the CPU.

OPV2V side: one ``DenseCrossViewAttention`` stage and the two-stage
``CrossViewModule`` at dim 16, 2 heads of 8, feature maps 8 x 8 x 12 and
4 x 4 x 24 of 64 x 64 images, 2 agents x 2 cameras, BEV 32 (a 4 x 4 grid).
nuScenes side: ``CVTNuScenesEncoder`` and the whole ``CrossViewTransformer``
at EfficientNet-b0 (``reduction_2``, ``reduction_4``), 2 cameras of 64 x
128, dim 16, BEV 40 (a 5 x 5 grid), with BatchNorm statistics from a
calibration batch as in ``tests/test_torch_sinbevt_nuscenes.py``.  Camera
poses are rotated and shifted, so both inversions matter.  The same numpy
weights and inputs go to both sides.  Tolerance in f32: 1e-5 abs / 1e-4 rel
on one stage, 1e-4 abs / 1e-3 rel on the stacked modules and the nuScenes
model.  One stage in bf16 on both sides (the scores, softmax and value
product in f32 from bf16 operands, the rest rounded to bf16): 3e-2 abs /
3e-2 rel on its LayerNorm-scaled output, where the two packages' bf16
LayerNorms and products differ by a few bf16 ulps.  At 128 keys a
query that rounding alone does not separate bf16 from f32 scores (both
drift 0.023-0.031 at most); the full-width gate of ``chip_smoke.py``
phase 18 (bf16 against the f32 plain forward) reads that drift.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.models import cvt_dense as jcvt
from cobevt_tpu.models import cvt_nuscenes as jcn
from cobevt_tpu.models import sinbevt_nuscenes as jsn
from cobevt_tpu_torch.models import cvt_dense as pcvt
from cobevt_tpu_torch.models import cvt_nuscenes as pcn
from cobevt_tpu_torch.models import sinbevt_nuscenes as psn
from tests.torch_parity import (
    assert_close,
    calibrate_bn,
    jax_apply,
    jax_variables,
    jnp_tree,
    port_from,
    torch_tree,
)

ONE_STAGE = dict(atol=1e-5, rtol=1e-4)
STACKED = dict(atol=1e-4, rtol=1e-3)
BF16 = dict(atol=3e-2, rtol=3e-2)
IMG, DIM = 64, 16
SHAPES = ((8, 8, 12), (4, 4, 24))


def camera_poses(rng, lead, h, w):
    """Pinhole intrinsics and rotated, shifted extrinsics of shape
    ``lead`` + (3, 3) / (4, 4)."""
    intr = np.zeros(lead + (3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = 60.0
    intr[..., 0, 2] = w / 2
    intr[..., 1, 2] = h / 2
    intr[..., 2, 2] = 1.0
    extr = np.tile(np.eye(4, dtype=np.float32), lead + (1, 1))
    a = rng.uniform(-np.pi, np.pi, lead)
    extr[..., 0, 0] = extr[..., 2, 2] = np.cos(a)
    extr[..., 0, 2] = np.sin(a)
    extr[..., 2, 0] = -np.sin(a)
    extr[..., :3, 3] = rng.randn(*lead, 3) * 0.5
    return intr, extr


def opv2v_cvm():
    kw = dict(dim=DIM, middle=(1, 1), backbone_output_shape=SHAPES,
              image_height=IMG, image_width=IMG, heads=2, dim_head=8,
              bev_height=32, bev_width=32, decoder_blocks=3)
    return jcvt.CVTModuleConfig(**kw), pcvt.CVTModuleConfig(**kw)


def stage_inputs(seed, b=2, n=2, fh=8, fw=8, fc=12):
    """(x, world, feature, I_inv, E_inv) of one dense stage."""
    rng = np.random.RandomState(seed)
    intr, extr = camera_poses(rng, (b, n), IMG, IMG)
    return (rng.randn(b, 4, 4, DIM).astype(np.float32),
            jcvt.dense_bev_grid(32, 32, 100.0, 100.0, 0.0, 3),
            rng.randn(b, n, fh, fw, fc).astype(np.float32),
            np.linalg.inv(intr).astype(np.float32), extr)


def stage_modules(no_image_features, skip):
    args = (8, 8, 12, DIM, IMG, IMG, 2, 8, True, no_image_features, skip)
    return jcvt.DenseCrossViewAttention(*args), \
        pcvt.DenseCrossViewAttention(*args)


@pytest.mark.parametrize("no_image_features,skip",
                         [(False, True), (True, False)])
def test_dense_cross_view_attention(no_image_features, skip):
    jm, pm = stage_modules(no_image_features, skip)
    inputs = stage_inputs(0)
    variables = jax_variables(jm, *jnp_tree(inputs), False, seed=1)
    want = jax_apply(jm, variables, *inputs, False)
    port = port_from(pm, variables)
    with torch.no_grad():
        got = port(*torch_tree(inputs))
    assert got.shape == (2, 4, 4, DIM)
    assert_close(got, want, **ONE_STAGE)


def test_dense_cross_view_attention_in_bf16():
    """Both packages' bf16 stage agree within the bf16 budget."""
    jm, pm = stage_modules(False, True)
    jm = jcvt.DenseCrossViewAttention(*[getattr(jm, f) for f in (
        "feat_height", "feat_width", "feat_dim", "dim", "image_height",
        "image_width", "heads", "dim_head", "qkv_bias")],
        dtype=jnp.bfloat16)
    inputs = stage_inputs(2)
    variables = jax_variables(jm, *jnp_tree(inputs), False, seed=3)
    x = inputs[0]
    bf_inputs = (jnp.asarray(x, jnp.bfloat16),) + tuple(
        jnp.asarray(a) for a in inputs[1:])
    want = jax_apply(jm, variables, *bf_inputs, False)
    port = port_from(pm, variables).to(torch.bfloat16)
    t_inputs = list(torch_tree(inputs))
    t_inputs[0] = t_inputs[0].to(torch.bfloat16)
    t_inputs[2] = t_inputs[2].to(torch.bfloat16)
    with torch.no_grad():
        got = port(*t_inputs)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_close(got, want, **BF16)


def test_cross_view_module():
    jcfg, pcfg = opv2v_cvm()
    rng = np.random.RandomState(4)
    b, l, n = 1, 2, 2
    feats = [rng.randn(b, l, n, *s).astype(np.float32) for s in SHAPES]
    intr, extr = camera_poses(rng, (b, l, n), IMG, IMG)
    jm = jcvt.CrossViewModule(jcfg)
    args = (feats, intr, extr)
    variables = jax_variables(jm, *jnp_tree(args), False, seed=5)
    want = jax_apply(jm, variables, *args, False)
    port = port_from(pcvt.CrossViewModule(pcfg), variables)
    with torch.no_grad():
        got = port(*torch_tree(args))
    assert got.shape == (b, l, 4, 4, DIM)
    assert_close(got, want, **STACKED)


def nusc_cfg(mod):
    return mod.CVTNuScenesConfig(
        dim=DIM, middle=(1, 1), image_height=64, image_width=128,
        backbone_model="efficientnet-b0",
        backbone_layers=("reduction_2", "reduction_4"), heads=2,
        dim_head=8, bev_height=40, bev_width=40, remat_backbone=False)


def nusc_batch(seed, B=2, n=2):
    rng = np.random.RandomState(seed)
    intr, extr = camera_poses(rng, (B, n), 64, 128)
    return {"image": rng.rand(B, n, 64, 128, 3).astype(np.float32),
            "intrinsics": intr, "extrinsics": extr}


@pytest.fixture(scope="module")
def nuscenes_models():
    jm = jsn.CrossViewTransformer(nusc_cfg(jcn), decoder_blocks=(32, 32, 16),
                                  dim_last=16)
    port = psn.CrossViewTransformer(nusc_cfg(pcn),
                                    decoder_blocks=(32, 32, 16), dim_last=16)
    v = jax_variables(jm, jnp_tree(nusc_batch(0)), False, seed=6)
    torch.manual_seed(0)
    port = port_from(port, v)
    v = calibrate_bn(port, v, torch_tree(nusc_batch(7, B=4)))
    return jm, v, port


def test_cvt_nuscenes_encoder(nuscenes_models):
    jm, v, port = nuscenes_models
    assert isinstance(port.encoder, pcn.CVTNuScenesEncoder)
    batch = nusc_batch(8)
    enc = jcn.CVTNuScenesEncoder(jm.encoder_config)
    want = jax_apply(enc, {col: v[col]["encoder"] for col in v},
                     jnp_tree(batch), False)
    with torch.no_grad():
        got = port.encoder(torch_tree(batch))
    assert got.shape == (2, 5, 5, DIM)
    assert_close(got, want, **STACKED)


def test_cvt_nuscenes_model(nuscenes_models):
    jm, v, port = nuscenes_models
    batch = nusc_batch(9)
    want = jax_apply(jm, v, jnp_tree(batch), False)
    with torch.no_grad():
        got = port(torch_tree(batch))
    assert tuple(got["bev"].shape) == (2, 40, 40, 1)
    assert_close(got, want, **STACKED)
