"""The cooperative LiDAR track end to end, port vs JAX: the fixture tree of
``tests/test_lidar_dataset_e2e.py`` -> the LiDAR dataset -> a collated
batch -> PointPillarFuseBEVT at that file's tiny configuration, the JAX
model's variables (drawn with numpy from a seed) carried across by
``utils/weights.py`` -> anchor maps -> decode and NMS -> AP against each
sample's ground truth.

f32 on the CPU.  Tolerance: the maps 1e-4 absolute and relative (the
convolutions' tolerance in tests/test_torch_lidar_modules.py); the decoded
corners 1e-4; the AP values equal.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cobevt_tpu.data.opv2v import OPV2VScenarioDatabase as JaxDatabase
from cobevt_tpu.data.opv2v_lidar import OPV2VLidarDataset as JaxLidarDataset
from cobevt_tpu.metrics import detection_ap as jap
from cobevt_tpu.models.lidar import point_pillar_models as jm
from cobevt_tpu_torch.data.opv2v import OPV2VScenarioDatabase
from cobevt_tpu_torch.data.opv2v_lidar import OPV2VLidarDataset
from cobevt_tpu_torch.metrics import detection_ap as pap
from cobevt_tpu_torch.models.lidar import point_pillar_models as pm
from cobevt_tpu_torch.postprocess import voxel_postprocessor as ppost
from cobevt_tpu_torch.train.loop import batch_to_device
from tests.test_lidar_dataset_e2e import (
    PC_RANGE,
    VOXEL,
    make_post,
    write_lidar_fixture,
)
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

TINY = dict(
    max_cav=2, voxel_size=VOXEL, point_cloud_range=PC_RANGE,
    max_voxels=256, max_points_per_voxel=8, pillar_filters=(16,),
    layer_nums=(1, 1), layer_strides=(2, 2), num_filters=(16, 32),
    upsample_strides=(1, 2), num_upsample_filter=(16, 16), shrink_dim=32,
    fusion="swap", fusion_window_size=2, fusion_dim_head=8,
    fusion_mlp_dim=32, fusion_depth=1, sttf_downsample_rate=2,
    anchor_num=2)
DATASET_KW = dict(voxel_size=VOXEL, lidar_range=PC_RANGE, max_voxels=256,
                  max_points_per_voxel=8, max_objects=10)
TOL = dict(atol=1e-4, rtol=1e-4)


def _ap(ap_module, post, outs, batch):
    stat = ap_module.new_result_stat((0.3, 0.5, 0.7))
    for b in range(len(outs["cls_preds"])):
        corners, scores = post.decode(np.asarray(outs["cls_preds"][b]),
                                      np.asarray(outs["reg_preds"][b]))
        gt = ppost.boxes_to_corners_3d(
            batch["object_bbx_center"][b][batch["object_bbx_mask"][b] == 1],
            post.order)
        for t in stat:
            ap_module.accumulate_tp_fp(corners[:, :4, :2], scores,
                                       gt[:, :4, :2], stat, t)
    return [ap_module.calculate_ap(stat, t)[0] for t in stat], stat


@pytest.mark.parametrize("train", [False, True])
def test_fixture_to_ap_equals_the_jax_packages(tmp_path, train):
    root = str(tmp_path / "lidar")
    write_lidar_fixture(root)
    jpost = make_post()
    ppost_ = ppost.VoxelPostprocessor(
        ppost.AnchorArgs(**dataclasses.asdict(jpost.args)), "hwl", 0.3, 0.2,
        0.2, 0.15, 50)
    ref = JaxLidarDataset(JaxDatabase(root, max_cav=2), jpost, train=train,
                          **DATASET_KW)
    port = OPV2VLidarDataset(OPV2VScenarioDatabase(root, max_cav=2), ppost_,
                             train=train, **DATASET_KW)
    jbatch_np = ref.collate([ref[0], ref[1]])
    batch_np = port.collate([port[0], port[1]])
    for k in jbatch_np:
        np.testing.assert_array_equal(batch_np[k], jbatch_np[k], err_msg=k)

    jmodel = jm.PointPillarFuseBEVT(jm.PointPillarConfig(**TINY))
    jbatch = {k: jnp.asarray(v) for k, v in jbatch_np.items()}
    variables = jax_variables(jmodel, jbatch, False, seed=3)
    model = port_from(pm.PointPillarFuseBEVT(pm.PointPillarConfig(**TINY)),
                      variables)
    batch = batch_to_device(batch_np, "cpu")
    with torch.no_grad():
        got = model(batch)
    want = jax_apply(jmodel, variables, jbatch, False)
    assert got["cls_preds"].shape == (2, 20, 20, 2)
    assert got["reg_preds"].shape == (2, 20, 20, 14)
    assert_close(got, want, **TOL)

    got_np = {k: v.numpy().astype(np.float64) for k, v in got.items()}
    want_np = {k: np.asarray(v, np.float64) for k, v in want.items()}
    for b in range(2):
        pc, ps = ppost_.decode(got_np["cls_preds"][b],
                               got_np["reg_preds"][b])
        jc, js = jpost.decode(want_np["cls_preds"][b],
                              want_np["reg_preds"][b])
        assert pc.shape == jc.shape and len(pc) > 0
        np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-4)
        np.testing.assert_allclose(ps, js, rtol=0, atol=1e-4)
    got_ap, pstat = _ap(pap, ppost_, got_np, batch_np)
    want_ap, jstat = _ap(jap, jpost, want_np, jbatch_np)
    assert got_ap == want_ap
    assert pstat == jstat
    assert all(s["gt"] == 2 for s in pstat.values())
