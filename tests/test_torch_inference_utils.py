"""The port's inference helpers, panels and label codec against the JAX
package's.

``tools/inference_utils.py:inference_late_fusion``: SinBEVT-OPV2V (the
``fax`` core method of ``TINY_HYPES``) run per CAV of a late-fusion test
sample, each agent's probabilities warped into the ego frame and
max-merged, from the same numpy weights on both sides, f32 on the CPU:
within 1e-4 abs / 1e-3 rel (``tests/test_torch_corpbevt.py``'s forward
budget; softmax probabilities lie in [0, 1]).  ``utils/visualization.py``'s
panels and ``data/labels.py``'s codec are integer code: bit-equal.
"""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.configs.hypes import corpbevt_config_from_hypes as jax_cfg
from cobevt_tpu.data import labels as jlabels
from cobevt_tpu.data.opv2v import OPV2VScenarioDatabase as JaxDB
from cobevt_tpu.data.opv2v_late import OPV2VLateFusionDataset as JaxLate
from cobevt_tpu.models.corpbevt import SinBEVT as JaxSinBEVT
from cobevt_tpu.tools import inference_utils as jinf
from cobevt_tpu.train import TrainState as JaxTrainState
from cobevt_tpu.train.step import make_eval_step as jax_eval_step
from cobevt_tpu.utils import visualization as jvis
from cobevt_tpu_torch.configs.hypes import build_from_hypes
from cobevt_tpu_torch.data import labels as plabels
from cobevt_tpu_torch.tools import inference_utils as pinf
from cobevt_tpu_torch.train import create_train_state, make_eval_step
from cobevt_tpu_torch.train.optim import constant_schedule, make_optimizer
from cobevt_tpu_torch.utils import visualization as pvis
from cobevt_tpu_torch.utils.weights import load_jax_variables
from tests.test_data_pipeline import BEV, IMG, write_opv2v_fixture
from tests.test_train_e2e import TINY_HYPES
from tests.torch_parity import jax_variables

TOL = dict(atol=1e-4, rtol=1e-3)


def test_late_fusion_matches_jax(tmp_path):
    root = str(tmp_path / "val")
    write_opv2v_fixture(root, n_scenarios=1, n_cavs=3, n_stamps=2)
    hypes = copy.deepcopy(TINY_HYPES)
    hypes["model"]["core_method"] = "fax"
    ds = JaxLate(JaxDB(root, max_cav=3), image_hw=(IMG, IMG),
                 bev_hw=(BEV, BEV), train=False)
    samples = ds.test_samples(1)
    assert len(samples) == 3

    jmodel = JaxSinBEVT(jax_cfg(hypes))
    first = {k: jnp.asarray(v[None]) for k, v in
             next(iter(samples.values())).items()}
    variables = jax_variables(jmodel, first, False, seed=4)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=None, tx=None)
    sttf = hypes["model"]["args"]["sttf"]
    want = jinf.inference_late_fusion(jax_eval_step(jmodel), jstate, samples,
                                      sttf["resolution"],
                                      sttf["downsample_rate"])

    _, model = build_from_hypes(hypes)
    load_jax_variables(model, variables)
    schedule = constant_schedule(0.0)
    state = create_train_state(model, make_optimizer(model.parameters(),
                                                     schedule), schedule)
    got = pinf.inference_late_fusion(make_eval_step(model), state, samples,
                                     sttf["resolution"],
                                     sttf["downsample_rate"])
    assert set(got) == set(want)
    for key in ("dynamic_seg", "static_seg"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **TOL)
    for key in ("gt_dynamic", "gt_static"):
        np.testing.assert_array_equal(got[key], want[key])


def test_intermediate_fusion_is_the_eval_step():
    out = {"dynamic_seg": torch.zeros(1)}
    assert pinf.inference_intermediate_fusion(
        lambda state, batch: (out, None), None, {}) is out


def test_seg_panel_is_bit_equal_and_saved(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(0)
    output = {"dynamic_seg": rng.randn(2, 1, 8, 8, 2).astype(np.float32),
              "static_seg": rng.randn(2, 1, 8, 8, 3).astype(np.float32)}
    batch = {"gt_dynamic": rng.randint(0, 2, (2, 1, 8, 8)),
             "gt_static": rng.randint(0, 3, (2, 1, 8, 8))}
    for index in (0, 1):
        got = pvis.seg_panel(output, batch, index)
        want = jvis.seg_panel(output, batch, index)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "vis" / "panel.png")
    pvis.save_image(path, got)
    np.testing.assert_array_equal(cv2.imread(path), got)


def test_label_codec_is_bit_equal():
    rng = np.random.RandomState(1)
    maps = (rng.rand(16, 16, 12) > 0.5).astype(np.uint8) * 255
    packed = plabels.encode_binary_maps(maps)
    np.testing.assert_array_equal(packed, jlabels.encode_binary_maps(maps))
    np.testing.assert_array_equal(plabels.decode_binary_maps(packed, 12),
                                  jlabels.decode_binary_maps(packed, 12))
    np.testing.assert_array_equal(plabels.decode_binary_maps(packed, 12),
                                  maps // 255)
