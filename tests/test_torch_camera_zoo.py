"""The port's camera model zoo (``models/camera_bev_models.py``) against the
JAX package, on the CPU.

The six CVT graphs at a tiny width (ResNet-18 at ``id_pick`` (1, 3), 2
cameras of 64 x 64, dim 16, BEV 64, so an 8 x 8 CVT grid; max_cav 3 with 3
and 2 live agents; agent->ego transforms and pairwise transforms rotated
and shifted, so every warp and ROI mask matters), the same numpy weights
(``utils/weights.py:load_jax_variables``) and inputs on both sides:

* eval forward of all six fusions in f32 (the port's eval path: K3's and,
  for swap, K4's plain versions; JAX's stock modules): 1e-4 abs / 1e-3
  rel on the seg logits;
* (``tests/test_torch_camera_zoo_train.py``) a train-mode forward and
  gradient of three of them;
* ``export_preset`` of all 15 opcamera presets equal to the JAX export;
* ``BucketedRunner`` against the JAX ``BucketedRunner`` on one padded
  batch, ``pairwise_t_matrix`` sliced on both agent axes, and
  ``StagedBucketedRunner`` still equal to the full padded forward with
  ``pairwise_t_matrix`` in the batch;
* ``tools/train_camera.py`` on the tiny OPV2V fixture with ``cvt_v2vnet``
  hypes for 2 steps, held to the JAX ``Trainer`` (f64) on the same fixture,
  weights and batches (loss 1e-5 rel at step 1, 1e-4 at step 2, the
  budgets of ``tests/test_torch_trainer.py``), then
  ``tools/inference_camera.py`` on its checkpoint, which gives the
  trainer's IoU.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.configs.hypes import camera_bev_config_from_hypes as jax_cfg
from cobevt_tpu.data import build_dataset as jax_build_dataset
from cobevt_tpu.data.loader import DataLoader as JaxDataLoader
from cobevt_tpu.losses import VanillaSegLoss as JaxSegLoss
from cobevt_tpu.models import camera_bev_models as jzoo
from cobevt_tpu.models.cvt_dense import CVTModuleConfig as JaxCVM
from cobevt_tpu.tools.export_config import export_preset as jax_export
from cobevt_tpu.train import TrainState as JaxTrainState
from cobevt_tpu.train.loop import Trainer as JaxTrainer
from cobevt_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from cobevt_tpu.train.optim import cosine_warmup_schedule as jax_schedule
from cobevt_tpu.train.optim import make_optimizer as jax_make_optimizer
from cobevt_tpu.utils.serving import BucketedRunner as JaxBucketedRunner
from cobevt_tpu_torch.configs.presets import all_opcamera_presets
from cobevt_tpu_torch.models import camera_bev_models as pzoo
from cobevt_tpu_torch.models.cvt_dense import CVTModuleConfig
from cobevt_tpu_torch.tools.export_config import (
    export_preset,
    hypes_from_camera_bev,
)
from cobevt_tpu_torch.utils import serving
from cobevt_tpu_torch.utils import weights as port_weights
from cobevt_tpu_torch.utils.weights import load_jax_variables
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    jnp_tree,
    port_from,
    torch_tree,
)

TOL = dict(atol=1e-4, rtol=1e-3)
B, L, M, IMG = 2, 3, 2, 64
FUSIONS = ("none", "att", "swap", "max", "v2vnet", "disconet")
AGENT_MASK = np.array([[1, 1, 1], [1, 1, 0]], np.float32)


def tiny_cfg(fusion, bev=64, max_cav=L):
    """A JAX ``CameraBEVConfig`` at the tiny width."""
    cvm = JaxCVM(dim=16, middle=(1, 1), image_height=IMG, image_width=IMG,
                 heads=2, dim_head=8, bev_height=bev, bev_width=bev,
                 decoder_blocks=3)
    return jzoo.CameraBEVConfig(
        max_cav=max_cav, encoder_num_layers=18, encoder_id_pick=(1, 3),
        image_height=IMG, image_width=IMG, cvm=cvm, fusion=fusion,
        sttf_resolution=0.8, sttf_downsample_rate=4,
        att_depth=1, att_heads=2, att_dim_head=8, att_mlp_dim=16,
        att_dropout=0.0, swap_mlp_dim=16, swap_window_size=2,
        swap_dim_head=8, swap_depth=1, swap_dropout=0.0,
        graph_num_iteration=2, decoder_num_layer=3,
        decoder_num_ch=(8, 12, 16), seg_head_dim=8, output_class=2)


def port_cfg(jcfg):
    fields = dataclasses.asdict(jcfg)
    fields["cvm"] = CVTModuleConfig(**fields["cvm"])
    return pzoo.CameraBEVConfig(**fields)


def rotation(a, t):
    m = np.eye(4, dtype=np.float32)
    m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    m[:2, 3] = t
    return m


def tiny_batch(seed=0, mask=AGENT_MASK):
    """A padded batch: padded agents' images zero, live agents rotated by up
    to 0.3 rad and shifted by up to 2 BEV pixels of 3.2 m."""
    rng = np.random.RandomState(seed)
    b, l = mask.shape
    intr = np.zeros((b, l, M, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = 60.0
    intr[..., 0, 2] = intr[..., 1, 2] = IMG / 2
    intr[..., 2, 2] = 1.0
    extr = np.tile(np.eye(4, dtype=np.float32), (b, l, M, 1, 1))
    extr[..., :3, 3] = rng.randn(b, l, M, 3) * 0.5
    tmat = np.tile(np.eye(4, dtype=np.float32), (b, l, 1, 1))
    pair = np.tile(np.eye(4, dtype=np.float32), (b, l, l, 1, 1))
    for i in range(b):
        for j in range(1, l):
            tmat[i, j] = rotation(rng.uniform(-0.3, 0.3),
                                  rng.uniform(-6.4, 6.4, 2))
        for j in range(l):
            for k in range(l):
                if j != k:
                    pair[i, j, k] = rotation(rng.uniform(-0.3, 0.3),
                                             rng.uniform(-6.4, 6.4, 2))
    images = rng.rand(b, l, M, IMG, IMG, 3).astype(np.float32)
    return {"inputs": images * mask[:, :, None, None, None, None],
            "intrinsic": intr, "extrinsic": extr,
            "transformation_matrix": tmat, "pairwise_t_matrix": pair,
            "agent_mask": mask}


def pair_of_models(fusion, seed):
    jm = jzoo.CameraBEVModel(tiny_cfg(fusion))
    variables = jax_variables(jm, jnp_tree(tiny_batch()), False, seed=seed)
    port = port_from(pzoo.CameraBEVModel(port_cfg(jm.config)), variables)
    return jm, variables, port


@pytest.mark.parametrize("fusion", FUSIONS)
def test_eval_forward_matches_jax(fusion):
    jm, variables, port = pair_of_models(fusion, seed=FUSIONS.index(fusion))
    batch = tiny_batch(1)
    want = jax_apply(jm, variables, jnp_tree(batch), False)
    with torch.no_grad():
        got = port(torch_tree(batch))
    rows = L if fusion == "none" else 1
    assert tuple(got["dynamic_seg"].shape) == (B, rows, 64, 64, 2)
    assert_close(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(all_opcamera_presets()))
def test_export_preset_matches_jax(name):
    assert export_preset(name) == jax_export(name)


def test_bucketed_runner_matches_jax():
    jm, variables, port = pair_of_models("v2vnet", seed=20)
    mask = np.array([[1, 1, 0]], np.float32)
    batch = tiny_batch(4, mask=mask)
    sliced = serving.slice_agents(batch, 2)
    assert sliced["pairwise_t_matrix"].shape == (1, 2, 2, 4, 4)
    np.testing.assert_array_equal(sliced["pairwise_t_matrix"],
                                  batch["pairwise_t_matrix"][:, :2, :2])
    assert sliced["inputs"].shape[1] == sliced["agent_mask"].shape[1] == 2
    want = JaxBucketedRunner(jm, jax.tree.map(jnp.asarray, variables))(batch)
    got = serving.BucketedRunner(port)(batch)
    assert_close(got, want, **TOL)


def test_staged_runner_is_exact_with_pairwise_in_the_batch():
    from cobevt_tpu_torch.configs.hypes import build_from_hypes
    from tests.test_train_e2e import TINY_HYPES

    cfg, model = build_from_hypes(copy.deepcopy(TINY_HYPES))
    port_weights.seeded_init_(model, 0)
    batch = tiny_batch(5)
    batch = {k: v[1:] for k, v in batch.items()}          # 2 of 3 live
    got = serving.StagedBucketedRunner(model, cfg.max_cav)(batch)
    full = serving.FullRunner(model)(batch)
    for k in got:
        torch.testing.assert_close(got[k], full[k], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fusion", FUSIONS[1:])
def test_sliced_serving_warns_where_it_differs_from_the_padded_forward(
        fusion, capsys):
    """Only the swap fusion's mean over max_cav rows changes when a frame is
    sliced to its live agents, and ``build_runner`` warns for it alone."""
    from cobevt_tpu_torch.tools import serve_camera

    _, _, port = pair_of_models(fusion, seed=21)
    batch = tiny_batch(7, mask=np.array([[1, 1, 0]], np.float32))
    capsys.readouterr()
    runner = serve_camera.build_runner(port, None, "staged")
    warned = "approximate" in capsys.readouterr().err
    got = runner(batch)["dynamic_seg"]
    full = serving.FullRunner(port)(batch)["dynamic_seg"]
    differs = not torch.allclose(got, full, rtol=0, atol=1e-6)
    assert warned == differs == (fusion == "swap")


def test_a_train_step_after_a_runner_in_one_process():
    """The static grids a runner caches under inference mode stay usable
    by a training step's backward."""
    from cobevt_tpu_torch.configs.hypes import build_from_hypes
    from cobevt_tpu_torch.models import fax
    from tests.test_train_e2e import TINY_HYPES

    cfg, model = build_from_hypes(copy.deepcopy(TINY_HYPES))
    port_weights.seeded_init_(model, 0)
    batch = {k: v[1:] for k, v in tiny_batch(6).items()}   # batch 1
    fax.on_device.cache_clear()
    serving.StagedBucketedRunner(model, cfg.max_cav)(batch)
    model.train()
    out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    out["dynamic_seg"].sum().backward()
    assert all(p.grad is not None for p in model.fax.parameters()
               if p.requires_grad)


# ---------------------------------------------------------------------------
# train_camera -> inference_camera with cvt_v2vnet hypes
# ---------------------------------------------------------------------------

def v2vnet_hypes(tmp):
    from tests.test_data_pipeline import BEV, write_opv2v_fixture

    train, val = str(tmp / "train"), str(tmp / "validate")
    write_opv2v_fixture(train, n_scenarios=1, n_cavs=3, n_stamps=4)
    write_opv2v_fixture(val, n_scenarios=1, n_cavs=3, n_stamps=2)
    hypes = hypes_from_camera_bev(port_cfg(tiny_cfg("v2vnet", bev=BEV)),
                                  "tiny_cvt_v2vnet")
    hypes.update(root_dir=train, validate_dir=val)
    hypes["train_params"].update(batch_size=2, epoches=1, eval_freq=1,
                                 save_freq=1)
    hypes["lr_scheduler"].update(epoches=1, warmup_epoches=0)
    path = str(tmp / "tiny_cvt_v2vnet.json")
    with open(path, "w") as f:
        json.dump(hypes, f)
    return hypes, path


def _criterion(hypes):
    args = hypes["loss"]["args"]
    seg = JaxSegLoss(target=args["target"], d_weights=args["d_weights"],
                     s_weights=args["s_weights"], d_coe=args["d_coe"],
                     s_coe=args["s_coe"])

    def crit(out, b):
        return seg(out, {"gt_dynamic": b["gt_dynamic"],
                         "gt_static": b["gt_static"]})
    return crit


@pytest.fixture(scope="module")
def trained_v2vnet(tmp_path_factory):
    """One epoch (2 steps at B 2) of the JAX Trainer in f64 and of the
    port's train_camera from the same weights: (JAX step logs, port
    trainer, run dir)."""
    from cobevt_tpu_torch.tools import train_camera

    tmp = tmp_path_factory.mktemp("zoo_cli")
    hypes, path = v2vnet_hypes(tmp)
    jmodel = jzoo.CameraBEVModel(jax_cfg(hypes))
    jtrain = jax_build_dataset(hypes, train=True)
    sample = {k: jnp.asarray(np.stack([v])) for k, v in jtrain[0].items()}
    variables = jax_variables(jmodel, sample, False, seed=3)

    sched = hypes["lr_scheduler"]
    schedule_args = (hypes["optimizer"]["lr"], sched["warmup_lr"], 0, 2,
                     sched["lr_min"])
    with jax.enable_x64(True):
        tx = jax_make_optimizer(jax_schedule(*schedule_args),
                                weight_decay=1e-2, eps=1e-10)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              variables["params"])
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables["batch_stats"]),
            opt_state=tx.init(params), tx=tx)
        jt = JaxTrainer(jmodel, _criterion(hypes), state, JaxTrainerConfig(
            epochs=1, eval_freq=100, save_freq=100, log_every=1,
            log_dir=str(tmp / "jax")))
        jt.fit(JaxDataLoader(jtrain, 2, shuffle=True))
        jt.logger.close()
    with open(tmp / "jax" / "metrics.jsonl") as f:
        jlogs = [json.loads(x) for x in f if '"loss"' in x]

    run = str(tmp / "run")
    mp = pytest.MonkeyPatch()
    try:
        # the weights train_camera draws are the JAX variables
        mp.setattr(port_weights, "seeded_init_",
                   lambda model, seed: load_jax_variables(model, variables))
        trainer = train_camera.main([
            "--hypes_yaml", path, "--save_dir", run, "--device", "cpu",
            "--log_every", "1", "--num_workers", "0"])
    finally:
        mp.undo()
    return jlogs, trainer, run


def test_train_camera_v2vnet_matches_the_jax_trainer(trained_v2vnet):
    jlogs, trainer, _ = trained_v2vnet
    assert isinstance(trainer.model, pzoo.CameraBEVModel)
    assert [x["step"] for x in jlogs] == [1, 2]
    psteps = [r["scalars"] for r in trainer.records]
    assert len(psteps) == 2
    for j, p, rtol in zip(jlogs, psteps, (1e-5, 1e-4)):
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=rtol)
        np.testing.assert_allclose(p["dynamic_loss"], j["dynamic_loss"],
                                   rtol=rtol)


def test_inference_camera_reproduces_the_trainers_iou(trained_v2vnet):
    from cobevt_tpu_torch.tools import inference_camera

    _, trainer, run = trained_v2vnet
    with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
        val = [json.loads(x) for x in f if "val_iou_dynamic" in x][-1]
    ious = inference_camera.main(["--model_dir", run, "--device", "cpu",
                                  "--num_workers", "0"])
    assert ious["iou_dynamic"] == val["val_iou_dynamic"]
    assert 0.0 <= ious["iou_dynamic"] <= 1.0
