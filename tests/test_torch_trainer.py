"""The port's ``Trainer`` and checkpoints against the JAX package's.

On the fixture of ``tests/test_data_pipeline.py`` with ``TINY_HYPES`` of
``tests/test_train_e2e.py`` (64^2 images, BEV 32, 3 CAVs at max_cav 3,
ResNet-18, B 2, dropout 0), on the CPU:

(a) ``Trainer.fit`` against the JAX ``Trainer.fit`` for one epoch of two
    steps (``log_every=1``) and a validation pass, from the same numpy
    weights (``utils/weights.py:load_jax_variables``) and the same batches.
    The JAX side runs in f64 (``enable_x64``, its variables and moments in
    f64), the port in f32, as in ``tests/test_torch_train_step.py``, whose
    two-step budgets and schedule these are: loss 1e-5 relative at step 1,
    1e-4 at step 2 (step 2 starts from parameters that AdamW moved by +-lr
    where a gradient is rounding noise).  The validation IoU is equal; the JAX pass
    runs its trained state cast to f32 (its eval convs take f32).
(b) save -> restore into a fresh bf16-twin state is bit for bit: master
    parameters, BatchNorm buffers, AdamW moments and step, ``step``, the
    dropout generator, and the twin still shares the master's BatchNorm
    buffers.
(c) a port ``net_epoch{N}.pth`` restores into the JAX package through
    ``cobevt_tpu.train.checkpoint.restore_from_torch`` (strict manifest), and
    the JAX eval forward matches the port's in f32 (1e-4 abs / 1e-3 rel,
    ``tests/test_torch_corpbevt.py``'s budget).
(d) 2 epochs straight through ``tools/train_camera.py`` give the same
    losses and the same final checkpoint, bit for bit, as 1 epoch, a resume
    from its checkpoint (``--model_dir``), and 1 epoch.
"""

import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cobevt_tpu.configs.hypes import corpbevt_config_from_hypes as jax_cfg
from cobevt_tpu.data import build_dataset as jax_build_dataset
from cobevt_tpu.data.loader import DataLoader as JaxDataLoader
from cobevt_tpu.losses import VanillaSegLoss as JaxSegLoss
from cobevt_tpu.models.corpbevt import CorpBEVT as JaxCorpBEVT
from cobevt_tpu.train import TrainState as JaxTrainState
from cobevt_tpu.train.loop import Trainer as JaxTrainer
from cobevt_tpu.train.loop import TrainerConfig as JaxTrainerConfig
from cobevt_tpu.train.optim import cosine_warmup_schedule as jax_schedule
from cobevt_tpu.train.optim import make_optimizer as jax_make_optimizer
from cobevt_tpu_torch.configs.hypes import build_from_hypes
from cobevt_tpu_torch.data import build_dataset
from cobevt_tpu_torch.data.loader import DataLoader
from cobevt_tpu_torch.losses import VanillaSegLoss
from cobevt_tpu_torch.train import (
    cosine_warmup_schedule,
    create_train_state,
    make_optimizer,
)
from cobevt_tpu_torch.train.checkpoint import (
    checkpoint_paths,
    latest_checkpoint,
    restore_checkpoint,
)
from cobevt_tpu_torch.train.loop import Trainer, TrainerConfig
from cobevt_tpu_torch.utils.weights import load_jax_variables, seeded_init_
from tests.test_torch_camera_cli import write_run_hypes
# the schedule of tests/test_torch_train_step.py, whose two-step budgets
# (a) takes: its first update at the warmup lr, 2e-5.  The step-2 gap grows
# with the lr (the elements AdamW moves by +-lr on noise): at TINY_HYPES'
# 2e-4 from step 0 it reads 5.9e-4 relative
from tests.test_torch_train_step import SCHEDULE
from tests.test_train_e2e import TINY_HYPES
from tests.torch_parity import jax_variables



@pytest.fixture(scope="module")
def hypes(tmp_path_factory):
    import json
    path, _ = write_run_hypes(tmp_path_factory.mktemp("trainer"))
    with open(path) as f:
        return json.load(f)


def _criteria():
    args = TINY_HYPES["loss"]["args"]
    kw = dict(target=args["target"], d_weights=args["d_weights"],
              s_weights=args["s_weights"], d_coe=args["d_coe"],
              s_coe=args["s_coe"])
    jseg, pseg = JaxSegLoss(**kw), VanillaSegLoss(**kw)

    def jcrit(out, b):
        return jseg(out, {"gt_dynamic": b["gt_dynamic"],
                          "gt_static": b["gt_static"]})

    def pcrit(out, b):
        return pseg(out, {"gt_dynamic": b["gt_dynamic"],
                          "gt_static": b["gt_static"]})
    return jcrit, pcrit


def _read_jsonl(path):
    import json
    with open(path) as f:
        return [json.loads(x) for x in f]


@pytest.fixture(scope="module")
def fitted(hypes, tmp_path_factory):
    """One epoch of both trainers from the same weights: (JAX logged
    scalars, port trainer, JAX variables)."""
    tmp = tmp_path_factory.mktemp("fit")
    jcrit, pcrit = _criteria()
    jmodel = JaxCorpBEVT(jax_cfg(hypes))
    jtrain = jax_build_dataset(hypes, train=True)
    sample = {k: jnp.asarray(np.stack([v])) for k, v in jtrain[0].items()}
    variables = jax_variables(jmodel, sample, False, seed=3)

    with jax.enable_x64(True):
        tx = jax_make_optimizer(jax_schedule(*SCHEDULE), weight_decay=1e-2,
                                eps=1e-10)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              variables["params"])
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables["batch_stats"]),
            opt_state=tx.init(params), tx=tx)
        jt = JaxTrainer(jmodel, jcrit, state, JaxTrainerConfig(
            epochs=1, eval_freq=1, save_freq=1, log_every=1,
            log_dir=str(tmp / "jax")))
        jt.fit(JaxDataLoader(jtrain, 2, shuffle=True))
        jt.logger.close()
    jlogs = _read_jsonl(str(tmp / "jax" / "metrics.jsonl"))
    # the JAX eval step's fused convs take f32 (their accumulators are
    # f32), so the validation pass runs on the trained state cast to f32
    jt.state = jt.state.replace(
        params=jax.tree.map(lambda a: a.astype(jnp.float32),
                            jt.state.params),
        batch_stats=jax.tree.map(lambda a: a.astype(jnp.float32),
                                 jt.state.batch_stats))
    jval = jt.evaluate(JaxDataLoader(jax_build_dataset(hypes, train=False),
                                     1, shuffle=False, drop_last=False))

    cfg, model = build_from_hypes(hypes)
    load_jax_variables(model, variables)
    schedule = cosine_warmup_schedule(*SCHEDULE)
    pstate = create_train_state(
        model, make_optimizer(model.parameters(), schedule), schedule)
    pt = Trainer(model, pcrit, pstate, TrainerConfig(
        epochs=1, eval_freq=1, save_freq=1, log_every=1,
        ckpt_dir=str(tmp / "port"), log_dir=str(tmp / "port" / "logs")))
    pt.fit(DataLoader(build_dataset(hypes, train=True), 2, shuffle=True,
                      num_workers=0),
           DataLoader(build_dataset(hypes, train=False), 1, shuffle=False,
                      drop_last=False, num_workers=0))
    pt.logger.close()
    return jlogs, jval, pt, variables


def test_fit_matches_the_jax_trainer(fitted):
    jlogs, jval, pt, _ = fitted
    jsteps = [x for x in jlogs if "loss" in x]
    psteps = [r["scalars"] for r in pt.records]
    assert [x["step"] for x in jsteps] == [1, 2] and len(psteps) == 2
    for (j, p), rtol in zip(zip(jsteps, psteps), (1e-5, 1e-4)):
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=rtol)
        np.testing.assert_allclose(p["dynamic_loss"], j["dynamic_loss"],
                                   rtol=rtol)
    plog = _read_jsonl(os.path.join(pt.cfg.log_dir, "metrics.jsonl"))
    pval = [x for x in plog if "val_iou_dynamic" in x][-1]
    assert pval["val_iou_dynamic"] == jval["iou_dynamic"]
    assert 0.0 < pval["val_iou_dynamic"] < 1.0


def test_checkpoint_format_restores_into_the_jax_package(fitted, hypes):
    from cobevt_tpu.train.checkpoint import restore_from_torch
    from cobevt_tpu.utils.torch_port import state_dict_to_numpy
    from tests.torch_parity import jax_apply

    _, _, pt, variables = fitted
    epoch = latest_checkpoint(pt.cfg.ckpt_dir)
    assert epoch == 1
    net, _ = checkpoint_paths(pt.cfg.ckpt_dir, epoch)
    sd = torch.load(net, weights_only=True)
    assert all(v.device.type == "cpu" for v in sd.values())
    assert any(k.endswith("running_mean") for k in sd)

    jmodel = JaxCorpBEVT(jax_cfg(hypes))
    template = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=None, tx=None)
    restored = restore_from_torch(template, state_dict_to_numpy(sd))
    batch = {k: np.stack([v]) for k, v in
             build_dataset(hypes, train=False)[0].items()}
    want = jax_apply(jmodel, {"params": restored.params,
                              "batch_stats": restored.batch_stats},
                     jax.tree.map(jnp.asarray, batch), False)
    model = pt.state.model.eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, rtol=1e-3)


def _bf16_state(hypes, seed):
    _, model = build_from_hypes(hypes)
    seeded_init_(model, seed)
    schedule = cosine_warmup_schedule(*SCHEDULE)
    return create_train_state(model, make_optimizer(model.parameters(),
                                                    schedule),
                              schedule, compute_dtype=torch.bfloat16)


def test_save_restore_is_bit_for_bit(hypes, tmp_path):
    _, pcrit = _criteria()
    state = _bf16_state(hypes, 0)
    trainer = Trainer(state.model, pcrit, state, TrainerConfig(
        epochs=1, eval_freq=5, save_freq=1, log_every=1,
        ckpt_dir=str(tmp_path)))
    trainer.fit(DataLoader(build_dataset(hypes, train=True), 2,
                           num_workers=0))
    assert state.step == 2

    fresh = _bf16_state(hypes, 1)
    gen = torch.Generator().manual_seed(123)
    restored, epoch = restore_checkpoint(str(tmp_path), fresh, generator=gen)
    assert epoch == 1 and restored.step == state.step
    torch.testing.assert_close(gen.get_state(), trainer.generator.get_state(),
                               atol=0, rtol=0)
    want, got = state.model.state_dict(), restored.model.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for p_new, p_old in zip(restored.params, state.params):
        s_new = restored.optimizer.state[p_new]
        s_old = state.optimizer.state[p_old]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s_new[k], s_old[k]), k
    for twin, master in zip(restored.compute_params, restored.params):
        assert twin.dtype == torch.bfloat16
        assert torch.equal(twin, master.to(torch.bfloat16))
    for t, m in zip(restored.compute_model.modules(),
                    restored.model.modules()):
        if isinstance(m, torch.nn.BatchNorm2d):
            assert t.running_mean is m.running_mean
            assert t.running_var is m.running_var
            assert t.num_batches_tracked is m.num_batches_tracked


def test_two_epochs_equal_one_resume_one(tmp_path):
    import json

    from cobevt_tpu_torch.tools import train_camera

    hypes_path, _ = write_run_hypes(tmp_path)
    with open(hypes_path) as f:
        hypes = json.load(f)
    hypes["train_params"]["epoches"] = 2
    hypes["lr_scheduler"]["warmup_epoches"] = 1
    with open(hypes_path, "w") as f:
        json.dump(hypes, f)
    common = ["--hypes_yaml", hypes_path, "--device", "cpu",
              "--log_every", "1", "--num_workers", "0"]
    straight = str(tmp_path / "straight")
    full = train_camera.main(common + ["--save_dir", straight])
    assert full.global_step == 4

    # the same run stopped after its first epoch's checkpoint
    resumed = str(tmp_path / "resumed")
    shutil.copytree(straight, resumed)
    for path in checkpoint_paths(resumed, 2):
        os.remove(path)
    second = train_camera.main(common + ["--model_dir", resumed])
    assert second.start_epoch == 2 and second.global_step == 4
    assert [r["step"] for r in second.records] == [3, 4]
    for r_full, r_res in zip(full.records[2:], second.records):
        assert r_res["scalars"] == r_full["scalars"]
    a = torch.load(checkpoint_paths(straight, 2)[0], weights_only=True)
    b = torch.load(checkpoint_paths(resumed, 2)[0], weights_only=True)
    for k in a:
        assert torch.equal(a[k], b[k]), k
