"""``tools/train_nuscenes.py``, ``tools/view_data.py`` and
``tools/bench_input.py`` of the port on the CPU.

A synthetic scene set in the generated-label layout (2 scenes x 3 samples,
2 JPEG cameras at 160 x 90, BEV 40^2), written by the port's
``save_scene_labels``, and the small config of tests/test_nuscenes_model.py
(EfficientNet-b0, 64 x 128 images) with the vehicle experiment's losses and
recipe (``tests/test_torch_sinbevt_train.py:vehicle_experiment``),
registered as a preset for the run.  Both sides keep every drop-connect gate
(that file's ``_keep_every_gate``) and start from the same numpy weights.

(a) 4 steps of ``train_nuscenes.main`` at B 2 (3 batches an epoch, so the
    loader crosses an epoch) against the pieces the JAX CLI calls (its
    dataset and loader over the same directories, the one-cycle AdamW
    clipped at 5.0, ``make_train_step``, an rng split a step) within the
    budgets of tests/test_torch_sinbevt_train.py: each loss 1e-5 relative,
    the gradient norm 1e-4.  JPEG cameras go through PIL on both sides, so
    the batches are equal.  Both sides run in f64 here (the port's model and
    batches cast by the test), but for the pieces both keep in f32 (the
    intrinsics inverse and the ray einsums, the window attention, the
    port's gradient norm), which round alike but not bit for bit: in f32
    the port's first gradient norm reads 4.9e-4 of the f64 one on this data
    (the BatchNorm backward's f32 sums), while here step 1 reads about
    1e-7.  ``--lr 5e-5``: at the experiment's 5e-3 the first updates blow
    such a rounding up past the budgets by step 3 or 4, the JAX pieces
    against themselves too (tests/test_torch_train_nuscenes_lr.py), so
    no port could hold them there.  ``--steps 4``: at 3 the first phase of
    optax's one-cycle schedule is empty and the JAX side's lr is NaN.
(b) Checkpoints by step: ``--ckpt_every 2`` writes steps 2 and 4 (the last);
    started again with ``--steps 6`` the run restores step 4 bit for bit and
    takes epoch 0's first two batches again with the dropout generator from
    the seed, as the JAX CLI resumes; its step-5 loss is that of the restored
    state on epoch 0's first batch.
(c) The two IoU lines equal the JAX ``iou_update`` / ``iou_compute`` on the
    same logits, printed the same way.
(d) The device default refuses to run without a card.
(e) ``view_data`` writes panels the codec decodes; ``bench_input`` runs on a
    tiny fixture.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from cobevt_tpu_torch.configs import nuscenes_experiments as pexp
from cobevt_tpu_torch.tools import bench_input, train_nuscenes
from cobevt_tpu_torch.train.checkpoint import step_checkpoint_paths
from tests.test_torch_sinbevt_train import _keep_every_gate, vehicle_experiment

pytest.importorskip("PIL")

PRESET = "small_vehicle_test"
B = 2
LR = 5e-5


def small_vehicle():
    return dataclasses.replace(vehicle_experiment(), name=PRESET)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    return bench_input.write_nuscenes_fixture(
        root, 2, 3, n_cam=2, cam_hw=(90, 160), bev=40, camera_format="jpg")


@pytest.fixture(scope="module")
def variables():
    import jax.numpy as jnp

    from tests.test_torch_sinbevt_nuscenes import make_batch
    from tests.torch_parity import jax_variables

    return jax_variables(_jax_model(), {k: jnp.asarray(v) for k, v in
                                        make_batch(B=B).items()},
                         False, seed=5)


def _jax_model():
    from cobevt_tpu.models import sinbevt_nuscenes as jsn
    from tests.test_nuscenes_model import small_cfg
    from tests.test_torch_sinbevt_nuscenes import OUTPUTS

    return jsn.CrossViewTransformer(small_cfg(), decoder_blocks=(64, 64, 32),
                                    dim_last=32, outputs=OUTPUTS)


def _instrument(mp, variables, calls):
    """The small preset, the kept gates, the model and its batches in f64,
    the JAX weights in place of the seeded ones, and a record of every train
    step's logs and batch and of every eval step's logits."""
    from cobevt_tpu_torch.train import loop
    from cobevt_tpu_torch.utils.weights import load_jax_variables

    mp.setitem(pexp._EXPERIMENTS, PRESET, small_vehicle)
    _keep_every_gate(mp)
    build, to_device = pexp.build_model, loop.batch_to_device
    mp.setattr(pexp, "build_model", lambda exp: build(exp).double())
    mp.setattr(loop, "batch_to_device", lambda batch, device: {
        k: v.double() if v.dtype == torch.float32 else v
        for k, v in to_device(batch, device).items()})
    mp.setattr(train_nuscenes, "seeded_init_",
               lambda model, seed: load_jax_variables(model, variables))
    make_train, make_eval = (train_nuscenes.make_train_step,
                             train_nuscenes.make_eval_step)

    def train_step(*a, **kw):
        step = make_train(*a, **kw)

        def run(state, batch, generator=None):
            before = {k: v.clone() for k, v in
                      state.model.state_dict().items()}
            logs = step(state, batch, generator)
            calls["train"].append({
                "logs": {k: float(v) for k, v in logs.items()},
                "batch": {k: v.clone() for k, v in batch.items()},
                "before": before,
                "generator": generator.initial_seed()})
            return logs
        return run

    def eval_step(*a, **kw):
        step = make_eval(*a, **kw)

        def run(state, batch):
            out, parts = step(state, batch)
            calls["eval"].append({k: v.clone() for k, v in out.items()}
                                 | {"label": batch["bev"].clone(),
                                    "visibility":
                                        batch["visibility"].clone()})
            return out, parts
        return run

    mp.setattr(train_nuscenes, "make_train_step", train_step)
    mp.setattr(train_nuscenes, "make_eval_step", eval_step)


def _argv(scenes, save_dir, steps):
    data, labels = scenes
    return ["--dataset_dir", data, "--labels_dir", labels, "--save_dir",
            save_dir, "--experiment", PRESET, "--steps", str(steps),
            "--batch", str(B), "--ckpt_every", "2", "--lr", str(LR)]


@pytest.fixture(scope="module")
def runs(scenes, variables, tmp_path_factory):
    """The first run (4 steps) and the resumed one (to 6), with what they
    printed and what their steps saw."""
    import contextlib
    import io

    save = str(tmp_path_factory.mktemp("run"))
    out = []
    for steps in (4, 6):
        calls = {"train": [], "eval": []}
        printed = io.StringIO()
        with pytest.MonkeyPatch.context() as mp:
            _instrument(mp, variables, calls)
            with contextlib.redirect_stdout(printed):
                run = train_nuscenes.main(_argv(scenes, save, steps),
                                          device="cpu", num_workers=0)
        out.append((run, calls, printed.getvalue()))
    return save, out


def _jax_steps(scenes, variables, n, lr=LR):
    """The JAX CLI's pieces over the same directories: its dataset and
    loader, the one-cycle AdamW clipped at 5.0, ``make_train_step``, the
    rng split every step; in f64, at ``lr``.  Returns each step's logs."""
    import jax
    import jax.numpy as jnp

    from cobevt_tpu.configs import nuscenes_experiments as jexp
    from cobevt_tpu.data.loader import DataLoader
    from cobevt_tpu.data.nuscenes_gen import ImageConfig, concat_scene_datasets
    from cobevt_tpu.train import TrainState, make_train_step
    from cobevt_tpu.train.optim import make_optimizer, onecycle_schedule

    exp = dataclasses.replace(small_vehicle(), lr=lr)
    data, labels = scenes
    dataset = concat_scene_datasets(
        sorted(f[:-5] for f in os.listdir(labels) if f.endswith(".json")),
        data, labels, ImageConfig(h=64, w=128))
    loader = DataLoader(dataset, B, shuffle=True)
    model = _jax_model()
    criterion = jexp.build_criterion(jexp.nuscenes_experiment(
        "cvt_pyramid_axial_nuscenes_vehicle"))
    logs = []
    with jax.enable_x64(True):
        tx = make_optimizer(onecycle_schedule(exp.lr, n),
                            weight_decay=exp.weight_decay, eps=1e-8,
                            grad_clip=exp.grad_clip)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              variables["params"])
        state = TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables["batch_stats"]),
            opt_state=tx.init(params), tx=tx)
        step = make_train_step(model, criterion, mesh=None, donate=False)
        rng = jax.random.PRNGKey(exp.seed)
        epoch = 0
        while len(logs) < n:
            loader.set_epoch(epoch)
            for batch in loader:
                batch = {k: jnp.asarray(v, jnp.float64
                                        if v.dtype == np.float32 else None)
                         for k, v in batch.items()}
                rng, srng = jax.random.split(rng)
                state, out = step(state, batch, srng)
                logs.append({k: float(v) for k, v in out.items()})
                if len(logs) >= n:
                    break
            epoch += 1
    return logs


def test_four_steps_match_the_jax_cli_pieces(runs, scenes, variables):
    _, [(run, calls, _), _] = runs
    want = _jax_steps(scenes, variables, 4)
    got = [c["logs"] for c in calls["train"]]
    assert len(got) == 4 and run.state.step == 4
    assert [r["step"] for r in run.records] == [1, 2, 3, 4]
    assert run.resumed_from is None
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"visible", "center", "loss",
                                    "grad_norm"}
        for k in w:
            np.testing.assert_allclose(
                g[k], w[k], atol=1e-7, err_msg=k,
                rtol=1e-4 if k == "grad_norm" else 1e-5)


def test_checkpoints_by_step_and_the_jax_resume(runs):
    from cobevt_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
        onecycle_schedule,
    )
    from cobevt_tpu_torch.train.checkpoint import restore_step_checkpoint

    save, [(first, c1, _), (second, c2, _)] = runs
    ckpt = os.path.join(save, "ckpt")
    names = sorted(os.listdir(ckpt))
    assert names == sorted(os.path.basename(p) for n in (2, 4, 6)
                           for p in step_checkpoint_paths(ckpt, n))
    assert not any("epoch" in n for n in names)
    assert second.resumed_from == 4 and second.state.step == 6
    assert [r["step"] for r in second.records] == [5, 6]
    # the resumed run starts from step 4 as saved, and takes epoch 0's
    # first two batches again with the generator from the seed
    for k, v in first.state.model.state_dict().items():
        assert torch.equal(c2["train"][0]["before"][k], v), k
    for i in range(2):
        for k, v in c1["train"][i]["batch"].items():
            assert torch.equal(c2["train"][i]["batch"][k], v), k
    assert {c["generator"] for c in c1["train"] + c2["train"]} == {
        small_vehicle().seed}
    # its first step is the restored state's step on that batch
    exp = dataclasses.replace(small_vehicle(), steps=6, lr=LR)
    model = pexp.build_model(exp).double()
    schedule = onecycle_schedule(exp.lr, exp.steps)
    state = create_train_state(
        model, make_optimizer(model.parameters(), schedule,
                              weight_decay=exp.weight_decay, eps=1e-8),
        schedule, grad_clip=exp.grad_clip)
    state, step = restore_step_checkpoint(ckpt, state, 4)
    assert step == 4 and state.step == 4
    with pytest.MonkeyPatch.context() as mp:
        _keep_every_gate(mp)
        logs = make_train_step(model, pexp.build_criterion(exp))(
            state, c1["train"][0]["batch"],
            torch.Generator().manual_seed(exp.seed))
    assert float(logs["loss"]) == c2["train"][0]["logs"]["loss"]


def test_iou_lines_equal_jax_on_the_same_logits(runs):
    import jax.numpy as jnp

    from cobevt_tpu.metrics import IoUState, iou_compute, iou_update

    _, [(run, calls, printed), _] = runs
    label_indices = small_vehicle().label_indices
    vis, every = IoUState.create(2, 1), IoUState.create(2, 1)
    assert len(calls["eval"]) == 6
    for c in calls["eval"]:
        logits = jnp.asarray(c["bev"].float().numpy())
        label = jnp.asarray(c["label"].numpy())
        vis = iou_update(vis, logits, label, (0.4, 0.5),
                         jnp.asarray(c["visibility"].numpy()), 2,
                         label_indices)
        every = iou_update(every, logits, label, (0.4, 0.5), None, None,
                           label_indices)
    lines = [f"IoU (vis>=2): {np.asarray(iou_compute(vis))}",
             f"IoU (with occlusions): {np.asarray(iou_compute(every))}"]
    assert printed.splitlines()[-2:] == lines
    np.testing.assert_array_equal(run.iou_visible, np.asarray(
        iou_compute(vis)))
    assert run.iou_visible.shape == (1, 2)
    assert np.all((run.iou_all > 0) & (run.iou_all < 1))


def test_the_device_default_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_nuscenes.main(["--dataset_dir", str(tmp_path),
                             "--labels_dir", str(tmp_path)])


def test_view_data_writes_panels_the_codec_decodes(scenes, tmp_path):
    from cobevt_tpu_torch.data.image_io import read_png
    from cobevt_tpu_torch.tools import view_data

    data, labels = scenes
    paths = view_data.main(["--dataset_dir", data, "--labels_dir", labels,
                            "--out", str(tmp_path), "--max_samples", "2"])
    assert len(paths) == 2
    for p in paths:
        panel = read_png(p)
        # two cameras at the default 224 x 480 scaled to a 160-row strip,
        # over the 40^2 BEV scaled to its width
        assert panel.dtype == np.uint8 and panel.shape[1] == 2 * 342
        assert panel.shape[0] == 160 + 684 and panel.std() > 0


def test_bench_input_on_a_tiny_fixture(tmp_path, monkeypatch):
    rows = bench_input.main(["--root", str(tmp_path), "--opv2v_frames", "1",
                             "--nusc_frames", "2", "--num_workers", "0",
                             "--filters", "0", "--sinbevt_device_rate",
                             "1.0"])
    assert [(r["track"], r["pipeline"]) for r in rows] == [
        (t, p) for t in ("corpbevt_opv2v", "sinbevt_nuscenes")
        for p in ("f32", "u8", "u8+cache")]
    for r in rows:
        assert r["samples_per_sec"] > 0 and r["samples_timed"] >= 1
        if r["track"] == "corpbevt_opv2v":
            assert r["device_rate"] is None and r["feeds_chip"] is None
        else:
            assert r["device_rate"] == 1.0
            assert r["camera_format"] == "jpg"
