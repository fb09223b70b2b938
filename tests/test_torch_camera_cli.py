"""The port's OPV2V camera entry points end to end on the CPU.

``train_camera`` -> ``inference_camera`` -> ``serve_camera --model_dir`` on
the tiny fixture of ``tests/test_data_pipeline.py`` and ``TINY_HYPES`` of
``tests/test_train_e2e.py`` (64^2 images, BEV 32, max_cav 3, ResNet-18),
each with ``--device cpu``: two train steps, a validation pass and a save;
the inference tool reproduces the trainer's IoU from the checkpoint; the
server answers every validation frame from the checkpoint with the
inference tool's argmax maps.  The ``--device`` default refuses to run
where there is no card.
"""

import copy
import glob
import json
import os

import numpy as np
import pytest
import torch

from tests.test_data_pipeline import write_opv2v_fixture
from tests.test_train_e2e import TINY_HYPES


def write_run_hypes(tmp_path):
    """The fixture's train/validate dirs and a JSON hypes file (JSON is
    YAML) pointing at them; returns its path."""
    train = str(tmp_path / "train")
    val = str(tmp_path / "validate")
    write_opv2v_fixture(train, n_scenarios=1, n_cavs=3, n_stamps=4)
    write_opv2v_fixture(val, n_scenarios=1, n_cavs=3, n_stamps=2)
    hypes = copy.deepcopy(TINY_HYPES)
    hypes.update(root_dir=train, validate_dir=val)
    path = str(tmp_path / "tiny.json")
    with open(path, "w") as f:
        json.dump(hypes, f)
    return path, val


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from cobevt_tpu_torch.tools import train_camera

    tmp = tmp_path_factory.mktemp("cli")
    hypes_path, val = write_run_hypes(tmp)
    run = str(tmp / "run")
    trainer = train_camera.main([
        "--hypes_yaml", hypes_path, "--save_dir", run, "--device", "cpu",
        "--log_every", "1", "--num_workers", "0"])
    return trainer, run, val


def test_train_camera_saves_the_reference_layout(trained):
    trainer, run, _ = trained
    # 4 samples at batch 2: two steps, each logged
    assert trainer.global_step == 2 and len(trainer.records) == 2
    assert all(np.isfinite(r["scalars"]["loss"]) for r in trainer.records)
    assert os.path.exists(os.path.join(run, "config.yaml"))
    assert sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(run, "*epoch*.pth"))) == ["net_epoch1.pth"]
    assert os.path.exists(os.path.join(run, "train_state_epoch1.pt"))
    with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["step"] for x in lines if "loss" in x] == [1, 2]


def test_inference_and_serving_from_the_checkpoint(trained, tmp_path):
    from cobevt_tpu_torch.tools import inference_camera, serve_camera

    trainer, run, val = trained
    want = trainer.evaluate(_val_loader(run))
    inf_dir, srv_dir = str(tmp_path / "inf"), str(tmp_path / "srv")
    ious = inference_camera.main(["--model_dir", run, "--device", "cpu",
                                  "--num_workers", "0", "--out_dir",
                                  inf_dir])
    assert ious == want
    summary = serve_camera.main(["--model_dir", run, "--root_dir", val,
                                 "--device", "cpu", "--out_dir", srv_dir])
    assert summary["frames"] == 2 and summary["p50_ms"] > 0
    assert summary["buckets"].keys() == {"3"}
    for name in ("frame_000000.npz", "frame_000001.npz"):
        a = np.load(os.path.join(inf_dir, name))
        b = np.load(os.path.join(srv_dir, name))
        assert int(a["n_agents"]) == int(b["n_agents"]) == 3
        # the staged runner encodes the 3 live agents alone; in f32 the
        # maps agree but for pixels on the decision boundary
        assert (a["seg"] == b["seg"]).mean() >= 0.99


def test_served_frames_decode_when_served(trained, monkeypatch):
    from cobevt_tpu_torch.configs.hypes import load_hypes
    from cobevt_tpu_torch.data import opv2v
    from cobevt_tpu_torch.tools import serve_camera
    from cobevt_tpu_torch.utils.serving import live_agents

    _, run, val = trained
    reads = []
    imread = opv2v.imread
    monkeypatch.setattr(opv2v, "imread",
                        lambda path: reads.append(path) or imread(path))
    frames = serve_camera.dataset_frames(
        load_hypes(os.path.join(run, "config.yaml")), val)
    # the live-agent counts come from the YAML files: no image is decoded
    assert [n for n, _ in frames] == [3, 3] and reads == []
    for n, load in frames:
        assert live_agents(load()) == n
    assert len(reads) == 2 * (3 * 4 + 3)     # cameras, then 3 labels


def _val_loader(run):
    from cobevt_tpu_torch.configs.hypes import load_hypes
    from cobevt_tpu_torch.data import build_dataset
    from cobevt_tpu_torch.data.loader import DataLoader

    hypes = load_hypes(os.path.join(run, "config.yaml"))
    return DataLoader(build_dataset(hypes, train=False), 1, shuffle=False,
                      drop_last=False, num_workers=0)


@pytest.mark.parametrize("tool", ["train_camera", "inference_camera",
                                  "serve_camera"])
def test_the_device_default_needs_a_card(tool, monkeypatch, tmp_path):
    import importlib

    module = importlib.import_module(f"cobevt_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"train_camera": ["--hypes_yaml", str(tmp_path / "x.json")],
            "inference_camera": ["--model_dir", str(tmp_path)],
            "serve_camera": []}[tool]
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main(argv)


@pytest.mark.parametrize("core,bucketing,runner", [
    ("corpbevt", "staged", "StagedBucketedRunner"),
    ("corpbevt", "sliced", "BucketedRunner"),
    ("fax", "staged", "BucketedRunner"),
    ("cvt_v2vnet", "staged", "BucketedRunner"),
    ("cvt_v2vnet", "sliced", "BucketedRunner"),
    ("cvt_v2vnet", "off", "FullRunner"),
])
def test_serving_takes_the_jax_tools_runner(core, bucketing, runner):
    """``--bucketing staged`` splits CorpBEVT's graph and slices every graph
    without its ``stage=`` contract, as the JAX tool does
    (``cobevt_tpu/tools/serve_camera.py:66-88``)."""
    from cobevt_tpu_torch.configs.hypes import build_from_hypes
    from cobevt_tpu_torch.tools import serve_camera
    from cobevt_tpu_torch.tools.export_config import hypes_from_camera_bev
    from tests.test_torch_camera_zoo import port_cfg, tiny_cfg

    if core.startswith("cvt"):
        hypes = hypes_from_camera_bev(port_cfg(tiny_cfg("v2vnet")), "tiny")
    else:
        hypes = copy.deepcopy(TINY_HYPES)
        hypes["model"]["core_method"] = core
    cfg, model = build_from_hypes(hypes)
    got = serve_camera.build_runner(model, cfg, bucketing)
    assert type(got).__name__ == runner and got.model is model
    with pytest.raises(ValueError, match="unknown bucketing"):
        serve_camera.build_runner(model, cfg, "padded")
