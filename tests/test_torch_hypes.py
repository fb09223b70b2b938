"""The port's hypes loading and config mapping against the JAX package's.

``configs/hypes.py:load_hypes`` on YAML text (the scientific-notation float
resolver included) and on JSON text, with and without PyYAML; the port's
typed config field by field against ``cobevt_tpu.configs.hypes.
corpbevt_config_from_hypes`` for ``TINY_HYPES`` of ``tests/test_train_e2e.py``
and for the full-width export; the zoo's core methods refused; config ->
hypes -> config equal.  Exact equality throughout: no arithmetic.
"""

import copy
import dataclasses
import json

import pytest

from cobevt_tpu.configs import hypes as jh
from cobevt_tpu.tools import export_config as jx
from cobevt_tpu_torch.configs import hypes as ph
from cobevt_tpu_torch.configs.presets import corpbevt_default
from cobevt_tpu_torch.tools import export_config as px
from tests.test_train_e2e import TINY_HYPES

YAML_TEXT = """\
name: sci
optimizer:
  lr: 2e-4
  args: {eps: 1e-10, weight_decay: 1.0e-2}
lr_scheduler: {warmup_lr: 2e-5, lr_min: 5E-6, epoches: 3}
flags: [true, 1, .5]
"""


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_yaml_floats_and_json_text(tmp_path):
    path = tmp_path / "h.yaml"
    path.write_text(YAML_TEXT)
    got = ph.load_hypes(str(path))
    assert got == jh.load_hypes(str(path))
    assert got["optimizer"]["lr"] == 2e-4
    assert isinstance(got["optimizer"]["args"]["eps"], float)
    assert got["lr_scheduler"]["lr_min"] == 5e-6
    jpath = tmp_path / "h.json"
    jpath.write_text(json.dumps(got))
    assert ph.load_hypes(str(jpath)) == got


def test_without_pyyaml_json_is_read_and_written(tmp_path, monkeypatch):
    monkeypatch.setattr(ph, "yaml", None)
    hypes = copy.deepcopy(TINY_HYPES)
    ph.save_config_snapshot(hypes, str(tmp_path))
    snapshot = tmp_path / "config.yaml"
    # JSON text, which the JAX package's YAML loader reads back the same
    assert json.loads(snapshot.read_text()) == hypes
    assert jh.load_hypes(str(snapshot)) == hypes
    assert ph.load_hypes("ignored.yaml", model_dir=str(tmp_path)) == hypes
    other = tmp_path / "h.yaml"
    other.write_text(YAML_TEXT)
    with pytest.raises(ValueError, match="PyYAML"):
        ph.load_hypes(str(other))


def test_model_dir_snapshot_takes_priority(tmp_path):
    hypes = copy.deepcopy(TINY_HYPES)
    ph.save_config_snapshot(hypes, str(tmp_path))
    other = tmp_path / "other.yaml"
    other.write_text(YAML_TEXT)
    assert ph.load_hypes(str(other), model_dir=str(tmp_path)) == hypes
    assert ph.load_hypes(str(other), model_dir=str(tmp_path / "no")) \
        == ph.load_hypes(str(other))


def test_bev_params_parser_matches_jax():
    hypes = {"yaml_parser": "load_bev_params",
             "preprocess": {"args": {"res": 0.4, "downsample_rate": 2},
                            "cav_lidar_range": [-50, -50, -3, 50, 50, 1]},
             "model": {"args": {}}, "postprocess": {}}
    got = ph.load_bev_params(copy.deepcopy(hypes))
    assert got == jh.load_bev_params(copy.deepcopy(hypes))
    assert got["model"]["args"]["geometry_param"]["label_shape"] == \
        (125, 125, 7)


@pytest.mark.parametrize("which", ["tiny", "full_width", "fax"])
def test_config_equals_jax_field_by_field(which):
    if which == "tiny":
        hypes = copy.deepcopy(TINY_HYPES)
    else:
        hypes = px.export_preset("corpbevt")
        assert hypes == jx.export_preset("corpbevt")
    if which == "fax":
        hypes["model"]["core_method"] = "fax_fused_transformer"
        for k in ("fax_fusion", "sttf", "max_cav"):
            hypes["model"]["args"].pop(k)
    key, cfg = ph.model_config_from_hypes(hypes)
    jkey, jcfg = jh.model_config_from_hypes(hypes)
    assert key == jkey == ("fax" if which == "fax" else "corpbevt")
    port, ref = _fields(cfg), _fields(jcfg)
    assert set(port) == set(ref) and set(port["fax"]) == set(ref["fax"])
    for name, value in ref.items():
        assert port[name] == value, name


def test_full_width_export_is_the_preset():
    hypes = px.export_preset("corpbevt")
    assert ph.corpbevt_config_from_hypes(hypes) == corpbevt_default()


def test_config_hypes_config_round_trip(tmp_path):
    cfg = ph.corpbevt_config_from_hypes(copy.deepcopy(TINY_HYPES))
    hypes = px.hypes_from_corpbevt(cfg, "tiny")
    path = tmp_path / "tiny.yaml"
    ph.write_yaml(hypes, str(path))
    assert ph.corpbevt_config_from_hypes(ph.load_hypes(str(path))) == cfg


@pytest.mark.parametrize("core", ["cvt", "cross_view_transformer_att_fuse",
                                  "cvt_swap_fuse", "cvt_v2vnet"])
def test_zoo_core_methods_name_the_roadmap_item(core):
    hypes = copy.deepcopy(TINY_HYPES)
    hypes["model"]["core_method"] = core
    with pytest.raises(NotImplementedError, match="item 14"):
        ph.model_config_from_hypes(hypes)
    with pytest.raises(KeyError):
        hypes["model"]["core_method"] = "no_such_model"
        ph.model_config_from_hypes(hypes)


def test_build_from_hypes_gives_the_graph_of_the_core_method():
    from cobevt_tpu_torch.models.corpbevt import CorpBEVT, SinBEVT

    hypes = copy.deepcopy(TINY_HYPES)
    cfg, model = ph.build_from_hypes(hypes)
    assert isinstance(model, CorpBEVT) and model.config == cfg
    hypes["model"]["core_method"] = "fax"
    assert isinstance(ph.build_from_hypes(hypes)[1], SinBEVT)
