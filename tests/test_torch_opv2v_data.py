"""The port's OPV2V data stack against the JAX package's, on one fixture.

The fixture of ``tests/test_data_pipeline.py`` (64^2 camera PNGs, 32^2 label
PNGs, YAML per timestamp).  Every key of every sample bit-equal (values and
dtype) between ``cobevt_tpu.data`` and ``cobevt_tpu_torch.data``: the
intermediate-fusion dataset in train and eval, with wild settings on, in the
uint8 contract, across ``reinitialize`` CAV shuffles; the late-fusion
dataset's train samples and ``test_samples``; the sample cache in both
directions; the loader's batches for two epochs and a shard; a camera or
label file that is absent reads as zeros in both; with two workers, the
batches of datasets that draw random numbers.  Also: the loader stops
its workers on an early break, pins only for CUDA, and a file that exists
but cannot be decoded raises in the port.
"""

import multiprocessing
import os
import time

import numpy as np
import pytest

from cobevt_tpu import data as jd
from cobevt_tpu.data import cache as jcache
from cobevt_tpu.data.loader import DataLoader as JaxDataLoader
from cobevt_tpu_torch import data as pd
from cobevt_tpu_torch.data import cache as pcache
from cobevt_tpu_torch.data.loader import DataLoader
from tests.test_data_pipeline import BEV, IMG, write_opv2v_fixture
from tests.test_train_e2e import TINY_HYPES

WILD = dict(async_flag=True, async_mode="sim", async_overhead=100,
            loc_err_flag=True, xyz_noise_std=0.5, ryp_noise_std=0.2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("opv2v") / "train")
    write_opv2v_fixture(path, n_scenarios=2, n_cavs=3, n_stamps=3)
    return path


def assert_samples_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _pair(root, max_cav=4, shuffle=False, late=False, wild=None, **kw):
    """(JAX dataset, port dataset) over the same directory."""
    out = []
    for m in (jd, pd):
        db = m.OPV2VScenarioDatabase(root, max_cav=max_cav,
                                     shuffle_cavs=shuffle)
        cls = m.OPV2VLateFusionDataset if late else m.OPV2VCameraDataset
        args = dict(kw, image_hw=(IMG, IMG), bev_hw=(BEV, BEV))
        if wild is not None:
            args["wild"] = m.WildConfig(**wild)
        out.append(cls(db, **args))
    return out


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("wild", [False, True])
def test_intermediate_samples_bit_equal(root, train, normalize, wild):
    ref, port = _pair(root, train=train, normalize=normalize,
                      wild=WILD if wild else None, seed=5)
    assert len(ref) == len(port) == 6
    for i in range(len(ref)):
        assert_samples_equal(port[i], ref[i])
    if not normalize:
        assert port[0]["inputs"].dtype == np.uint8


def test_reinitialize_shuffles_like_jax(root):
    ref, port = _pair(root, max_cav=2, shuffle=True)
    for _ in range(3):
        assert [list(s) for s in port.db.scenarios] == \
            [list(s) for s in ref.db.scenarios]
        for i in (0, 4):
            assert_samples_equal(port[i], ref[i])
        ref.db.reinitialize()
        port.db.reinitialize()


def test_late_fusion_samples_bit_equal(root):
    ref, port = _pair(root, late=True, train=True, seed=2)
    for i in range(len(ref)):
        assert_samples_equal(port[i], ref[i])
    ref, port = _pair(root, late=True, train=False)
    for i in (0, 5):
        got, want = port.test_samples(i), ref.test_samples(i)
        assert list(got) == list(want) and len(got) == 3
        for cav in want:
            assert_samples_equal(got[cav], want[cav])


def test_build_dataset_from_hypes(root):
    hypes = dict(TINY_HYPES, root_dir=root, validate_dir=root)
    for train in (True, False):
        assert_samples_equal(pd.build_dataset(hypes, train=train)[1],
                             jd.build_dataset(hypes, train=train)[1])


def test_cache_round_trip_in_both_directions(root, tmp_path):
    _, port = _pair(root, normalize=False)
    sample = port[2]
    pcache.write_sample(str(tmp_path / "p.cbtc"), sample)
    assert_samples_equal(jcache.read_sample(str(tmp_path / "p.cbtc")),
                         sample)
    jcache.write_sample(str(tmp_path / "j.cbtc"), sample)
    assert_samples_equal(pcache.read_sample(str(tmp_path / "j.cbtc")),
                         sample)
    cached = pcache.CachedDataset(port, str(tmp_path / "cache"))
    assert cached.warm() == len(port)
    for i in range(len(port)):
        assert_samples_equal(cached[i], port[i])


@pytest.mark.parametrize("workers", [0, 1])
def test_loader_batches_match_jax_for_two_epochs(root, workers):
    ref, port = _pair(root)
    for kw in (dict(batch_size=2, shuffle=True, seed=3),
               dict(batch_size=2, shuffle=True, seed=3, num_shards=2,
                    shard_index=1, drop_last=False)):
        jl = JaxDataLoader(ref, **kw)
        pl = DataLoader(port, num_workers=workers, **kw)
        assert len(pl) == len(jl)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            want, got = list(jl), list(pl)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert_samples_equal({k: v.numpy() for k, v in g.items()},
                                     w)


@pytest.mark.parametrize("kind", ["wild", "late", "cached_wild"])
def test_loader_draws_like_jax_with_workers(root, kind, tmp_path):
    """Samples that draw random numbers (the wild settings' delay and pose
    noise; the late fusion's train-time CAV; a cache built from the first
    epoch's draws): with two spawned workers, over two epochs, the batches
    equal the JAX loader's, whose one thread draws from one RandomState
    across the run."""
    late = kind == "late"
    wild = None if late else dict(WILD, async_mode="real")
    ref, port = _pair(root, late=late, train=True, seed=7, wild=wild)
    if kind == "cached_wild":
        ref = jcache.CachedDataset(ref, str(tmp_path / "jax"))
        port = pcache.CachedDataset(port, str(tmp_path / "port"))
    assert port.draws_random
    kw = dict(batch_size=2, shuffle=True, seed=3)
    jl = JaxDataLoader(ref, **kw)
    pl = DataLoader(port, num_workers=2, **kw)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        want, got = list(jl), list(pl)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert_samples_equal({k: v.numpy() for k, v in g.items()}, w)


def test_loader_early_break_stops_its_workers(root):
    _, port = _pair(root, max_cav=2)
    loader = DataLoader(port, batch_size=1, shuffle=False, drop_last=False,
                        num_workers=2, prefetch=1)
    for _ in range(2):
        for _batch in loader:
            break                      # abandon mid-epoch
    deadline = time.time() + 10
    while multiprocessing.active_children() and time.time() < deadline:
        time.sleep(0.1)
    assert multiprocessing.active_children() == []


def test_loader_pins_only_for_cuda(root):
    _, port = _pair(root)
    assert not DataLoader(port, 1, device="cpu").pin_memory
    assert not DataLoader(port, 1).pin_memory
    assert DataLoader(port, 1, device="cuda:0").pin_memory


def test_missing_files_read_as_zeros_and_bad_files_raise(root, tmp_path):
    import shutil

    part = str(tmp_path / "partial")
    shutil.copytree(root, part)
    cav = os.path.join(part, "scenario_0", "100")
    os.remove(os.path.join(cav, "000000_camera2.png"))
    os.remove(os.path.join(cav, "000000_bev_static.png"))
    ref, port = _pair(part, normalize=False)
    got = port[0]
    assert_samples_equal(got, ref[0])
    assert not got["inputs"][0, 2].any() and got["inputs"][0, 1].any()
    with open(os.path.join(cav, "000000_camera1.png"), "wb") as f:
        f.write(b"truncated")
    with pytest.raises(ValueError):
        port[0]
