"""What a loader's worker imports, and the loader's batches under its
forkserver.

A worker unpickles its dataset, which imports the dataset's module.  Each of
these modules, imported in a fresh interpreter, must load nothing of the
model zoo, the kernels, the mesh or the trainer, and neither
``torch.distributed.tensor`` nor sympy: a worker pays for what its dataset
imports, once a process, in the forkserver.  ``configs/hypes.py``, whose
YAML reader the OPV2V datasets use, imports the models inside the
functions that build configs for that reason.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cobevt_tpu_torch.data import loader as loader_mod
from cobevt_tpu_torch.data.loader import DataLoader

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAVY_PACKAGES = ("cobevt_tpu_torch.models", "cobevt_tpu_torch.ops",
                  "cobevt_tpu_torch.parallel", "cobevt_tpu_torch.train")
HEAVY_MODULES = ("torch.distributed.tensor", "sympy")

PROBE = """
import importlib, json, sys
importlib.import_module(sys.argv[1])
packages, modules = json.loads(sys.argv[2]), json.loads(sys.argv[3])
print(json.dumps(sorted(
    m for m in sys.modules
    if m in modules or any(m == p or m.startswith(p + ".") for p in packages)
)))
"""


@pytest.mark.parametrize("module", [
    "cobevt_tpu_torch.data.loader",
    "cobevt_tpu_torch.data",
    "cobevt_tpu_torch.data.nuscenes_gen",
    "cobevt_tpu_torch.data.opv2v_lidar",
    "cobevt_tpu_torch.configs.hypes",
])
def test_a_worker_imports_no_model(module):
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    out = subprocess.run(
        [sys.executable, "-c", PROBE, module, json.dumps(HEAVY_PACKAGES),
         json.dumps(HEAVY_MODULES)],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


class Squares:
    """Ten small samples; a class of a test module, which a worker must
    unpickle by importing this module."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"x": np.full((2, 3), i * i, np.float32),
                "i": np.array([i], np.int64)}

    @staticmethod
    def collate(samples):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def test_two_workers_give_the_batches_of_none():
    """Two workers forked from the loader's forkserver give the batches of
    ``num_workers=0``, in order, over two epochs; the first iteration
    starts them (its first batch is on record) and the second keeps
    them."""
    kw = dict(batch_size=3, shuffle=True, drop_last=False, seed=5)
    plain = DataLoader(Squares(), num_workers=0, **kw)
    workers = DataLoader(Squares(), num_workers=2, **kw)
    try:
        for epoch in (0, 1):
            plain.set_epoch(epoch)
            workers.set_epoch(epoch)
            want, got = list(plain), list(workers)
            assert len(got) == len(want) == 4
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    assert g[k].dtype == w[k].dtype
                    assert np.array_equal(g[k].numpy(), w[k].numpy())
            record = loader_mod.FIRST_BATCHES[-1]
            assert record["dataset"] == "Squares"
            assert record["started"] == (epoch == 0)
            assert record["seconds"] >= 0
        ctx = workers._torch_loader.multiprocessing_context
        assert ctx.get_start_method() == "forkserver"
    finally:
        workers.close()
