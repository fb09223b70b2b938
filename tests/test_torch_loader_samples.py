"""Datasets for the loader's worker tests in ``test_torch_lidar_data.py``
(this module holds no test), in a module of their own: a spawned worker
imports the module of the dataset it unpickles, and this one imports only
numpy and the port's LiDAR dataset, not the JAX package."""

import os
import time

import numpy as np

from cobevt_tpu_torch.data.opv2v_lidar import OPV2VLidarDataset


class SlowFullWidthVoxels:
    """Eight batches of the full-width LiDAR sample's voxel features (5
    agents x 8000 pillars x 32 points, 20 MB), each taking 0.3 s to make."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        time.sleep(0.3)
        return {"voxel_features": np.full((5, 8000, 32, 4), i, np.float32)}

    collate = staticmethod(OPV2VLidarDataset.collate)


class FailingSamples:
    """Six small samples, each taking 0.1 s to make; sample ``fail_at``
    waits for the file ``release``, then raises or makes its worker exit."""

    def __init__(self, fail_at, how, release):
        self.fail_at, self.how, self.release = fail_at, how, release

    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == self.fail_at:
            while not os.path.exists(self.release):
                time.sleep(0.02)
            if self.how == "raise":
                raise ValueError(f"sample {i} failed")
            os._exit(3)
        time.sleep(0.1)
        return {"x": np.full((1, 4), i, np.float32)}

    @staticmethod
    def collate(samples):
        return {"x": np.concatenate([s["x"] for s in samples])}
