"""On-disk sample cache: decode once, train many.

Counterpart of ``cobevt_tpu/data/cache.py``, in the same flat on-disk format,
so either package reads the other's cache: ``CachedDataset`` materializes
each decoded and resized sample on first access and serves raw arrays
afterwards (with the uint8 contract, ``normalize=False``, a full-width OPV2V
sample is ~16 MB of sequential read instead of 20 PNG decodes).

Format: a flat container (4-byte magic, 4-byte header length, JSON header
with {key: {dtype, shape, offset}}, then raw buffers).

Caveat: caching freezes any per-access randomness in the wrapped
dataset's __getitem__ (the OPV2V wild settings are drawn at cache-build
time), and the CAV order the cache was built with.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np

_MAGIC = b"CBTC"          # cobevt-tpu cache, version via header


def write_sample(path: str, sample: Dict[str, np.ndarray]) -> None:
    header = {}
    offset = 0
    arrays = []
    for k in sorted(sample):
        a = np.ascontiguousarray(sample[k])
        header[k] = {"dtype": a.dtype.str, "shape": list(a.shape),
                     "offset": offset}
        arrays.append(a)
        offset += a.nbytes
    blob = json.dumps(header).encode()
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(blob)))
        f.write(blob)
        for a in arrays:
            f.write(memoryview(a).cast("B"))
    os.replace(tmp, path)


def read_sample(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"not a cobevt cache file: {path}")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))
        body = f.read()
    out = {}
    for k, meta in header.items():
        dt = np.dtype(meta["dtype"])
        shape = tuple(meta["shape"])
        n = dt.itemsize * int(np.prod(shape)) if shape else dt.itemsize
        off = meta["offset"]
        out[k] = np.frombuffer(body, dt, count=n // dt.itemsize,
                               offset=off).reshape(shape)
    return out


class CachedDataset:
    """Wraps any `__len__`/`__getitem__`-of-dict-of-ndarray dataset."""

    def __init__(self, dataset, cache_dir: str):
        self.dataset = dataset
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self.collate = getattr(type(dataset), "collate", None) or \
            (lambda samples: {k: np.stack([s[k] for s in samples])
                              for k in samples[0]})

    def __len__(self):
        return len(self.dataset)

    def _path(self, idx: int) -> str:
        return os.path.join(self.cache_dir, f"sample_{idx:08d}.cbtc")

    @property
    def draws_random(self) -> bool:
        return getattr(self.dataset, "draws_random", False)

    def epoch_state(self):
        """The wrapped dataset's (a miss decodes through it)."""
        state = getattr(self.dataset, "epoch_state", None)
        return state() if state is not None else None

    def plan(self, idx: int):
        """The wrapped dataset's plan on a miss; a hit draws nothing."""
        if os.path.exists(self._path(idx)):
            return idx, None
        return idx, self.dataset.plan(idx)

    def __getitem__(self, key) -> Dict[str, np.ndarray]:
        """``key``: an index, or the index's ``plan``."""
        idx, inner = key if isinstance(key, tuple) else (int(key), None)
        path = self._path(idx)
        if os.path.exists(path):
            return read_sample(path)
        sample = self.dataset[inner if inner is not None else idx]
        write_sample(path, sample)
        return sample

    def warm(self, indices=None):
        """Materialize the cache (one pass); returns #built."""
        built = 0
        for i in (range(len(self)) if indices is None else indices):
            if not os.path.exists(self._path(int(i))):
                self[int(i)]
                built += 1
        return built
