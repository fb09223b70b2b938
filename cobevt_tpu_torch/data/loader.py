"""Batched data loading over ``torch.utils.data``.

Counterpart of ``cobevt_tpu/data/loader.py:DataLoader``: the same batches in
the same order.  Each process iterates its own contiguous shard of the index
space, shuffled by ``RandomState(seed + epoch)`` before the split, batched
with the dataset's ``collate`` (and ``drop_last``).  Here the batch sampler
feeds a ``torch.utils.data.DataLoader``: ``num_workers`` processes decode
samples in parallel, and the batches come out as CPU tensors, pinned when
the loader feeds a CUDA device, so the copy to the card can run
asynchronously.

Workers are spawned, not forked (the training process has CUDA's and the
profiler's threads): each starts from a fresh import, receives the dataset
pickled, runs its numpy code only and never touches CUDA.  A start costs an
interpreter and its imports, so the workers are kept across epochs: the
``torch.utils.data.DataLoader`` is built once and its workers persist.  A
dataset whose content its caller changes between epochs (an OPV2V CAV
order reshuffled at the end of an epoch) says so through ``epoch_state()``;
when that differs from the state the workers were given, they are stopped
and new ones receive the dataset as it stands.  An iteration abandoned
before its end (an early ``break``) stops the workers too, once the batches
they are making are read; :meth:`close` stops them at the end of a run.

A dataset whose samples draw random numbers (``draws_random``: the wild
settings, the late fusion's train-time CAV pick) makes its draws here, in
the loading process, in batch order: the batch sampler hands the workers
each index's ``plan`` (its YAML reads and draws) in place of the index.  So
one ``RandomState`` advances across batches and epochs as in the JAX
loader's one producer thread, whatever ``num_workers`` is.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.utils.data


class ShardedBatchSampler(torch.utils.data.Sampler):
    """Index batches of one shard, in the JAX loader's order."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_shards: int = 1,
                 shard_index: int = 0):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def indices(self) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        # contiguous shard per process
        per = self.n // self.num_shards
        lo = per * self.shard_index
        hi = per * (self.shard_index + 1) if \
            self.shard_index < self.num_shards - 1 else self.n
        return idx[lo:hi]

    def __len__(self):
        n = len(self.indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        idx = self.indices()
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            yield [int(j) for j in chunk]


class PlannedBatchSampler:
    """A batch sampler's batches as the dataset's sample plans, made here in
    batch order."""

    def __init__(self, sampler: ShardedBatchSampler, dataset):
        self.sampler = sampler
        self.dataset = dataset

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        for batch in self.sampler:
            yield [self.dataset.plan(i) for i in batch]


class TensorCollate:
    """The dataset's numpy ``collate``, its arrays as CPU tensors (a
    module-level class, so spawned workers can unpickle it)."""

    def __init__(self, collate: Callable):
        self.collate = collate

    def __call__(self, samples):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in self.collate(samples).items()}


class DataLoader:
    """Batches of CPU tensors from a dataset of dicts of numpy arrays.

    ``device``: where the batches go next; a CUDA device pins them.
    ``num_workers`` 0 decodes in the calling process."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 collate: Optional[Callable] = None,
                 num_shards: int = 1, shard_index: int = 0,
                 num_workers: int = 2, prefetch: int = 2,
                 device: Optional[torch.device] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = ShardedBatchSampler(
            len(dataset), batch_size, shuffle, drop_last, seed, num_shards,
            shard_index)
        self.collate = collate or dataset.collate
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.pin_memory = (device is not None and
                           torch.device(device).type == "cuda")
        self._torch_loader = None      # with its workers, when they persist
        self._state = None             # the dataset's epoch_state they hold

    @property
    def epoch(self) -> int:
        return self.sampler.epoch

    def set_epoch(self, epoch: int):
        self.sampler.epoch = epoch

    def __len__(self):
        return len(self.sampler)

    def _build(self):
        workers = self.num_workers
        batches = self.sampler
        if getattr(self.dataset, "draws_random", False):
            batches = PlannedBatchSampler(self.sampler, self.dataset)
        # the batch sampler is iterated here, in the loading process, at
        # each epoch: the sampler's epoch and the plans' draws are read then
        return torch.utils.data.DataLoader(
            self.dataset, batch_sampler=batches,
            collate_fn=TensorCollate(self.collate), num_workers=workers,
            pin_memory=self.pin_memory,
            prefetch_factor=self.prefetch if workers else None,
            persistent_workers=workers > 0,
            multiprocessing_context="spawn" if workers else None)

    def close(self):
        """Stop the workers, if any are running.  The batches they are still
        making for an abandoned iteration are read first: a worker told to
        stop while it writes a batch into a pipe that no one reads any more
        aborts as it exits.  The workers are stopped even when that read
        fails (a worker that died raises there), and the error is passed
        on."""
        loader, self._torch_loader = self._torch_loader, None
        it = getattr(loader, "_iterator", None)
        if it is None:
            return
        loader._iterator = None
        try:
            while getattr(it, "_tasks_outstanding", 0) > 0:
                it._get_data()
                it._tasks_outstanding -= 1
        finally:
            it._shutdown_workers()

    def __iter__(self) -> Iterator:
        epoch_state = getattr(self.dataset, "epoch_state", None)
        state = epoch_state() if epoch_state is not None else None
        if self._torch_loader is None or state != self._state:
            self.close()
            self._torch_loader, self._state = self._build(), state
        finished = False
        try:
            yield from self._torch_loader
            finished = True
        finally:
            if not finished:
                # an abandoned iteration (an early break) stops its workers
                self.close()
