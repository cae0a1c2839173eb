"""Data pipeline (counterpart of paddle_tpu/io/__init__.py: datasets,
samplers, collation, worker processes and the DataLoader).

The loader batches in the consumer's process (num_workers=0) or in worker
processes (num_workers > 0, map-style datasets; io/multiprocess.py: numpy
batches through shared memory, a worker's error raised here with its
traceback) and places each batch on its device: with `prefetch_to_device`
> 0 through a `DevicePrefetcher` (io/prefetch.py) whose feeder thread
copies ahead from pinned memory, else by a plain copy in the consumer.
Workers never touch CUDA; on a CUDA device the parent copies each
shared-memory array into pinned host memory.

Randomness: a shuffle draws its permutation from the framework's CPU
generator (part of `get_rng_state`); `random_split`,
`WeightedRandomSampler` and the workers' seeds draw from numpy's global
generator, as the reference's do. The reference's background decode
thread (`use_buffer_reader`) is not ported: its flag is accepted and the
consumer collates. `DistributedBatchSampler` is not ported yet.
"""
from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np
import torch

from ..framework.device import resolve_device
from ..framework.random import RNG
from .multiprocess import DataLoaderWorkerError
from .prefetch import DevicePrefetcher, prefetch_to_device

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DataLoader", "DataLoaderWorkerError",
           "WorkerInfo", "get_worker_info", "default_collate_fn",
           "DevicePrefetcher", "prefetch_to_device"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        if any(t.shape[0] != tensors[0].shape[0] for t in tensors):
            raise ValueError("TensorDataset: tensors of different lengths")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of the given lengths over a permutation drawn from numpy's
    global generator, as the reference's."""
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.permutation(len(dataset))
    out, offset = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[offset:offset + ln].tolist()))
        offset += ln
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation drawn from the framework's CPU generator."""

    def __iter__(self):
        n = len(self.data_source)
        return iter(torch.randperm(n, generator=RNG.cpu).tolist())


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _collate(batch, worker=False):
    """The stacking recursion of the consumer's collate and the workers':
    numpy arrays and tensors are stacked, python ints become int64 and
    floats float32, tuples, lists and dicts are collated field by field.
    The consumer's leaves are tensors; a worker's are numpy arrays (the
    parent makes the tensors)."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return tuple(_collate([b[i] for b in batch], worker)
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: _collate([b[k] for b in batch], worker) for k in sample}
    if isinstance(sample, torch.Tensor):
        stacked = torch.stack(batch)
        return stacked.numpy() if worker else stacked
    if isinstance(sample, np.ndarray):
        leaf = np.stack(batch)
    elif isinstance(sample, (int, np.integer)):
        leaf = np.asarray(batch, np.int64)
    elif isinstance(sample, (float, np.floating)):
        leaf = np.asarray(batch, np.float32)
    else:
        return batch
    return leaf if worker else torch.from_numpy(leaf)


def default_collate_fn(batch):
    """Stack a list of samples into host tensors (reference: io
    default_collate_fn)."""
    return _collate(batch)


def _np_collate(batch):
    """The workers' collate: numpy leaves."""
    return _collate(batch, worker=True)


def _np_tree_to_tensor(obj):
    if isinstance(obj, (list, tuple)):
        return type(obj)(_np_tree_to_tensor(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _np_tree_to_tensor(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    return obj


def _to_device(obj, device, non_blocking=False):
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(o, device, non_blocking) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, device, non_blocking)
                for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=non_blocking)
    return obj


_worker_info = None


class WorkerInfo:
    def __init__(self, wid, num_workers, dataset, seed):
        self.id = wid
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


def _set_worker_info(wid, num_workers, dataset, seed):
    """Called inside worker processes (io/multiprocess.py)."""
    global _worker_info
    _worker_info = WorkerInfo(wid, num_workers, dataset, seed)


def get_worker_info():
    """The WorkerInfo of this worker process; None in the consumer."""
    return _worker_info


class DataLoader:
    """Batches of `dataset` on `device` (default "cuda", which raises
    without CUDA), in the reference's signature.

    num_workers > 0 loads a map-style dataset in that many worker
    processes (io/multiprocess.py; `timeout` seconds for a batch, 0 for
    none; `worker_init_fn(worker_id)` in each worker; `use_shared_memory`
    False pickles batches through the queue); the batches and their order
    are those of num_workers=0. prefetch_to_device=n keeps up to n batches
    copied ahead by a feeder thread. Iterating returns a generator; close
    it (or exhaust it) to stop the feeder and the workers. `_host_iter()`
    gives the same batches on the host, for a caller that places them
    itself (Model.fit's DevicePrefetcher)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, prefetch_to_device=0,
                 device_placement=None, device="cuda"):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.prefetch_factor = max(2, prefetch_factor)
        self.prefetch_to_device = max(0, int(prefetch_to_device or 0))
        self.num_workers = max(0, int(num_workers))
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        if persistent_workers:
            import warnings
            warnings.warn(
                "persistent_workers=True is accepted for API parity but "
                "not implemented: the worker pool is re-created per epoch",
                RuntimeWarning)
        self._iterable_ds = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable_ds:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_ds:
            raise TypeError("IterableDataset has no fixed length")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _host_iter(self) -> Iterator:
        """The batches on the host: from worker processes where asked (a
        map-style dataset), else collated here. The epoch's order (a
        shuffle's permutation, the workers' seed) is drawn here, on the
        caller's thread, not when the first batch is asked for, so that a
        feeder thread that iterates the batches draws no random numbers
        while the caller's thread does."""
        if self._iterable_ds:
            return self._iterable_batches()
        if self.batch_sampler is None:
            return (self.collate_fn([self.dataset[i]])
                    for i in range(len(self.dataset)))
        order = list(self.batch_sampler)
        if self.num_workers == 0:
            return (self.collate_fn([self.dataset[i] for i in indices])
                    for indices in order)
        return self._worker_batches(order, int(np.random.randint(0, 2 ** 31)))

    def _iterable_batches(self):
        it = iter(self.dataset)
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch:
                return
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield self.collate_fn(batch)

    def _worker_batches(self, order, seed):
        from .multiprocess import MultiprocessIter
        user_collate = self.collate_fn is not default_collate_fn
        it = MultiprocessIter(
            self.dataset, self.collate_fn if user_collate else _np_collate,
            iter(order), num_workers=self.num_workers,
            prefetch_factor=self.prefetch_factor,
            worker_init_fn=self.worker_init_fn, timeout=self.timeout,
            seed=seed, use_shared_memory=self.use_shared_memory,
            as_tensor=not user_collate,
            pin=self.device.type == "cuda")
        try:
            for batch in it:
                yield batch if user_collate else _np_tree_to_tensor(batch)
        finally:
            it.close()

    def __iter__(self):
        if self.prefetch_to_device > 0:
            feed = DevicePrefetcher(self._host_iter(),
                                    size=self.prefetch_to_device,
                                    device=self.device)
            try:
                yield from feed
            finally:
                feed.close()
        else:
            for batch in self._host_iter():
                yield _to_device(batch, self.device)
