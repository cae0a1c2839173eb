"""Data pipeline (counterpart of paddle_tpu/io/__init__.py: Dataset,
samplers, default_collate_fn, DataLoader).

The loader batches in the consumer's process (num_workers=0) and places
each batch on its device: with `prefetch_to_device` > 0 through a
`DevicePrefetcher` (io/prefetch.py) whose feeder thread copies ahead from
pinned memory, else by a plain copy in the consumer. Worker processes and
the reference's background decode thread are not ported yet.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..framework.device import resolve_device
from ..framework.random import RNG
from .prefetch import DevicePrefetcher, prefetch_to_device

__all__ = ["Dataset", "Sampler", "SequenceSampler", "RandomSampler",
           "BatchSampler", "DataLoader", "default_collate_fn",
           "DevicePrefetcher", "prefetch_to_device"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


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


def default_collate_fn(batch):
    """Stack a list of samples into host tensors: numpy arrays and tensors
    are stacked, python ints become int64 and floats float32; tuples,
    lists and dicts are collated field by field (reference: io
    _collate)."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.tensor(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.tensor(np.asarray(batch, np.float32))
    return batch


def _to_device(obj, device, non_blocking=False):
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(o, device, non_blocking) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, device, non_blocking)
                for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=non_blocking)
    return obj


class DataLoader:
    """Batches of `dataset` on `device` (default "cuda", which raises
    without CUDA). prefetch_to_device=n keeps up to n batches copied ahead
    by a feeder thread (reference: DataLoader(prefetch_to_device=n)).
    Iterating returns a generator; close it (or exhaust it) to stop the
    feeder."""

    def __init__(self, dataset, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 prefetch_to_device=0, device="cuda"):
        if num_workers:
            raise NotImplementedError(
                "DataLoader worker processes are not ported yet "
                "(num_workers=0)")
        self.dataset = dataset
        self.device = resolve_device(device)
        self.collate_fn = collate_fn or default_collate_fn
        self.prefetch_to_device = max(0, int(prefetch_to_device or 0))
        self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                          batch_size=batch_size,
                                          drop_last=drop_last)

    def __len__(self):
        return len(self.batch_sampler)

    def _host_iter(self) -> Iterator:
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

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
