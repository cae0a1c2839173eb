"""The port's multiprocess DataLoader (io/multiprocess.py) against the JAX
package's, on the CPU, mirroring tests/test_dataloader_mp.py: 0 and 2
workers give the same batches in order (and the reference's), large
arrays cross through shared memory, a worker's exception is raised in the
parent with its traceback, a killed worker raises DataLoaderWorkerError
and leaves no segment behind, get_worker_info, the timeout, the custom
collate, the new datasets and samplers, and the start method (fork while
CUDA is not initialised, spawn after; PADDLE_TPU_MP_START overrides),
with a spawned run over a dataset defined at module level.

Tolerance: none; batches are compared bit for bit.
"""
import os
import time

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.io import DataLoader as JDataLoader
from paddle_tpu.io import Dataset as JDataset
from paddle_tpu_torch import io
from paddle_tpu_torch.io import (DataLoader, DataLoaderWorkerError, Dataset,
                                 multiprocess)
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")


class ArrDataset(Dataset):
    """Module level: spawned workers unpickle it by name."""

    def __init__(self, n=32):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rs = np.random.RandomState(i)
        return rs.randn(8, 8).astype(np.float32), np.int64(i)


class JArrDataset(JDataset):
    def __init__(self, n=32):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return ArrDataset.__getitem__(self, i)


def _host(batch):
    return [t.numpy().copy() for t in batch]


def _loader(ds, **kw):
    return DataLoader(ds, batch_size=4, shuffle=False, device="cpu", **kw)


@pytest.mark.parametrize("workers", [2, 3])
def test_workers_give_the_in_process_batches_in_order(workers):
    ds = ArrDataset()
    want = [_host(b) for b in _loader(ds)]
    got = [_host(b) for b in _loader(ds, num_workers=workers)]
    ref = [[np.asarray(t.numpy()) for t in b] for b in JDataLoader(
        JArrDataset(), batch_size=4, num_workers=workers, shuffle=False)]
    assert len(want) == len(got) == len(ref) == 8
    for w, g, r in zip(want, got, ref):
        for a, b, c in zip(w, g, r):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    assert got[0][0].dtype == np.float32 and got[0][1].dtype == np.int64


class Big(Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.full((64, 64), float(i), np.float32)


def test_large_arrays_cross_through_shared_memory(monkeypatch):
    made = []
    real = multiprocess._from_segment

    def spy(shape, dtype, buf, as_tensor, pin):
        made.append(tuple(shape))
        return real(shape, dtype, buf, as_tensor, pin)
    monkeypatch.setattr(multiprocess, "_from_segment", spy)
    batches = list(DataLoader(Big(), batch_size=2, num_workers=2,
                              device="cpu"))
    assert len(batches) == 2 and made == [(2, 64, 64)] * 2
    assert isinstance(batches[0], torch.Tensor)
    np.testing.assert_array_equal(batches[0].numpy()[1], 1.0)
    np.testing.assert_array_equal(batches[1].numpy()[0], 2.0)


def test_pickled_transport_without_shared_memory():
    got = [_host(b) for b in _loader(ArrDataset(8), num_workers=2,
                                     use_shared_memory=False)]
    want = [_host(b) for b in _loader(ArrDataset(8))]
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)


class Failing(Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("decode exploded")
        return np.zeros((4,), np.float32)


def test_worker_exception_propagates_with_its_traceback():
    with pytest.raises(RuntimeError, match="decode exploded") as e:
        list(_loader(Failing(), num_workers=2))
    assert "Traceback" in str(e.value) and "__getitem__" in str(e.value)


class Probe(Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = io.get_worker_info()
        assert info is not None and 0 <= info.id < 2
        return np.int64(info.num_workers)


def test_worker_info_in_workers_only():
    out = np.concatenate([b.numpy() for b in _loader(Probe(),
                                                     num_workers=2)])
    assert (out == 2).all()
    assert io.get_worker_info() is None


class Slow(Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        if io.get_worker_info() is not None:
            time.sleep(5)
        return np.zeros(2, np.float32)


class JSlow(JDataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        from paddle_tpu.io import get_worker_info
        if get_worker_info() is not None:
            time.sleep(5)
        return np.zeros(2, np.float32)


@pytest.mark.parametrize("lib", ["port", "reference"])
def test_timeout_raises(lib):
    loader = (_loader(Slow(), num_workers=1, timeout=0.5) if lib == "port"
              else JDataLoader(JSlow(), batch_size=4, num_workers=1,
                               timeout=0.5))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out after 0.5s"):
        list(loader)
    assert time.monotonic() - t0 < 4


def _shm_names():
    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}
    except OSError:               # no /dev/shm: skip the leak check
        return None


class Dying(Dataset):
    def __len__(self):
        return 16

    def __getitem__(self, i):
        if i == 9 and io.get_worker_info() is not None:
            os._exit(13)          # an abrupt death inside a worker
        return np.full((64, 64), float(i), np.float32)


def test_killed_worker_raises_and_leaves_no_segment():
    before = _shm_names()
    with pytest.raises(DataLoaderWorkerError,
                       match=r"pid \d+.* exit code 13"):
        list(_loader(Dying(), num_workers=2))
    if before is not None:
        assert _shm_names() - before == set()


def test_custom_collate_passthrough():
    def collate(samples):
        return np.stack([s[0] for s in samples]).sum()

    vals = list(_loader(ArrDataset(8), num_workers=2, collate_fn=collate))
    assert len(vals) == 2
    assert all(isinstance(v, (float, np.floating)) for v in vals)
    big = list(_loader(Big(), num_workers=2, collate_fn=lambda s: np.stack(
        s)))
    assert isinstance(big[0], np.ndarray)     # numpy stays numpy


def test_start_method(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_MP_START", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert multiprocess._pick_start_method() == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert multiprocess._pick_start_method() == "spawn"
    monkeypatch.setenv("PADDLE_TPU_MP_START", "forkserver")
    assert multiprocess._pick_start_method() == "forkserver"


def test_spawned_workers_give_the_same_batches(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_MP_START", "spawn")
    want = [_host(b) for b in _loader(ArrDataset(16))]
    got = [_host(b) for b in _loader(ArrDataset(16), num_workers=2)]
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)


def test_datasets_and_samplers():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    y = np.arange(6, dtype=np.int64)
    td = io.TensorDataset([x, y])
    assert len(td) == 6 and td[2][1] == 2
    cd = io.ComposeDataset([td, io.Subset(td, [5, 4, 3, 2, 1, 0])])
    assert len(cd) == 6 and len(cd[0]) == 4 and cd[0][3] == 5
    chain = io.ChainDataset([[1, 2], [3]])
    assert [v for v in chain] == [1, 2, 3]
    batches = [b for b in DataLoader(chain, batch_size=2, device="cpu")]
    assert [b.tolist() for b in batches] == [[1, 2], [3]]
    np.random.seed(3)
    parts = io.random_split(td, [4, 2])
    assert sorted(parts[0].indices + parts[1].indices) == list(range(6))
    np.random.seed(3)
    from paddle_tpu.io import random_split as jsplit
    assert [p.indices for p in jsplit(td, [4, 2])] == \
        [p.indices for p in parts]
    np.random.seed(4)
    w = list(io.WeightedRandomSampler([0.0, 1.0, 0.0, 1.0], 20))
    assert set(w) <= {1, 3} and len(w) == 20
