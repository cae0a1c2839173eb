"""Global RNG (counterpart of paddle_tpu/framework/random.py: GlobalRNG,
seed, get_rng_state / set_rng_state).

The reference threads one functional jax key. The port holds explicit
`torch.Generator`s instead:

  * one CPU generator, for host draws and for the kernel seeds;
  * one generator per CUDA device, made at first use, for `F.dropout`
    masks drawn on that device.

The flash-attention kernels draw their dropout bits in the kernel
(Philox, keyed by a 64-bit seed, with a per-call offset in the counter).
`next_seed_offset()` hands out that pair from host state alone: the seed
is drawn once per `seed()` from the CPU generator and the offset counts
calls, so no attention call waits on the device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["GlobalRNG", "RNG", "seed", "get_rng_state", "set_rng_state",
           "next_seed_offset"]


class GlobalRNG:
    def __init__(self, seed: int = 0):
        self._cuda: Dict[int, torch.Generator] = {}
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        self.cpu = torch.Generator().manual_seed(self._seed)
        for i, g in self._cuda.items():
            g.manual_seed(self._seed + i)
        self._kernel_seed: Optional[int] = None
        self._offset = 0

    def generator(self, device) -> torch.Generator:
        """The generator that draws on `device` (a torch.device)."""
        if device.type != "cuda":
            return self.cpu
        i = device.index if device.index is not None else \
            torch.cuda.current_device()
        g = self._cuda.get(i)
        if g is None:
            g = torch.Generator(device="cuda:%d" % i).manual_seed(
                self._seed + i)
            self._cuda[i] = g
        return g

    def next_seed_offset(self):
        """(64-bit kernel seed, call offset < 2**32) for one kernel call."""
        if self._kernel_seed is None:
            self._kernel_seed = int(torch.randint(
                0, 2 ** 62, (1,), generator=self.cpu, dtype=torch.int64))
        off = self._offset
        self._offset = (self._offset + 1) % (2 ** 32)
        return self._kernel_seed, off

    def state(self):
        return {"cpu": self.cpu.get_state(),
                "cuda": {i: g.get_state() for i, g in self._cuda.items()},
                "kernel_seed": self._kernel_seed, "offset": self._offset,
                "seed": self._seed}

    def set_state(self, state):
        self._seed = state["seed"]
        self.cpu.set_state(state["cpu"])
        for i, s in state["cuda"].items():
            self.generator(torch.device("cuda", i)).set_state(s)
        self._kernel_seed = state["kernel_seed"]
        self._offset = state["offset"]


RNG = GlobalRNG(0)


def seed(s: int):
    """paddle.seed parity: reseeds every generator and numpy's."""
    RNG.manual_seed(int(s))
    np.random.seed(int(s) % (2 ** 32))
    return RNG


def get_rng_state():
    return RNG.state()


def set_rng_state(state):
    RNG.set_state(state)


def next_seed_offset():
    return RNG.next_seed_offset()
