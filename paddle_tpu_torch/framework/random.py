"""Global RNG (counterpart of paddle_tpu/framework/random.py: GlobalRNG,
seed, get_rng_state / set_rng_state).

The reference threads one functional jax key. The port holds a CPU
`torch.Generator` (`cpu`: host draws, dropout masks of CPU tensors, the
kernel seed) and, for the card, Philox words. Every dropout on CUDA
tensors (flash attention, fused dropout-LN, the keep mask of
`nn.functional.dropout`) draws its bits in a kernel: Philox,
keyed by a 64-bit seed, with a call offset in the counter. As the
reference's kernels read their randomness from a device ref (`rng_ref`),
these read (seed, offset) from device memory: a per-device Philox word,
int64 [seed, base offset], and a per-call delta, offset = base + delta
(mod 2^32). `draw(device)` hands out (word, delta).

The host stays the source of truth, as the reference's `RNG.key` is: the
seed is drawn once per `seed()` from the CPU generator and the offset
counts draws. Outside a train step each draw gets the next offset, the
word keeping its base (rewritten only when the seed changed), so no draw
waits on the device. A train step (`begin_step` .. `end_step`, driven by
`jit.make_train_step`) writes the word once before it runs, with base =
the offset count, and its i-th draw gets delta i: a CUDA graph that
captured the step bakes the deltas, not the offsets, and each replay
draws new bits from the base written before it. After the step the count
advances by the step's draws. `get_rng_state` / `set_rng_state` read and
set host state only; a restored state writes its base into the word
before the next step, which then repeats the masks of the saved one. The
state is JSON-able, so that a checkpoint's meta carries it;
`set_rng_state` takes nothing else (not the JAX package's key: the two
packages' generators differ, so their states never cross).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device, write_values

__all__ = ["GlobalRNG", "RNG", "seed", "init_seed", "get_rng_state",
           "set_rng_state", "next_seed_offset", "philox_word"]

_U32 = 2 ** 32
# the tag of a `GlobalRNG.state()`
STATE_KIND = "paddle_tpu_torch.GlobalRNG"


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _word_values(seed: int, base: int):
    """The word's int64 values: the seed's 64 bits as a signed int64, the
    base offset."""
    seed = int(seed) % 2 ** 64
    return [seed - 2 ** 64 if seed >= 2 ** 63 else seed, int(base) % _U32]


def philox_word(seed: int, base: int, device="cuda") -> torch.Tensor:
    """A Philox word holding (seed, base): the int64 [2] tensor the dropout
    kernels read their key from (the kernels' checks build their own)."""
    w = torch.empty(2, dtype=torch.int64, device=resolve_device(device))
    write_values(w, _word_values(seed, base))
    return w


class GlobalRNG:
    def __init__(self, seed: int = 0):
        self._words: Dict[torch.device, torch.Tensor] = {}
        # (seed, base) each device's word holds, in stream order
        self._written: Dict[torch.device, tuple] = {}
        self._step: Optional[torch.device] = None
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        self.cpu = torch.Generator().manual_seed(self._seed)
        self._kernel_seed: Optional[int] = None
        self._offset = 0
        self._gens: Dict[torch.device, torch.Generator] = {}

    def generator(self, device) -> torch.Generator:
        """The torch.Generator of `device` the random ops (ops/random_ops.py)
        draw from: the CPU generator, or a CUDA one seeded from the seed
        when first asked for after `manual_seed`, so that `paddle.seed(s)`
        repeats every draw. Its state is not part of `state()`."""
        dev = _device(device)
        if dev.type == "cpu":
            return self.cpu
        gen = self._gens.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed((self._seed * 0x9E3779B97F4A7C15 + 1
                             + (dev.index or 0)) % 2 ** 63)
            self._gens[dev] = gen
        return gen

    # -- the kernels' Philox word --------------------------------------------
    def _kseed(self) -> int:
        if self._kernel_seed is None:
            self._kernel_seed = int(torch.randint(
                0, 2 ** 62, (1,), generator=self.cpu, dtype=torch.int64))
        return self._kernel_seed

    def word(self, device) -> torch.Tensor:
        """The Philox word of `device`, int64 [seed, base offset]: made once
        (a captured step holds its address), written by the host."""
        dev = _device(device)
        w = self._words.get(dev)
        if w is None:
            w = self._words[dev] = torch.zeros(2, dtype=torch.int64,
                                               device=dev)
        return w

    def _write(self, dev, base):
        key = (self._kseed(), base % _U32)
        if self._written.get(dev) != key:
            write_values(self.word(dev), _word_values(*key))
            self._written[dev] = key

    def draw(self, device):
        """(word, delta) of one kernel call's dropout: its bits are those of
        (seed, base + delta) with (seed, base) the word's at launch."""
        dev = _device(device)
        if self._step is not None:
            if dev != self._step:
                raise RuntimeError("a dropout draw on %s inside a train step "
                                   "on %s" % (dev, self._step))
            delta = self._drawn
            self._drawn += 1
            return self.word(dev), delta
        written = self._written.get(dev)
        if written is None or written[0] != self._kseed():
            self._write(dev, self._offset)
            written = self._written[dev]
        delta = (self._offset - written[1]) % _U32
        self._offset = (self._offset + 1) % _U32
        return self.word(dev), delta

    def begin_step(self, device):
        """Start a train step on `device`: its base is the offset count,
        written into the word now, before the step's first launch (a build
        captures on a stream that waits for this one)."""
        dev = _device(device)
        self._step, self._base, self._drawn = dev, self._offset, 0
        self._write(dev, self._base)

    def rewind_step(self):
        """A run of the step's body starts: its draws count from delta 0
        (a body runs twice at its build, eagerly and under capture)."""
        self._drawn = 0

    def step_draws(self) -> int:
        """Draws the step's body has made so far in this run."""
        return self._drawn

    def end_step(self, draws: int):
        """The step ran with `draws` draws: the offset count moves past
        them."""
        self._offset = (self._base + draws) % _U32
        self._step = None

    def next_seed_offset(self):
        """(64-bit kernel seed, call offset < 2**32) of one draw outside a
        train step, as host numbers: the key `draw` would give."""
        off = self._offset
        self._offset = (self._offset + 1) % _U32
        return self._kseed(), off

    def state(self) -> dict:
        """The host state as JSON-able data (it goes into a checkpoint's
        meta): the CPU generator's state bytes as hex, the kernel seed, the
        offset count and the seed."""
        return {"kind": STATE_KIND,
                "cpu": bytes(self.cpu.get_state().numpy()).hex(),
                "kernel_seed": self._kernel_seed, "offset": self._offset,
                "seed": self._seed}

    def set_state(self, state):
        """Restore a `state()`. Raises ValueError on anything else, the
        JAX package's key among them: its generator is another one, whose
        state this one cannot take."""
        if not isinstance(state, dict) or state.get("kind") != STATE_KIND:
            raise ValueError(
                "not an RNG state of paddle_tpu_torch (got %s): the JAX "
                "package's key and other generators' states do not carry "
                "over" % type(state).__name__)
        cpu = torch.frombuffer(bytearray.fromhex(state["cpu"]),
                               dtype=torch.uint8)
        self.cpu.set_state(cpu)
        self._seed = int(state["seed"])
        ks = state["kernel_seed"]
        self._kernel_seed = None if ks is None else int(ks)
        self._offset = int(state["offset"]) % _U32


RNG = GlobalRNG(0)


def seed(s: int):
    """paddle.seed parity: reseeds every generator (the port's, torch's
    global ones) and numpy's; the port's model initialisers draw from
    `init_seed()`'s seed, so that a model built after `seed(s)` has the
    same weights every time."""
    RNG.manual_seed(int(s))
    torch.manual_seed(int(s) % (2 ** 64))
    np.random.seed(int(s) % (2 ** 32))
    return RNG


def init_seed(s=None) -> int:
    """The seed of a model initialiser's generator: `s`, or else the
    last `seed()`'s (0 before any call). Every build after one `seed(s)`
    draws the same weights: the reference's builds continue one key
    instead."""
    return int(RNG._seed if s is None else s)


def get_rng_state():
    return RNG.state()


def set_rng_state(state):
    RNG.set_state(state)


def next_seed_offset():
    return RNG.next_seed_offset()
