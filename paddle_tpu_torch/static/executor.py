"""The static graph's Executor (counterpart of paddle_tpu/static/executor.py:
`Executor.run` :244, `Scope`, `global_scope`, `_CompiledProgram` :49).

The reference compiles a whole Program into one XLA executable per
(program, version, feeds, fetches) key. The port interprets the pruned op
list (`_Interpreter`, an `nn.Module` whose parameters are the program's
trainable captures and whose buffers are its other captures) and runs it
through the train and eval steps' machinery (jit/engine.py), so that each
key's program is interpreted once eagerly, then captured and replayed as
one CUDA graph (jit/cuda_graph.py `StepPrograms`):

  * a program with an optimize directive (`opt.minimize(loss)` in static
    mode) runs as a `TrainStep` over the interpreter: forward, the loss's
    backward, the optimizer's update of the parameters it holds (all the
    program's trainable parameters, or `opt._parameter_list`), with the
    Philox word, the scalar buffer, the non-finite guard and the running
    statistics (the program's `buffer_updates`, written after the guard)
    as `make_train_step` has them;
  * any other program runs forward only, under no_grad, and writes its
    buffer updates at every run (a training batch norm run without an
    optimizer moves its statistics, as in the reference).

Both count into `StepTelemetry("static")`: a key's first run is one
program build. On the CPU every run interprets the ops eagerly.
Left out: `train_from_dataset` / `infer_from_dataset` (they need
`paddle.dataset`, not ported).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..framework.device import resolve_device
from ..framework.random import RNG
from ..framework.state import running_program
from ..framework.tensor import Tensor
from ..jit.engine import EvalStep, TrainStep
from ..nn.functional import _running, _set_running
from .program import (Program, Variable, default_main_program,
                      extend_targets_with_aliases, prune_ops,
                      resolve_aliases_into_env)

__all__ = ["Executor", "global_scope", "Scope"]


class Scope:
    """Name -> value store (reference: framework/scope.h). The program's
    values live in its captured tensors; this keeps find_var working."""

    def __init__(self):
        self._vars = {}

    def find_var(self, name):
        return self._vars.get(name)

    def var(self, name):
        return self._vars.setdefault(name, None)


_global_scope = Scope()


def global_scope():
    return _global_scope


class _Interpreter(torch.nn.Module):
    """The pruned op list as a module: forward(*feeds) -> the values of
    `out_names`. `captures` are (name, tensor) pairs; those whose id is
    in `param_ids` are its parameters (the only ones gradients reach),
    the rest its buffers (read detached). `buffer_updates` are (buffer,
    var) pairs written after the ops (`_set_running`: in place, or handed
    to a train step's guard). With `cast`, float32 feeds are cast to that
    dtype first (the captures are the caller's, cast already) and outputs
    of that dtype come back as float32."""

    def __init__(self, ops, feed_names, out_names, captures, param_ids=(),
                 buffer_updates=(), aliases=None, cast=None):
        super().__init__()
        self.ops = list(ops)
        self.feed_names = list(feed_names)
        self.out_names = list(out_names)
        self.buffer_updates = list(buffer_updates)
        self.aliases = dict(aliases or {})
        self.cast = cast
        param_ids = set(param_ids)
        self._caps = []
        for i, (name, t) in enumerate(captures):
            trained = id(t) in param_ids
            if trained:
                self.register_parameter("c%d" % i, t)
            else:
                self.register_buffer("c%d" % i, t, persistent=False)
            self._caps.append((name, t, trained))
        # each var is dropped from the run's env after the last op that
        # reads it, so that a captured graph's pool can reuse its memory;
        # fetch targets, buffer-update sources and what their aliases
        # resolve to stay to the end
        keep = set()
        for name in self.out_names + [n for _, n in self.buffer_updates]:
            while name not in keep:
                keep.add(name)
                kind, ref = self.aliases.get(name, ("const", None))
                if kind == "const":
                    break
                name = ref
        last = {}
        for i, op in enumerate(self.ops):
            for name in [r for k, r in op.in_refs if k != "const"] + \
                    list(op.out_names):
                last[name] = i
        self._free = [[] for _ in self.ops]
        for name, i in last.items():
            if name not in keep:
                self._free[i].append(name)

    def forward(self, *feeds):
        if self.cast is not None:
            feeds = [f.to(self.cast) if f.dtype == torch.float32 else f
                     for f in feeds]
        env: Dict[str, object] = dict(zip(self.feed_names, feeds))
        for name, t, trained in self._caps:
            env[name] = t if trained else _running(t).detach()
        with running_program():
            for i, op in enumerate(self.ops):
                ins = []
                for kind, ref in op.in_refs:
                    if kind == "const":
                        ins.append(ref)
                    elif ref in env:
                        ins.append(env[ref])
                    else:
                        raise KeyError(
                            "op %s needs variable %r, which is neither "
                            "computed nor fed (fed: %s)"
                            % (op.op_type, ref, self.feed_names))
                outs = op.fn(*ins, **op.attrs)
                if not isinstance(outs, tuple):
                    outs = (outs,)
                env.update(zip(op.out_names, outs))
                for name in self._free[i]:
                    env.pop(name, None)
        for buf, name in self.buffer_updates:
            _set_running(buf, env[name])
        resolve_aliases_into_env(env, self.aliases)
        missing = [n for n in self.out_names if n not in env]
        if missing:
            raise KeyError("fetch target(s) %s not produced by this program"
                           % missing)
        outs = [env[n] for n in self.out_names]
        if self.cast is not None:
            outs = [o.float() if isinstance(o, torch.Tensor)
                    and o.dtype == self.cast else o for o in outs]
        return outs


class _StaticTrainStep(TrainStep):
    engine = "static"


class _StaticRunStep(EvalStep):
    """The forward-only program: no_grad, buffer updates written at every
    run (the interpreter's), outputs as the eval step returns them."""

    engine = "static"

    def _body(self, key, n_inputs):
        RNG.rewind_step()
        with torch.no_grad():
            outs = self.network(*self._static[key][:n_inputs])
        self._draws[key] = RNG.step_draws()
        return None, list(outs)


def _loss_first(*outs):
    return outs[0].reshape(())


class _CompiledProgram:
    """One executor key's program: the pruned ops behind a train or run
    step (see the module's note)."""

    def __init__(self, program: Program, feed_names, fetch_names,
                 train: bool, device):
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.train = train
        targets = set(fetch_names)
        if train:
            targets.add(program.optimize_directive[1].name)
        targets |= {name for _, name in program.buffer_updates}
        aliases = dict(program.aliases)
        extend_targets_with_aliases(targets, aliases)
        ops, needed = prune_ops(program.ops, targets)
        updates = [(b, n) for b, n in program.buffer_updates if n in needed]
        caps = [(program.capture_names[i], t)
                for i, t in program.captured.items()
                if train or program.capture_names[i] in needed]
        if train:
            opt, loss_var = program.optimize_directive
            allow = (None if opt._parameter_list is None
                     else {id(p) for p in opt._parameter_list})
            params = {id(t) for _, t in caps
                      if isinstance(t, torch.nn.Parameter) and t.requires_grad
                      and getattr(t, "trainable", True)
                      and (allow is None or id(t) in allow)}
            net = _Interpreter(ops, feed_names,
                               [loss_var.name] + self.fetch_names, caps,
                               params, updates, aliases)
            self.step = _StaticTrainStep(net, _loss_first, opt, device)
        else:
            net = _Interpreter(ops, feed_names, self.fetch_names, caps, (),
                               updates, aliases)
            self.step = _StaticRunStep(net, None, device)

    def run(self, feeds: List[torch.Tensor]):
        if self.train:
            _, outs = self.step.run(feeds, ())
            return outs[1:]
        _, outs = self.step.run(feeds)
        return outs


def _as_feed(value, var=None):
    """A fed value as a torch tensor (numpy, a Python sequence or a
    tensor), in the dtype `static.data` declared for it; float64 becomes
    float32 where none was declared (a loaded program's feed)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    if var is not None and var.is_data and var.declared:
        return t if t.dtype == var.dtype else t.to(var.dtype)
    return t.float() if t.dtype == torch.float64 else t


class Executor:
    """reference: paddle.static.Executor. `place` (a Place or a device
    name; default the current place, the card unless set_device("cpu"))
    is where programs run; their captured tensors must lie there."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._cache: Dict[tuple, _CompiledProgram] = {}

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        """Run `program` (default the main program) on `feed` (name ->
        array or tensor) and return the values of `fetch_list`
        (Variables or names): numpy arrays, or port Tensors with
        return_numpy=False. The startup program is a no-op: parameters
        are made when their layers are."""
        program = getattr(program, "program", program)
        program = program if program is not None else default_main_program()
        feed = feed or {}
        fetch_list = fetch_list or []
        if not isinstance(fetch_list, (list, tuple)):
            fetch_list = [fetch_list]
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list]
        if not program.ops:
            return [] if fetch_names else None
        feed_names = sorted(feed)
        feeds = [_as_feed(feed[n], program.vars.get(n)) for n in feed_names]
        train = program.optimize_directive is not None
        opt_id = id(program.optimize_directive[0]) if train else 0
        key = (id(program), program.version, tuple(feed_names),
               tuple((tuple(t.shape), str(t.dtype)) for t in feeds),
               tuple(fetch_names), train, opt_id)
        cp = self._cache.get(key)
        if cp is None:
            cp = self._cache[key] = _CompiledProgram(
                program, feed_names, fetch_names, train, self.device)
        results = cp.run(feeds)
        if return_numpy:
            return [Tensor.wrap(r).numpy() if isinstance(r, torch.Tensor)
                    else np.asarray(r) for r in results]
        return [Tensor.wrap(r) for r in results]

    def close(self):
        self._cache.clear()

