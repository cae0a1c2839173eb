"""paddle.Model, the high-level training API (the port's copy of
paddle_tpu/hapi/model.py: prepare, train_batch / eval_batch /
predict_batch, fit / evaluate / predict with callbacks, save / load,
parameters and summary).

`prepare(..., jit=True)` (the default) trains through the port's
`jit.make_train_step`: on CUDA one captured CUDA graph an input signature,
replayed every step. `jit=False` runs the eager loop (forward, backward,
`optimizer.step()`), with the reference's finiteness test under
FLAGS_skip_nonfinite_steps.

What a step reads back. As the reference's, each train, eval or predict
batch reads its loss to the host once (`_pack`, the step's one wait for
the device, recorded by `tracing.record_sync`). The captured step keeps
its non-finite guard's answer on the device; fit reads it
(`last_step_skipped`) only where it can be True, with the guard on, and
after the loss read has already waited, so it adds no second wait.

`predict_batch` returns numpy arrays, as the reference's does; numpy has
no bfloat16 (the port does not use ml_dtypes), so a bfloat16 output comes
back as float32, widened exactly.

`Model(network, device=...)`: the device the batches are placed on
(default "cuda", which raises without CUDA; the network's parameters must
lie there).
"""
from __future__ import annotations

import logging
import os
import shutil
import sys
import time

import numpy as np
import torch

from ..framework import io as fio
from ..framework.device import resolve_device
from ..framework.flags import flag
from ..io import DataLoader, DevicePrefetcher
from ..metric import Metric
from ..models.convert import set_state_dict
from ..observability import journal as run_journal
from ..observability import memprof, spans, tracing
from ..resilience import AnomalyGuard, PreemptionGuard, chaos, health
from .callbacks import (CallbackList, ModelCheckpoint, ProgBarLogger,
                        TelemetryCallback)

__all__ = ["Model", "InputSpec"]

logger = logging.getLogger("paddle_tpu_torch.hapi")


class _InputSpec:
    def __init__(self, shape=None, dtype="float32", name=None):
        self.shape = shape
        self.dtype = dtype
        self.name = name


InputSpec = _InputSpec


def _host_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Model:
    def __init__(self, network, inputs=None, labels=None, device="cuda"):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._device = resolve_device(device)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self._train_step_fn = None
        self._use_jit = True
        self.preempted = False
        self.last_step_skipped = False

    # -- prepare -----------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None, jit=True,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, Metric):
            self._metrics = [metrics]
        else:
            self._metrics = list(metrics)
        self._use_jit = jit
        self._train_step_fn = None
        return self

    # -- single-batch APIs -------------------------------------------------
    def _tensor(self, d):
        t = d if isinstance(d, torch.Tensor) else torch.from_numpy(
            np.require(d, requirements="C"))
        return t.to(self._device)

    def _to_tensors(self, data):
        if isinstance(data, (list, tuple)):
            return [self._tensor(d) for d in data]
        return [self._tensor(data)]

    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            raise RuntimeError("call prepare(loss=...) first")
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        return self._loss(*outs, *labels)

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        inputs = self._to_tensors(inputs)
        labels = self._to_tensors(labels) if labels is not None else []
        if self._use_jit:
            return self._jit_train_batch(inputs, labels, update)
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels)
        loss.backward()
        self.last_step_skipped = False
        if update:
            if flag("skip_nonfinite_steps") and not self._step_is_finite(loss):
                # the captured step guard's contract: a non-finite loss or
                # gradient keeps the old parameters
                self.last_step_skipped = True
            else:
                self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._run_metrics(outputs, labels)
        return self._pack(loss, metrics)

    def _step_is_finite(self, loss) -> bool:
        from ..jit.engine import all_finite
        grads = [p.grad for p in self.network.parameters()
                 if p.grad is not None]
        return bool(all_finite(loss, grads))

    def _jit_train_batch(self, inputs, labels, update=True):
        """The whole train step as one program a signature (the jit
        engine's captured step)."""
        if self._train_step_fn is None:
            from ..jit.engine import make_train_step
            with spans.span("compile", engine="jit_train", setup=1):
                self._train_step_fn = make_train_step(
                    self.network, self._loss, self._optimizer,
                    device=self._device)
        step = self._train_step_fn
        loss, outputs = step(inputs, labels)
        metrics = self._run_metrics(outputs, labels)
        logs = self._pack(loss, metrics)
        # the guard's answer lives on the device: read only where the
        # guard is on, after _pack's read has waited for the step
        self.last_step_skipped = step.guard and step.last_step_skipped
        return logs

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = self._to_tensors(inputs)
        labels = self._to_tensors(labels) if labels is not None else []
        with torch.no_grad():
            outputs = self.network(*inputs)
            loss = self._compute_loss(outputs, labels)
        metrics = self._run_metrics(outputs, labels)
        return self._pack(loss, metrics)

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = self._to_tensors(inputs)
        with torch.no_grad():
            outputs = self.network(*inputs)
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        return [_host_numpy(o) for o in outs]

    def _run_metrics(self, outputs, labels):
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        results = {}
        for m in self._metrics:
            r = m.compute(*outs, *labels)
            r = m.update(r) if not isinstance(r, (list, tuple)) else m.update(*r)
            name = m.name()
            results[name if isinstance(name, str) else name[0]] = r
        return results

    def _pack(self, loss, metrics):
        if isinstance(loss, torch.Tensor):
            # the float() is the step's host<-device sync point: the time
            # the thread spends blocked on the device here is the step's
            # dispatch stall
            t0 = time.perf_counter()
            with spans.span("host"):
                loss_v = float(loss.detach())
            tracing.record_sync(time.perf_counter() - t0)
        else:
            loss_v = loss
        logs = {"loss": loss_v}
        logs.update(metrics)
        return logs

    # -- loops -------------------------------------------------------------
    def _feed(self, loader, device_prefetch):
        """The epoch's batches: through a DevicePrefetcher of depth
        `device_prefetch` over the loader's host batches (the epoch's
        order drawn here, on this thread), or as the loader gives them."""
        if device_prefetch <= 0:
            return iter(loader)
        src = loader._host_iter() if isinstance(loader, DataLoader) \
            else iter(loader)
        return DevicePrefetcher(src, size=device_prefetch,
                                device=self._device)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None,
            auto_checkpoint_dir=None, exit_on_preempt=True,
            telemetry_dir=None, device_prefetch=None,
            telemetry_http=None):
        """Train. With `auto_checkpoint_dir` set, fit is PREEMPTION-SAFE:
        SIGTERM/SIGINT is deferred to the next batch boundary, an atomic
        checkpoint (parameters, buffers, optimizer, loop position, RNG
        state) is written there, and the process exits cleanly (rc 0); a
        relaunched fit with the same directory resumes at the same
        position. `exit_on_preempt=False` returns instead (self.preempted
        is True).

        With `telemetry_dir` set, the run writes its observability files
        there: the run journal (journal-rank<N>.jsonl: run_start/run_end,
        step, retrace, checkpoint and preemption events), crash bundles
        (flight.configure), and at the end `metrics.json` and
        `metrics-rank<N>.json`; a TelemetryCallback is installed.

        `device_prefetch` (default $PADDLE_TPU_DEVICE_PREFETCH, 2) is the
        queue depth of the device feed (io.prefetch.DevicePrefetcher): the
        loader's host batches are copied to the device by a feeder thread
        from pinned memory, the wait observed into `pt_feed_stall_ms`;
        0 takes the loader's batches as they come.

        `telemetry_http` (default $PADDLE_TPU_HTTP_PORT; unset = no
        socket) starts the telemetry server (observability/httpd.py) with
        a `train_loop` status block."""
        train_loader = self._to_loader(train_data, batch_size, shuffle,
                                       drop_last, num_workers)
        if device_prefetch is None:
            device_prefetch = int(
                os.environ.get("PADDLE_TPU_DEVICE_PREFETCH", "2") or 0)
        if getattr(train_loader, "prefetch_to_device", 0):
            device_prefetch = 0  # the DataLoader already feeds the device
        eval_loader = self._to_loader(eval_data, batch_size, False, False,
                                      num_workers) if eval_data is not None else None

        cbks = [ProgBarLogger(log_freq, verbose=verbose)]
        if save_dir:
            cbks.append(ModelCheckpoint(save_freq, save_dir))
        if callbacks:
            cbks += list(callbacks)

        journal_obj = prev_journal = None
        if telemetry_dir:
            rank = run_journal._default_rank()
            journal_obj = run_journal.RunJournal(telemetry_dir, rank=rank)
            prev_journal = run_journal.set_journal(journal_obj)
            journal_obj.emit("run_start", epochs=epochs,
                             batch_size=batch_size, jit=self._use_jit)
            try:
                from ..observability import flight
                flight.configure(telemetry_dir, rank=rank)
            except Exception:
                pass
            if not any(isinstance(c, TelemetryCallback) for c in cbks):
                cbks.append(TelemetryCallback())

        # the live plane opens a socket ONLY when telemetry_http or
        # $PADDLE_TPU_HTTP_PORT asks for one; it outlives fit
        fit_state = None
        try:
            from ..observability import httpd
            http_server = httpd.ensure_server(port=telemetry_http,
                                              endpoint_dir=telemetry_dir)
            if http_server is not None:
                fit_state = {"epochs": epochs, "epoch": 0, "step": 0,
                             "active": True}
                httpd.register_status("train_loop",
                                      lambda s=fit_state: dict(s))
        except Exception:
            http_server = None

        cbk = CallbackList(cbks)
        cbk.set_model(self)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbk.set_params({"epochs": epochs, "steps": steps,
                        "batch_size": batch_size, "verbose": verbose})

        resume = None
        ckpt_path = None
        guard = None
        if auto_checkpoint_dir:
            from ..checkpoint import CheckpointCorruptError, sweep_stale
            from ..incubate.checkpoint import load_checkpoint
            os.makedirs(auto_checkpoint_dir, exist_ok=True)
            sweep_stale(auto_checkpoint_dir)
            ckpt_path = os.path.join(auto_checkpoint_dir, "preempt_ckpt")
            if os.path.exists(ckpt_path):
                try:
                    # copies into the parameters, buffers and moments in
                    # place: a built train step replays on from them
                    resume = load_checkpoint(ckpt_path, self.network,
                                             self._optimizer)
                except CheckpointCorruptError:
                    # quarantined by the engine (journal event +
                    # pt_ckpt_corrupt_total); train from scratch rather
                    # than crash the relaunch
                    resume = None
                if resume is not None and resume.get("rng_state"):
                    from ..framework.random import set_rng_state
                    set_rng_state(resume["rng_state"])
            guard = PreemptionGuard().install()
        anomaly = (AnomalyGuard() if flag("skip_nonfinite_steps") else None)

        it_count = int(resume["it_count"]) if resume else 0
        resume_epoch = int(resume["epoch"]) if resume else -1
        resume_step = int(resume["step"]) if resume else -1

        self.stop_training = False
        self.preempted = False
        cbk.on_train_begin()
        try:
            try:
                for epoch in range(max(0, resume_epoch), epochs):
                    cbk.on_epoch_begin(epoch)
                    if fit_state is not None:
                        fit_state["epoch"] = epoch
                    for m in self._metrics:
                        m.reset()
                    logs = {}
                    feed = self._feed(train_loader, device_prefetch)
                    feed_it = enumerate(feed)
                    try:
                        while True:
                            # root "step" span over the loop body: its
                            # feed/compile/host children are the step's
                            # decomposition
                            with spans.span("step") as step_sp:
                                try:
                                    with spans.span("feed"):
                                        step, batch = next(feed_it)
                                except StopIteration:
                                    step_sp.cancel()
                                    break
                                if epoch == resume_epoch and \
                                        step <= resume_step:
                                    # consumed before the preemption
                                    # checkpoint
                                    step_sp.cancel()
                                    continue
                                memprof.sample(phase="feed")
                                chaos.step_hook(it_count)
                                health.tick(it_count)
                                cbk.on_train_batch_begin(step)
                                inputs, labels = self._split_batch(batch)
                                logs = self.train_batch(inputs, labels)
                                memprof.sample(phase="step")
                                cbk.on_train_batch_end(step, logs)
                                it_count += 1
                                if fit_state is not None:
                                    fit_state["step"] = it_count
                                if anomaly is not None:
                                    anomaly.observe(
                                        logs["loss"],
                                        skipped=self.last_step_skipped)
                            if guard is not None and guard.triggered:
                                self._save_preempt(ckpt_path, epoch, step,
                                                   it_count)
                                self.preempted = True
                                self.stop_training = True
                                break
                            if num_iters is not None and \
                                    it_count >= num_iters:
                                break
                    finally:
                        close = getattr(feed, "close", None)
                        if callable(close):
                            close()
                    if self.preempted:
                        break
                    for m in self._metrics:
                        name = m.name()
                        logs[name if isinstance(name, str)
                             else name[0]] = m.accumulate()
                    cbk.on_epoch_end(epoch, logs)
                    if eval_loader is not None and \
                            (epoch + 1) % eval_freq == 0:
                        self._run_eval(eval_loader, cbk)
                    if self.stop_training or (num_iters is not None
                                              and it_count >= num_iters):
                        break
            finally:
                if guard is not None:
                    guard.uninstall()
            cbk.on_train_end()
            if self.preempted:
                logger.info("fit preempted (signal %s): checkpoint saved "
                            "to %s", guard.signum, ckpt_path)
                if verbose:
                    print("fit preempted (signal %s): checkpoint saved to %s"
                          % (guard.signum, ckpt_path))
                if exit_on_preempt:
                    sys.exit(0)
            elif ckpt_path and os.path.exists(ckpt_path):
                shutil.rmtree(ckpt_path, ignore_errors=True)
        except Exception as e:
            # Exception, not BaseException: a clean preemption exits via
            # sys.exit(0) above and must not leave crash evidence
            if telemetry_dir:
                try:
                    from ..observability import flight
                    flight.dump_crash_bundle("fit_exception", exc=e,
                                             last_step=it_count)
                except Exception:
                    pass
            raise
        finally:
            if fit_state is not None:
                # the provider stays registered (the plane outlives fit),
                # but /statusz readers see that the loop has ended
                fit_state["active"] = False
            if journal_obj is not None:
                journal_obj.emit("run_end", it_count=it_count,
                                 preempted=self.preempted)
                try:
                    from ..observability.metrics import REGISTRY
                    REGISTRY.write_json(
                        os.path.join(telemetry_dir, "metrics.json"))
                    if journal_obj.rank is not None:
                        REGISTRY.write_json(os.path.join(
                            telemetry_dir,
                            "metrics-rank%d.json" % journal_obj.rank))
                except OSError as e:
                    logger.warning("metrics snapshot failed: %s", e)
                run_journal.set_journal(prev_journal)
                journal_obj.close()

    def _save_preempt(self, path, epoch, step, it_count):
        """Atomic preemption checkpoint: state + the exact loop position
        and the RNG state (JSON-able, in the checkpoint's meta)."""
        from ..checkpoint import wait_pending
        from ..framework.random import get_rng_state
        from ..incubate.checkpoint import save_checkpoint
        try:
            wait_pending()  # any async save must commit before this one
        except Exception as e:
            logger.warning("pending async checkpoint failed before "
                           "preemption save: %s", e)
        meta = {"epoch": int(epoch), "step": int(step),
                "it_count": int(it_count), "rng_state": get_rng_state()}
        out = save_checkpoint(path, self.network, self._optimizer, meta)
        run_journal.emit("checkpoint", kind="preempt", path=str(path),
                         epoch=int(epoch), step=int(step),
                         it_count=int(it_count))
        return out

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._to_loader(eval_data, batch_size, False, False,
                                 num_workers)
        cbk = CallbackList([ProgBarLogger(log_freq, verbose=verbose)] +
                           (list(callbacks) if callbacks else []))
        cbk.set_model(self)
        cbk.set_params({"verbose": verbose})
        return self._run_eval(loader, cbk)

    def _run_eval(self, loader, cbk):
        cbk.on_eval_begin()
        for m in self._metrics:
            m.reset()
        logs = {}
        losses = []
        for step, batch in enumerate(loader):
            cbk.on_eval_batch_begin(step)
            inputs, labels = self._split_batch(batch)
            logs = self.eval_batch(inputs, labels)
            losses.append(logs["loss"])
            cbk.on_eval_batch_end(step, logs)
        result = {"loss": float(np.mean(losses)) if losses else 0.0}
        for m in self._metrics:
            name = m.name()
            result[name if isinstance(name, str) else name[0]] = m.accumulate()
        cbk.on_eval_end(result)
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._to_loader(test_data, batch_size, False, False,
                                 num_workers)
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch, has_label=False)
            outputs.append(self.predict_batch(inputs))
        if not outputs:
            return []
        n_out = len(outputs[0])
        grouped = [[o[i] for o in outputs] for i in range(n_out)]
        if stack_outputs:
            grouped = [np.concatenate(g) for g in grouped]
        return grouped

    def _split_batch(self, batch, has_label=True):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2 and has_label:
                n_label = len(self._labels) if self._labels else 1
                inputs = list(batch[:-n_label])
                labels = list(batch[-n_label:])
                return inputs, labels
            return list(batch), []
        return [batch], []

    def _to_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        if hasattr(data, "__getitem__") and hasattr(data, "__len__"):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers,
                              device=self._device)
        return data  # assume an iterable of batches

    # -- persistence -------------------------------------------------------
    def save(self, path, training=True):
        fio.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load `path`.pdparams (and `.pdopt` unless reset_optimizer) into
        the network and the optimizer in place: a built train step keeps
        its program."""
        set_state_dict(self.network,
                       fio.load(path + ".pdparams", device=self._device))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(
                fio.load(opt_path, device=self._device))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .flops import summary
        return summary(self.network, input_size)
