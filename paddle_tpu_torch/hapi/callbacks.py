"""High-level API callbacks (the port's copy of
paddle_tpu/hapi/callbacks.py: ProgBarLogger, ModelCheckpoint,
LRScheduler, EarlyStopping, VisualDL and TelemetryCallback).

The LRScheduler callback steps the optimizer's scheduler on the host; a
captured train step reads the new lr from the optimizer's scalar buffer,
which the next call stages (optimizer.stage_step), so the lr after each
step is the reference's with no new program."""
from __future__ import annotations

import numbers
import os
import time

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "CallbackList", "VisualDL", "TelemetryCallback"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return dispatch
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._epoch_t0 = time.time()

    def _fmt(self, logs):
        parts = []
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                parts.append(f"{k}: {v:.4f}")
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], numbers.Number):
                parts.append(f"{k}: " + "/".join(f"{x:.4f}" for x in v))
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose == 2 and step % self.log_freq == 0:
            print(f"Epoch {self.epoch + 1}/{self.epochs} "
                  f"step {step}/{self.steps} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._epoch_t0
            print(f"Epoch {epoch + 1}/{self.epochs} done in {dt:.1f}s "
                  f"- {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print("Eval - " + self._fmt(logs))


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and self.save_dir and \
                epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model is not None and self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        from ..optimizer.lr import LRScheduler as Sched
        if opt and isinstance(opt._lr, Sched):
            return opt._lr
        return None

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.stopped_epoch = 0
        self.stop_training = False

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = self.baseline if self.baseline is not None else (
            -np.inf if self.mode == "max" else np.inf)

    def on_eval_end(self, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        if isinstance(value, (list, tuple)):
            value = value[0]
        improved = (value > self.best + self.min_delta if self.mode == "max"
                    else value < self.best - self.min_delta)
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                if self.model is not None:
                    self.model.stop_training = True


class VisualDL(Callback):
    """Scalar logging callback (reference: hapi/callbacks.py VisualDL over
    the visualdl LogWriter). The visualdl package is not a dependency;
    records are appended as JSON lines ({"tag", "step", "value"}) under
    `log_dir/vdlrecords.jsonl` — the same scalars, a grep-able format, and
    a drop-in spot to route to a real LogWriter when present."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._f = None
        self._train_step = 0

    def _write(self, tag, step, value):
        import json
        if self._f is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._f = open(os.path.join(self.log_dir, "vdlrecords.jsonl"),
                           "a")
        self._f.write(json.dumps({"tag": tag, "step": int(step),
                                  "value": float(value)}) + "\n")
        self._f.flush()

    def _log_dict(self, prefix, step, logs):
        for k, v in (logs or {}).items():
            try:
                arr = np.asarray(v, dtype=np.float64).ravel()
            except (TypeError, ValueError):
                continue
            if arr.size:
                self._write(f"{prefix}/{k}", step, arr[0])

    def on_train_batch_end(self, step, logs=None):
        self._train_step += 1
        self._log_dict("train", self._train_step, logs)

    def on_eval_end(self, logs=None):
        self._log_dict("eval", self._train_step, logs)

    def on_train_end(self, logs=None):
        if self._f is not None:
            self._f.close()
            self._f = None


def _device_mem_bytes():
    """Device memory in use, via the one sampler (observability/memprof.py:
    the CUDA caching allocator's counters; -1 where CUDA was never
    initialised), the read flight.sample_hbm banks, so a callback row and
    a crash bundle never disagree about the number."""
    try:
        from ..observability import memprof
        res = memprof.read_device_memory()
        return int(res[0]) if res is not None else -1
    except Exception:
        return -1


class TelemetryCallback(Callback):
    """Samples loss / throughput / device memory into the metrics registry
    and emits per-step `step` events into the active run journal.

    Installed automatically by `Model.fit(telemetry_dir=...)`; usable
    standalone like any other callback. Memory is sampled every `mem_freq`
    steps."""

    def __init__(self, mem_freq=50):
        super().__init__()
        self.mem_freq = int(mem_freq)
        from ..observability import metrics as _m
        self._g_loss = _m.gauge("pt_loss", "Last sampled training loss")
        self._g_sps = _m.gauge("pt_steps_per_sec",
                               "Steps/sec over the last train batch")
        self._g_ips = _m.gauge("pt_throughput_items_per_sec",
                               "Samples/sec over the last train batch")
        self._g_mem = _m.gauge("pt_device_mem_bytes",
                               "Device memory in use (best effort)")
        self._epoch = 0
        self._global_step = 0
        self._t_last = None

    def on_train_begin(self, logs=None):
        self._t_last = time.perf_counter()

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t_last = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        from ..observability import journal
        now = time.perf_counter()
        dt = now - self._t_last if self._t_last is not None else None
        self._t_last = now
        self._global_step += 1
        loss = (logs or {}).get("loss")
        ev = {"step": self._global_step, "epoch": self._epoch}
        if loss is not None:
            try:
                loss = float(np.asarray(loss).ravel()[0])
                self._g_loss.set(loss)
                ev["loss"] = round(loss, 6)
            except (TypeError, ValueError):
                pass
        if dt and dt > 0:
            self._g_sps.set(1.0 / dt)
            ev["step_s"] = round(dt, 6)
            bs = self.params.get("batch_size")
            if bs:
                self._g_ips.set(bs / dt)
        if self._global_step % self.mem_freq == 1 or self.mem_freq == 1:
            mem = _device_mem_bytes()
            if mem >= 0:
                self._g_mem.set(mem)
                ev["mem_bytes"] = mem
        journal.emit("step", **ev)

    def on_epoch_end(self, epoch, logs=None):
        from ..observability import journal
        journal.emit("epoch_end", epoch=epoch)

    def on_eval_end(self, logs=None):
        from ..observability import journal
        loss = (logs or {}).get("loss")
        journal.emit("eval_end", step=self._global_step,
                     loss=None if loss is None else float(loss))
