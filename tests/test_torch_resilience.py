"""The port's retry, preemption and resume paths, on the CPU: its versions
of the reference's TestRetryPolicy, TestWithDeadline and
TestPreemptionGuard (tests/test_resilience.py), TestAsync with the flush
on preemption (tests/test_checkpoint.py), the TrainEpochRange preemption
boundary, and the two drills that need a fresh process:

  * SIGTERM then resume: `chip_smoke.py --resume-drill` (phase 17's drill
    run itself, through its `run_drill`) on a 2-layer GPT of width 64, float32, dropout 0.1, 3
    epochs x 2 steps: uninterrupted; under
    PADDLE_TPU_CHAOS=sigterm_at_step:3 (exit 0 after epoch 1's save); a
    relaunch. The combined losses and the final parameters' and
    moments' sha256 equal the uninterrupted run's, bit for bit;
  * a torn write: the run dies by SIGKILL in epoch 1's save; the
    relaunch resumes from epoch 0, sweeps the dead run's droppings, and
    ends as the uninterrupted run did.

The retry and preemption tests use the port's modules alone: they import
neither JAX nor the JAX package.
"""
import json
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch

from chip_smoke import drill_digest, run_drill
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.checkpoint import engine, store
from paddle_tpu_torch.incubate.checkpoint import TrainEpochRange
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.observability import journal as run_journal
from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.resilience import (DeadlineExceeded, PreemptionGuard,
                                         RetryExhausted, RetryPolicy, chaos,
                                         preemption, with_deadline)
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)


def _counter(name):
    m = REGISTRY.get(name)
    return m.value if m is not None else 0.0


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# retry / deadline


class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def clock(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


class TestRetryPolicy:
    def test_unbounded_policy_refused(self):
        with pytest.raises(ValueError):
            RetryPolicy()

    def test_succeeds_after_transient_failures(self, tmp_path):
        fc = FakeClock()
        pol = RetryPolicy(max_tries=5, base_delay=1.0, jitter=0.0,
                          sleep=fc.sleep, clock=fc.clock)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        site = REGISTRY.counter("pt_retry_attempts_total",
                                labelnames=("site",)).labels("s")
        before = site.value
        jrn = run_journal.RunJournal(str(tmp_path), run_id="t", rank=0)
        prev = run_journal.set_journal(jrn)
        try:
            assert pol.call(flaky, retry_on=(OSError,), site="s") == "ok"
        finally:
            run_journal.set_journal(prev)
            jrn.close()
        assert len(calls) == 3
        assert fc.sleeps == [1.0, 2.0]   # exponential, deterministic
        assert site.value == before + 2
        retries = [e for e in _events(jrn.path) if e["event"] == "retry"]
        assert [(e["site"], e["attempt"]) for e in retries] == [("s", 0),
                                                               ("s", 1)]

    def test_exhaustion_chains_last_error(self):
        pol = RetryPolicy(max_tries=3, base_delay=0.0, jitter=0.0,
                          sleep=lambda s: None)
        with pytest.raises(RetryExhausted) as ei:
            pol.call(lambda: (_ for _ in ()).throw(ValueError("root")),
                     retry_on=(ValueError,))
        assert isinstance(ei.value.last_error, ValueError)
        assert pol.tries == 3

    def test_deadline_bounds_total_wall_clock(self):
        fc = FakeClock()
        pol = RetryPolicy(max_tries=100, base_delay=10.0, multiplier=1.0,
                          jitter=0.0, deadline_s=35.0,
                          sleep=fc.sleep, clock=fc.clock)
        attempts = [a for a in pol.attempts()]
        # sleeps 10,10,10 land at t=30; the next retry would start past
        # the 35s budget (sleep clipped to 5 -> expired) => 4 attempts
        assert len(attempts) == 4
        assert fc.t <= 35.0 + 1e-9

    def test_sleep_clipped_to_remaining(self):
        fc = FakeClock()
        pol = RetryPolicy(max_tries=10, base_delay=100.0, jitter=0.0,
                          deadline_s=30.0, sleep=fc.sleep, clock=fc.clock)
        assert len(list(pol.attempts())) == 1  # second try never starts
        assert fc.sleeps and fc.sleeps[0] <= 30.0

    def test_backoff_jitter_deterministic_per_seed(self):
        a = [RetryPolicy(max_tries=5, seed=3).backoff(i) for i in (1, 2, 3)]
        b = [RetryPolicy(max_tries=5, seed=3).backoff(i) for i in (1, 2, 3)]
        assert a == b

    def test_backoff_index_past_the_schedule_saturates(self):
        pol = RetryPolicy(max_tries=None, deadline_s=1.0, jitter=0.0,
                          max_delay=60.0)
        assert pol.backoff(100000) == 60.0


class TestWithDeadline:
    def test_fast_call_returns(self):
        assert with_deadline(lambda: 7, 5.0) == 7

    def test_slow_call_raises(self):
        with pytest.raises(DeadlineExceeded):
            with_deadline(time.sleep, 0.15, 10.0, context="nap")

    def test_error_propagates(self):
        with pytest.raises(KeyError):
            with_deadline(lambda: {}["missing"], 5.0)


# ---------------------------------------------------------------------------
# preemption guard


class TestPreemptionGuard:
    def test_sigterm_sets_flag_not_death(self):
        before = _counter("pt_preemptions_total")
        handler = signal.getsignal(signal.SIGTERM)
        with PreemptionGuard() as guard:
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.triggered and guard.signum == signal.SIGTERM
        # handlers restored on exit
        assert PreemptionGuard._installed is None
        assert signal.getsignal(signal.SIGTERM) == handler
        assert _counter("pt_preemptions_total") == before + 1

    def test_callbacks_run_and_broken_hook_tolerated(self):
        seen = []
        with PreemptionGuard() as guard:
            guard.add_callback(lambda s: (_ for _ in ()).throw(OSError()))
            guard.add_callback(seen.append)
            guard.trigger()
        assert seen == [signal.SIGTERM]

    def test_nested_install_is_noop(self):
        with PreemptionGuard() as outer:
            inner = PreemptionGuard().install()
            assert PreemptionGuard._installed is outer
            inner.uninstall()   # must not steal the outer's handlers
            assert PreemptionGuard._installed is outer

    def test_second_signal_escalates_to_the_previous_handler(self):
        hits = []
        prev = signal.signal(signal.SIGUSR1, lambda s, f: hits.append(s))
        try:
            with PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
                os.kill(os.getpid(), signal.SIGUSR1)
                assert guard.triggered and hits == []
                os.kill(os.getpid(), signal.SIGUSR1)
                assert hits == [signal.SIGUSR1]
        finally:
            signal.signal(signal.SIGUSR1, prev)

    def test_off_the_main_thread_it_is_a_flag(self):
        import threading
        box = {}
        handler = signal.getsignal(signal.SIGTERM)

        def run():
            g = PreemptionGuard().install()
            box["installed"] = PreemptionGuard._installed
            g.trigger()
            box["triggered"] = g.triggered
            g.uninstall()
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive(), "the guard's thread hung"
        assert box == {"installed": None, "triggered": True}
        assert signal.getsignal(signal.SIGTERM) == handler

    def test_handler_finds_the_port_modules_without_importing(self):
        """The names the handler looks up are the port's own, and both are
        loaded here (a handler imports nothing)."""
        assert preemption.ENGINE_MODULE == engine.__name__
        assert preemption.FLIGHT_MODULE == flight.__name__
        assert sys.modules.get(preemption.ENGINE_MODULE) is engine
        assert sys.modules.get(preemption.FLIGHT_MODULE) is flight

    def test_flight_bundles_a_preemption_only_when_opted_in(
            self, tmp_path, monkeypatch):
        flight.reset()
        flight.configure(str(tmp_path))
        try:
            monkeypatch.delenv(flight.ENV_DUMP_ON_TERM, raising=False)
            with PreemptionGuard() as guard:
                guard.trigger()
            assert not os.path.isdir(os.path.join(str(tmp_path), "crash"))
            monkeypatch.setenv(flight.ENV_DUMP_ON_TERM, "1")
            with PreemptionGuard() as guard:
                guard.trigger()
            crash = os.path.join(str(tmp_path), "crash")
            (bundle,) = os.listdir(crash)
            with open(os.path.join(crash, bundle, "MANIFEST.json")) as f:
                assert json.load(f)["reason"] == "preemption"
        finally:
            flight.reset()


def test_train_epoch_range_stops_at_boundary_on_preempt(tmp_path):
    tr = TrainEpochRange(5, "preempt_job", checkpoint_dir=str(tmp_path))
    net = nn.Linear(2, 2)
    done = []
    for e in tr.get():
        done.append(e)
        tr.save(layer=net)
        if e == 1:
            os.kill(os.getpid(), signal.SIGTERM)  # guard owned by tr.get()
    assert done == [0, 1]
    assert tr.preempted
    # relaunch resumes AFTER the last saved epoch
    tr2 = TrainEpochRange(5, "preempt_job", checkpoint_dir=str(tmp_path))
    assert tr2.restored_epoch == 1
    assert list(tr2.get()) == [2, 3, 4]


# ---------------------------------------------------------------------------
# async saves (the reference's TestAsync)


def _make_net(seed=7):
    torch.manual_seed(seed)
    net = nn.Linear(4, 3)
    opt = optimizer.Adam(learning_rate=0.01, parameters=net.parameters(),
                         device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 4)
                         .astype("float32"))
    net(x).sum().backward()
    opt.step()
    opt.clear_grad()
    return net, opt


class TestAsync:
    def _slow_writer(self, monkeypatch, delay):
        real = engine._write_and_commit

        def slow(path, snap):
            time.sleep(delay)
            return real(path, snap)

        monkeypatch.setattr(engine, "_write_and_commit", slow)

    def test_async_save_does_not_block_step_loop(self, tmp_path,
                                                 monkeypatch):
        """An async save costs the caller only the host snapshot: the
        (slowed) write and commit happen off-thread, from host copies that
        later changes to the model do not reach."""
        self._slow_writer(monkeypatch, delay=1.0)
        net, opt = _make_net()
        w = net.weight.detach().clone()
        p = str(tmp_path / "ck")
        t0 = time.perf_counter()
        h = engine.save_checkpoint(p, net, opt, {"e": 1}, async_=True)
        blocked = time.perf_counter() - t0
        assert blocked < 0.5, f"async save blocked {blocked:.2f}s"
        with torch.no_grad():
            net.weight.add_(1.0)
        assert not store.is_complete(p)          # still writing
        assert h.wait(10.0) == p
        arrays, meta, _ = store.read_store(p)
        assert meta == {"e": 1}
        np.testing.assert_array_equal(arrays["p/weight"], w.numpy())

    def test_single_inflight_slot_backpressures(self, tmp_path,
                                                monkeypatch):
        self._slow_writer(monkeypatch, delay=0.6)
        net, opt = _make_net()
        p1, p2 = str(tmp_path / "a"), str(tmp_path / "b")
        h1 = engine.save_checkpoint(p1, net, opt, async_=True)
        t0 = time.perf_counter()
        h2 = engine.save_checkpoint(p2, net, opt, async_=True)
        waited = time.perf_counter() - t0
        assert waited >= 0.3, "second async save must wait for the slot"
        assert h1.done                           # back-pressure = barrier
        h2.wait(10.0)
        assert store.is_complete(p1) and store.is_complete(p2)

    def test_wait_pending_barrier_and_error_propagation(self, tmp_path,
                                                        monkeypatch):
        def boom(path, snap):
            raise OSError("disk on fire")

        monkeypatch.setattr(engine, "_write_and_commit", boom)
        net, opt = _make_net()
        engine.save_checkpoint(str(tmp_path / "ck"), net, opt, async_=True)
        with pytest.raises(OSError, match="disk on fire"):
            engine.wait_pending(10.0)

    def test_preemption_guard_flushes_pending_save(self, tmp_path,
                                                   monkeypatch):
        """SIGTERM during an in-flight async save: the guard's grace window
        flush commits it before the flag-driven shutdown."""
        self._slow_writer(monkeypatch, delay=0.5)
        net, opt = _make_net()
        p = str(tmp_path / "ck")
        jrn = run_journal.RunJournal(str(tmp_path / "journal"), run_id="t",
                                     rank=0)
        prev = run_journal.set_journal(jrn)
        try:
            with PreemptionGuard() as guard:
                h = engine.save_checkpoint(p, net, opt, async_=True)
                assert not h.done
                chaos.configure("sigterm_at_step:3")
                try:
                    chaos.step_hook(2)           # not yet
                    assert not guard.triggered
                    chaos.step_hook(3)           # real SIGTERM, this pid
                finally:
                    chaos.reset()
                assert guard.triggered
                assert h.done                    # flushed in the handler
                assert store.is_complete(p)
        finally:
            run_journal.set_journal(prev)
            jrn.close()
        events = [e["event"] for e in _events(jrn.path)]
        assert "preemption" in events and "checkpoint_flush" in events
        assert events.index("checkpoint_flush") > events.index("preemption")


# ---------------------------------------------------------------------------
# the drills in fresh processes (phase 17's drill runs, at a small size)

DRILL = dict(device="cpu", model="gpt_tiny", B=2, T=16, epochs=3, steps=2,
             dtype="float32")


def _drill(d, name, spec=""):
    """One drill run under `d`: (exit code, stdout, stderr, losses by
    step), the checkpoints in d/ck, the log in d/<name>.jsonl."""
    rc, out, err, _, losses = run_drill(str(d / "ck"),
                                        str(d / (name + ".jsonl")), spec,
                                        **DRILL)
    return rc, out, err, losses


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    rc, out, err, losses = _drill(tmp_path_factory.mktemp("uninterrupted"),
                                  "log")
    assert rc == 0, err[-2000:]
    assert sorted(losses) == list(range(6))
    return losses, drill_digest(out, "DONE")


def test_sigterm_kill_then_resume_keeps_loss_trajectory(tmp_path,
                                                        uninterrupted):
    ref, ref_digest = uninterrupted
    rc, out, err, losses = _drill(tmp_path, "log", "sigterm_at_step:3")
    assert rc == 0, err[-2000:]                            # CLEAN exit
    assert drill_digest(out, "PREEMPTED") and "DRILL_DONE" not in out
    assert "DRILL_SAVED 1" in out and "DRILL_SAVED 2" not in out
    assert sorted(losses) == [0, 1, 2, 3]                  # epoch boundary
    assert store.is_complete(str(tmp_path / "ck" / "drill" / "epoch_1"))
    rc, out, err, losses = _drill(tmp_path, "log")
    assert rc == 0, err[-2000:]
    assert "DRILL_RESTORED 1 4" in out
    assert losses == ref                                   # bit for bit
    assert drill_digest(out, "DONE") == ref_digest


def test_torn_write_sigkill_resumes_from_last_good(tmp_path, uninterrupted):
    """The run is SIGKILLed half-way through a blob of epoch 1's save; the
    relaunch restores epoch 0, sweeps the dead run's .tmp droppings, and
    its losses and final state equal the uninterrupted run's."""
    ref, ref_digest = uninterrupted
    blobs = 28 + 2 * 28                   # gpt_tiny: parameters + moments
    rc, out, err, _ = _drill(tmp_path, "torn",
                             "torn_write:%d" % (blobs + blobs // 2))
    assert rc == -signal.SIGKILL, err[-2000:]
    assert "DRILL_SAVED 0" in out and "DRILL_SAVED 1" not in out
    jdir = str(tmp_path / "ck" / "drill")
    stray = [n for n in os.listdir(jdir) if ".tmp." in n]
    assert stray and not store.is_complete(os.path.join(jdir, stray[0]))
    rc, out, err, losses = _drill(tmp_path, "again")
    assert rc == 0, err[-2000:]
    assert "DRILL_RESTORED 0 2" in out
    assert not [n for n in os.listdir(jdir) if ".tmp." in n]
    assert losses == {k: v for k, v in ref.items() if k >= 2}
    assert drill_digest(out, "DONE") == ref_digest
