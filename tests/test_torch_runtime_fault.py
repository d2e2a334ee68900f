"""repro_torch.runtime.fault against the JAX package's repro.runtime.fault.

First ``tests/test_runtime_fault.py`` run on the port's copy (the 14 tests,
unchanged), with its contracts:

* ``RetryPolicy`` / ``FaultTolerantRunner`` — restart-from-checkpoint
  accounting: failures count against the budget, exceeding it re-raises,
  recovery resumes from the last committed step (or from scratch when no
  checkpoint exists), and backoff grows geometrically then resets after a
  clean step;
* ``StragglerMonitor`` — needs >= 5 samples before flagging, compares
  against the rolling-median window, and invokes the mitigation hook with
  (step, dt, median);
* ``Heartbeat`` — atomic JSON liveness file, staleness detection, and
  interval-based write suppression.

Then the same runner schedule through both packages, and a drill on the
CPU: ``FaultTolerantRunner`` over the smoke trainer's step with a real
``CheckpointManager`` and one injected failure, whose final state must be
bit-equal to an uninterrupted run's.
"""

import json
import os
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.runtime.fault as ref_fault  # noqa: E402
import repro_torch.runtime.fault as port_fault  # noqa: E402
from repro_torch.runtime.fault import (FaultTolerantRunner, Heartbeat,  # noqa: E402
                                       RetryPolicy, StragglerMonitor)


class _Ckpt:
    """In-memory checkpoint store with save/restore hooks for the runner."""

    def __init__(self):
        self.saved = []          # (state, step) commits, in order
        self.restores = 0

    def save(self, state, step):
        self.saved.append((state, step))

    def restore(self):
        self.restores += 1
        return self.saved[-1] if self.saved else None


def _no_sleep(monkeypatch):
    naps = []
    monkeypatch.setattr(time, "sleep", lambda s: naps.append(s))
    return naps


class TestFaultTolerantRunner:
    def test_clean_run_saves_on_schedule_and_at_end(self):
        ck = _Ckpt()
        r = FaultTolerantRunner(make_state=lambda: 0,
                                step_fn=lambda s, i: s + 1,
                                save=ck.save, restore=ck.restore,
                                save_every=4)
        out = r.run(10)
        assert out == 10
        assert r.failures == 0 and r.restarts == 0
        # commits after steps 3, 7 and the final step 9
        assert [step for _, step in ck.saved] == [3, 7, 9]

    def test_failure_restores_last_commit_and_counts(self, monkeypatch):
        naps = _no_sleep(monkeypatch)
        ck = _Ckpt()
        fired = []

        def boom(i):
            if i == 6 and not fired:
                fired.append(i)
                raise RuntimeError("injected")

        r = FaultTolerantRunner(make_state=lambda: 0,
                                step_fn=lambda s, i: s + 1,
                                save=ck.save, restore=ck.restore,
                                save_every=4,
                                policy=RetryPolicy(max_failures=3,
                                                   backoff_s=0.5))
        out = r.run(10, inject_failure=boom)
        # steps 4,5 are replayed after restoring the step-3 commit: the
        # final state only reflects committed + replayed work.
        assert out == 10
        assert r.failures == 1 and r.restarts == 1
        assert naps == [0.5]

    def test_no_checkpoint_restarts_from_scratch(self, monkeypatch):
        _no_sleep(monkeypatch)
        ck = _Ckpt()
        fired = []

        def boom(i):
            if i == 2 and not fired:
                fired.append(i)
                raise RuntimeError("early crash")

        r = FaultTolerantRunner(make_state=lambda: 0,
                                step_fn=lambda s, i: s + 1,
                                save=ck.save, restore=ck.restore,
                                save_every=100)
        out = r.run(5, inject_failure=boom)
        assert out == 5
        assert r.restarts == 1
        # one probe before the loop, one after the failure
        assert ck.restores == 2

    def test_budget_exhaustion_reraises(self, monkeypatch):
        naps = _no_sleep(monkeypatch)
        ck = _Ckpt()

        def always(i):
            raise RuntimeError("persistent fault")

        r = FaultTolerantRunner(make_state=lambda: 0,
                                step_fn=lambda s, i: s + 1,
                                save=ck.save, restore=ck.restore,
                                policy=RetryPolicy(max_failures=2,
                                                   backoff_s=0.1,
                                                   backoff_mult=3.0))
        with pytest.raises(RuntimeError, match="persistent fault"):
            r.run(5, inject_failure=always)
        # budget of 2 absorbed, third failure re-raised without sleeping
        assert r.failures == 3
        assert naps == pytest.approx([0.1, 0.3])

    def test_backoff_resets_after_clean_step(self, monkeypatch):
        naps = _no_sleep(monkeypatch)
        ck = _Ckpt()
        fired = []

        def flaky(i):
            # two bursts separated by clean steps
            if i in (1, 3) and fired.count(i) < 1:
                fired.append(i)
                raise RuntimeError("transient")

        r = FaultTolerantRunner(make_state=lambda: 0,
                                step_fn=lambda s, i: s + 1,
                                save=ck.save, restore=ck.restore,
                                save_every=1,
                                policy=RetryPolicy(max_failures=5,
                                                   backoff_s=0.2,
                                                   backoff_mult=2.0))
        out = r.run(5, inject_failure=flaky)
        assert out == 5
        # each burst is a single failure after clean steps, so the backoff
        # restarts at backoff_s both times instead of compounding
        assert naps == pytest.approx([0.2, 0.2])

    def test_resume_from_existing_checkpoint(self):
        ck = _Ckpt()
        ck.saved.append((7, 6))   # state 7 committed at step 6
        r = FaultTolerantRunner(make_state=lambda: 0,
                                step_fn=lambda s, i: s + 1,
                                save=ck.save, restore=ck.restore,
                                save_every=100)
        out = r.run(10)
        # resumes at step 7, runs 7..9 on top of the restored state
        assert out == 7 + 3


class TestStragglerMonitor:
    def test_needs_five_samples_before_flagging(self):
        m = StragglerMonitor(threshold=2.0)
        for step in range(4):
            assert m.record(step, 100.0) is False   # warm-up, never flags
        assert m.flagged == []

    def test_flags_above_threshold_times_median_and_calls_hook(self):
        calls = []
        m = StragglerMonitor(threshold=2.0,
                             on_straggler=lambda s, dt, med:
                             calls.append((s, dt, med)))
        for step in range(5):
            m.record(step, 1.0)
        assert m.record(5, 1.9) is False            # below 2x median
        assert m.record(6, 2.5) is True
        assert m.flagged == [6]
        assert calls == [(6, 2.5, 1.0)]

    def test_rolling_window_adapts_median(self):
        m = StragglerMonitor(threshold=2.0, window=4)
        for step in range(8):
            m.record(step, 1.0)
        for step in range(8, 12):
            m.record(step, 10.0)    # regime shift fills the window
        # 10s is the new normal: median of the last 4 is 10, so 15 < 2x
        assert m.record(12, 15.0) is False
        assert m.median() == pytest.approx(1.0)     # all-time median lags

    def test_median_empty(self):
        assert StragglerMonitor().median() == 0.0


class TestHeartbeat:
    def test_beat_writes_atomic_json(self, tmp_path):
        path = str(tmp_path / "hb.json")
        hb = Heartbeat(path, interval_s=0.0)
        hb.beat(12, loss=0.5)
        with open(path) as f:
            beat = json.load(f)
        assert beat["step"] == 12 and beat["loss"] == 0.5
        assert not os.path.exists(path + ".tmp")
        assert Heartbeat.is_alive(path, timeout_s=60.0)

    def test_interval_suppresses_rewrites(self, tmp_path):
        path = str(tmp_path / "hb.json")
        hb = Heartbeat(path, interval_s=3600.0)
        hb.beat(1)
        hb.beat(2)      # within the interval: suppressed
        with open(path) as f:
            assert json.load(f)["step"] == 1

    def test_staleness_and_missing_file(self, tmp_path):
        path = str(tmp_path / "hb.json")
        assert Heartbeat.is_alive(path) is False            # missing
        with open(path, "w") as f:
            json.dump({"time": time.time() - 120.0, "step": 3}, f)
        assert Heartbeat.is_alive(path, timeout_s=60.0) is False    # stale
        assert Heartbeat.is_alive(path, timeout_s=300.0) is True

    def test_corrupt_file_is_dead(self, tmp_path):
        path = str(tmp_path / "hb.json")
        with open(path, "w") as f:
            f.write("{not json")
        assert Heartbeat.is_alive(path) is False
        with open(path, "w") as f:
            json.dump({"step": 3}, f)                       # no "time" key
        assert Heartbeat.is_alive(path) is False


# ------------------------------------------------------ both packages
def _schedule(mod, fail_at, save_every, n):
    """(saves, final state, failures, restarts) of one runner of ``mod``."""
    ck = _Ckpt()
    fired = set()

    def boom(i):
        if i in fail_at and i not in fired:
            fired.add(i)
            raise RuntimeError("injected")

    r = mod.FaultTolerantRunner(make_state=lambda: 0,
                                step_fn=lambda s, i: s + i,
                                save=ck.save, restore=ck.restore,
                                save_every=save_every,
                                policy=mod.RetryPolicy(backoff_s=0.0))
    out = r.run(n, inject_failure=boom)
    return ck.saved, out, r.failures, r.restarts


@pytest.mark.parametrize("fail_at,save_every,n", [
    ((), 4, 10), ((6,), 4, 10), ((0, 5, 9), 3, 12), ((2,), 100, 5),
    ((1, 2, 3), 1, 6)])
def test_runner_schedule_equals_reference(fail_at, save_every, n):
    assert (_schedule(port_fault, fail_at, save_every, n)
            == _schedule(ref_fault, fail_at, save_every, n))


# ----------------------------------------------------------- CPU drill
def test_drill_with_checkpoint_manager_resumes_bit_equal(tmp_path):
    """The chip drill at smoke size: N steps, a save every K, one failure
    injected at step F, each step on ``SyntheticLM.batch_at(i)``; the
    state restored from ``CheckpointManager`` through the reference's
    layout.  The final state equals an uninterrupted run's bit for bit,
    with one restart and F - (last save before F) - 1 steps re-run."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import state_from_reference, state_to_reference
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamW
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_smoke_config("tinyllama-1.1b")
    trainer = Trainer(cfg, TrainerConfig(log_every=0), device="cpu",
                      optimizer=AdamW(lr=1e-3, fused=True))
    data = SyntheticLM(cfg.vocab, 16, 2)
    like = state_to_reference(cfg, trainer.init_state("meta"))
    N, K, F = 8, 3, 7

    def drill(directory, fail_at):
        mgr = CheckpointManager(str(directory))
        executed = []

        def step(state, i):
            executed.append(i)
            batch = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
            return trainer.step_fn(state, batch)[0]

        def restore():
            if mgr.latest_step() is None:
                return None
            tree, last = mgr.restore_latest(like, device="cpu")
            return state_from_reference(cfg, tree, "cpu"), last

        def inject(i):
            if i == fail_at and fail_at not in executed:
                executed.append(fail_at)     # fired once
                raise RuntimeError("injected failure")

        r = FaultTolerantRunner(
            trainer.init_state, step,
            lambda s, i: mgr.save(i, state_to_reference(cfg, s)), restore,
            policy=RetryPolicy(backoff_s=0.0), save_every=K)
        return r.run(N, inject_failure=inject), r, executed

    clean, r0, _ = drill(tmp_path / "clean", None)
    failed, r1, executed = drill(tmp_path / "failed", F)
    assert (r0.restarts, r1.restarts, r1.failures) == (0, 1, 1)
    # step 6 runs again after restoring the step-5 commit (the marker
    # ``inject`` left for step F is not a step)
    assert executed.count(F) == 2 and len(executed) - 1 == N + (F - 6)
    assert int(failed["step"]) == N
    a, b = tree_leaves(clean), tree_leaves(failed)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
