"""Property tests for the port's goodput simulator
(``tests/test_faults_properties.py`` on ``repro_torch.faults.goodput``).

Three invariants of ``simulate_goodput`` that must hold for *any* fault
process, not just the hand-checked fixtures:

* **monotone in the failure set** — adding failure events can never
  increase useful work: for any timeline ``E`` and superset ``E' ⊇ E``,
  ``useful(E') <= useful(E)``;
* **bounded by fault-free throughput** — ``goodput_fraction <= 1.0`` and
  ``availability <= 1.0``: faults only remove capacity;
* **lost work bounded by the checkpoint interval** — a fail-stop rollback
  loses at most ``ckpt_interval_steps`` whole steps, so
  ``max_lost_steps_per_failure <= K``.

The seeded cases are the reference's (same master seed), and each case's
report is also held ``==`` to the reference's.  The Hypothesis class runs
with ``derandomize=True``: each run draws the same examples, so a property
is red every run or never.
"""

import dataclasses
import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.faults as ref_faults  # noqa: E402
import repro_torch.faults as port_faults  # noqa: E402
from repro_torch.faults import (FaultTimeline, RecoveryModel,  # noqa: E402
                                exponential_failures, preemption_windows,
                                simulate_goodput, transient_stragglers)

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:        # the container image does not ship hypothesis
    HAVE_HYPOTHESIS = False

_REC = RecoveryModel(checkpoint_bytes=8e9)


def _sim(timeline, *, n, K, horizon_s, step_s=1.0, **kw):
    return simulate_goodput(n_workers=n, horizon_s=horizon_s,
                            timeline=timeline, recovery=_REC,
                            ckpt_interval_steps=K, step_s=step_s, **kw)


def _cases(n_cases=25, master_seed=20260809):
    rng = random.Random(master_seed)
    out = []
    for i in range(n_cases):
        out.append(dict(
            n=rng.randint(1, 32),
            mtbf_s=rng.uniform(0.5, 24.0) * 3600.0,
            K=rng.randint(1, 400),
            seed=rng.randint(0, 10_000),
            horizon_s=rng.uniform(2.0, 36.0) * 3600.0,
            step_s=rng.uniform(0.05, 5.0),
        ))
    return out


CASES = _cases()
_IDS = [f"case{i}" for i in range(len(CASES))]


def _mixed_timeline(c):
    """Failures + periodic preemptions + stragglers for case ``c``."""
    tl = exponential_failures(c["n"], c["mtbf_s"], c["horizon_s"], c["seed"])
    tl = tl | preemption_windows(7200.0, 300.0, c["horizon_s"],
                                 offset_s=1800.0)
    tl = tl | transient_stragglers(0.5, 2.0, 120.0, c["horizon_s"],
                                   seed=c["seed"])
    return tl


class TestSeededProperties:
    @pytest.mark.parametrize("c", CASES, ids=_IDS)
    def test_superset_of_failures_never_gains_useful_work(self, c):
        base = exponential_failures(c["n"], c["mtbf_s"], c["horizon_s"],
                                    c["seed"])
        extra = exponential_failures(c["n"], c["mtbf_s"], c["horizon_s"],
                                     c["seed"] + 1)
        more = base | extra
        assert set(base.events) <= set(more.events)
        kw = dict(n=c["n"], K=c["K"], horizon_s=c["horizon_s"],
                  step_s=c["step_s"])
        assert _sim(more, **kw).useful_steps <= _sim(base, **kw).useful_steps

    @pytest.mark.parametrize("c", CASES, ids=_IDS)
    def test_goodput_and_availability_at_most_one(self, c):
        rep = _sim(_mixed_timeline(c), n=c["n"], K=c["K"],
                   horizon_s=c["horizon_s"], step_s=c["step_s"])
        assert 0.0 <= rep.goodput_fraction <= 1.0 + 1e-9
        assert 0.0 <= rep.availability <= 1.0 + 1e-9

    @pytest.mark.parametrize("c", CASES, ids=_IDS)
    def test_lost_work_bounded_by_ckpt_interval(self, c):
        rep = _sim(_mixed_timeline(c), n=c["n"], K=c["K"],
                   horizon_s=c["horizon_s"], step_s=c["step_s"])
        assert rep.max_lost_steps_per_failure <= c["K"]
        if rep.failures:
            assert rep.lost_steps <= rep.failures * c["K"]

    @pytest.mark.parametrize("elastic", [False, True])
    def test_rate_monotone_goodput_curve(self, elastic):
        """Sweeping the per-worker MTBF down never raises goodput."""
        horizon, n, K = 24 * 3600.0, 8, 100
        prev = None
        for mtbf_h in (48.0, 12.0, 3.0, 0.75):
            tl = exponential_failures(n, mtbf_h * 3600.0, horizon, seed=7)
            rep = _sim(tl, n=n, K=K, horizon_s=horizon, elastic=elastic)
            if prev is not None:
                # distinct seeds per rate would only be distributionally
                # monotone; nested streams at the same seed give stronger
                # sample-path behaviour, but allow sampling slack anyway.
                assert rep.useful_steps <= prev * 1.02
            prev = rep.useful_steps


if HAVE_HYPOTHESIS:
    class TestHypothesisProperties:
        @settings(max_examples=50, deadline=None, derandomize=True)
        @given(n=st.integers(1, 32),
               mtbf_h=st.floats(0.25, 48.0),
               K=st.integers(1, 500),
               seed=st.integers(0, 2**16),
               horizon_h=st.floats(1.0, 48.0),
               step_s=st.floats(0.01, 10.0))
        def test_bounds_and_lost_work(self, n, mtbf_h, K, seed, horizon_h,
                                      step_s):
            tl = exponential_failures(n, mtbf_h * 3600.0,
                                      horizon_h * 3600.0, seed)
            rep = _sim(tl, n=n, K=K, horizon_s=horizon_h * 3600.0,
                       step_s=step_s)
            assert rep.goodput_fraction <= 1.0 + 1e-9
            assert rep.availability <= 1.0 + 1e-9
            assert rep.max_lost_steps_per_failure <= K

        @settings(max_examples=25, deadline=None, derandomize=True)
        @given(n=st.integers(1, 16),
               mtbf_h=st.floats(0.5, 24.0),
               K=st.integers(1, 200),
               seed=st.integers(0, 2**16))
        def test_superset_monotone(self, n, mtbf_h, K, seed):
            horizon = 12 * 3600.0
            base = exponential_failures(n, mtbf_h * 3600.0, horizon, seed)
            more = base | exponential_failures(n, mtbf_h * 3600.0, horizon,
                                               seed + 1)
            assert (_sim(more, n=n, K=K, horizon_s=horizon).useful_steps
                    <= _sim(base, n=n, K=K, horizon_s=horizon).useful_steps)


@pytest.mark.parametrize("c", CASES, ids=_IDS)
def test_mixed_timeline_report_equals_reference(c):
    def run(pkg):
        tl = (pkg.exponential_failures(c["n"], c["mtbf_s"], c["horizon_s"],
                                       c["seed"])
              | pkg.preemption_windows(7200.0, 300.0, c["horizon_s"],
                                       offset_s=1800.0)
              | pkg.transient_stragglers(0.5, 2.0, 120.0, c["horizon_s"],
                                         seed=c["seed"]))
        return dataclasses.asdict(pkg.simulate_goodput(
            n_workers=c["n"], horizon_s=c["horizon_s"], timeline=tl,
            recovery=pkg.RecoveryModel(checkpoint_bytes=8e9),
            ckpt_interval_steps=c["K"], step_s=c["step_s"]))
    assert run(port_faults) == run(ref_faults)
