"""repro_torch.analysis.calibrate against the JAX package's.

The first part is the CPU part of ``tests/test_calibrate.py`` run on the
port: perturb a CostModel, synthesize a capture from the *unperturbed* one,
and the simulate → diff → refit loop recovers the constants, drives per-kind
WAPE under 5% (dPRO's headline bound) and keeps the loss history
monotonically non-increasing.  Then the same fits through both packages,
held ``==`` (fitted constants, loss histories, simulator calls).

The reference's real-capture class (``TestRealJaxCapture``, a
``jax.profiler`` capture of a jitted matmul) is red there; in its place the
committed card capture ``tests/data/kineto_smoke_step.json.gz`` (one
training step of the smoke config on an H100, torch.profiler) goes through
``load_trace_dir``: its lanes never overlap, its durations are >= 0, and an
injected 1.5x compute scale fits back to 1.0.
"""

import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as ref_core  # noqa: E402
import repro.traceio as ref_traceio  # noqa: E402
from repro_torch.core.costmodel import CollectiveModel, CostModel, FittableConstant  # noqa: E402
from repro_torch.core.optimize import Scenario  # noqa: E402
from repro_torch.traceio import load_trace_dir, write_synthetic_trace_dir  # noqa: E402

LAYERS = 4
N_WORKERS = 4


@pytest.fixture(scope="module")
def capture_dir(tmp_path_factory):
    """A synthetic 4-worker capture generated from the TRUE (default)
    CostModel — the ground truth calibration must recover."""
    d = tmp_path_factory.mktemp("capture")
    write_synthetic_trace_dir(str(d), N_WORKERS, layers=LAYERS,
                              cost=CostModel())
    return str(d)


def perturbed_cost() -> CostModel:
    """Compute durations 30% hot, ICI bandwidth modeled at half speed."""
    return CostModel(kind_scales={"compute": 1.3}, ici_factor=0.5)


# ====================================================== parameter introspection
class TestFittableConstants:
    def test_typed_list_with_bounds(self):
        consts = CostModel().fittable_constants()
        by_name = {c.name: c for c in consts}
        assert "kind_scale:compute" in by_name
        assert "ici_factor" in by_name and "dcn_factor" in by_name
        assert "hop_latency" in by_name
        for c in consts:
            assert isinstance(c, FittableConstant)
            assert c.lo < c.hi
            assert c.lo <= c.value <= c.hi
        assert by_name["kind_scale:compute"].kind == "compute"
        assert by_name["hop_latency"].value == CollectiveModel.HOP_LATENCY

    def test_with_constants_round_trips(self):
        cost = CostModel().with_constants(
            {"kind_scale:compute": 1.5, "ici_factor": 0.5,
             "hop_latency": 5e-6})
        assert cost.kind_scale("compute") == 1.5
        assert cost.kind_scale("host") == 1.0        # untouched default
        assert cost.ici_factor == 0.5
        assert cost.collectives.hop_latency == 5e-6
        with pytest.raises(ValueError, match="unknown fittable"):
            CostModel().with_constants({"warp_factor": 9.0})

    def test_factors_thread_into_link_bandwidth(self):
        base = CostModel()
        half = CostModel(ici_factor=0.5, dcn_factor=2.0)
        assert half.link_bandwidth("ici") == \
            pytest.approx(0.5 * base.link_bandwidth("ici"))
        assert half.link_bandwidth("dcn") == \
            pytest.approx(2.0 * base.link_bandwidth("dcn"))
        # analytical collective formulas read the same factored bandwidth
        t_base = base.collectives.axis_time("all-reduce", 1e8, 8)
        t_half = half.collectives.axis_time("all-reduce", 1e8, 8)
        assert t_half > t_base

    def test_defaults_change_nothing(self):
        """kind_scales/factors default to the identity: a default-cost
        trace scenario predicts exactly what it predicts without them."""
        base = CostModel()
        assert base.kind_scale("compute") == 1.0
        assert base.link_bandwidth("ici") == \
            base.hw.ici_bandwidth * base.hw.ici_links_per_axis
        assert base.link_bandwidth("dcn") == base.hw.dcn_bandwidth

    def test_kind_scales_reach_trace_route_durations(self, capture_dir):
        plain = Scenario(trace_dir=capture_dir)
        hot = Scenario(trace_dir=capture_dir,
                       cost=CostModel(kind_scales={"compute": 2.0}))
        d_plain = plain.diff_against(plain.traces)
        d_hot = hot.diff_against(hot.traces)
        assert d_plain.per_kind()["compute"].wape == pytest.approx(0.0)
        assert d_hot.per_kind()["compute"].wape == pytest.approx(1.0)


# ================================================================ golden loop
class TestGoldenCalibration:
    def test_recovers_constants_and_fidelity(self, capture_dir):
        scn = Scenario(trace_dir=capture_dir, cost=perturbed_cost())
        calibrated, rep = scn.calibrate()

        # loss must be monotonically non-increasing and actually improve
        assert all(b <= a + 1e-15 for a, b in
                   zip(rep.loss_history, rep.loss_history[1:]))
        assert rep.loss_after < rep.loss_before
        assert rep.loss_before > 0.2          # the perturbation was real

        # the perturbed compute scale is recovered exactly (closed-form
        # weighted-median update against the same capture)
        init, fitted = rep.fitted["kind_scale:compute"]
        assert init == 1.3
        assert fitted == pytest.approx(1.0, rel=1e-6)

        # per-kind WAPE under dPRO's 5% bound, all kinds
        for kind, st in rep.after.per_kind().items():
            assert st.wape < 0.05, (kind, st.wape)
        assert abs(rep.after.makespan_rel_error) < 0.05

        # the calibrated scenario reproduces the fit stand-alone
        d = calibrated.diff_against(calibrated.traces)
        for kind, st in d.per_kind().items():
            assert st.wape < 0.05, (kind, st.wape)
        # and the input scenario was not mutated
        assert scn.cost.kind_scale("compute") == 1.3

    def test_bounded_simulator_calls(self, capture_dir):
        scn = Scenario(trace_dir=capture_dir, cost=perturbed_cost())
        probes = 6
        _, rep = scn.calibrate(probes_per_constant=probes)
        budget = 1 + rep.rounds * len(rep.fitted) * probes
        assert rep.sim_calls <= budget

    def test_constant_subset_and_unknown_names(self, capture_dir):
        scn = Scenario(trace_dir=capture_dir, cost=perturbed_cost())
        _, rep = scn.calibrate(constants=["kind_scale:compute"])
        assert set(rep.fitted) == {"kind_scale:compute"}
        assert rep.fitted["kind_scale:compute"][1] == \
            pytest.approx(1.0, rel=1e-6)
        # ici stays perturbed -> collective error remains
        assert rep.after.per_kind()["collective"].wape > 0.05
        with pytest.raises(ValueError, match="unknown/unfittable"):
            scn.calibrate(constants=["kind_scale:bogus"])

    def test_faithful_model_converges_immediately(self, capture_dir):
        scn = Scenario(trace_dir=capture_dir)      # true constants already
        _, rep = scn.calibrate()
        assert rep.converged
        assert rep.sim_calls == 1                  # no probing a 0 loss
        assert rep.loss_before == pytest.approx(0.0, abs=1e-9)

    def test_report_format_renders_table(self, capture_dir):
        scn = Scenario(trace_dir=capture_dir, cost=perturbed_cost())
        _, rep = scn.calibrate()
        out = rep.format()
        assert "wape before" in out and "wape after" in out
        assert "kind_scale:compute" in out
        assert "makespan rel err" in out
        assert "inf" not in out

    def test_calibrate_needs_a_capture(self):
        from torch_synthgraphs import training_step_graph
        scn = Scenario(training_step_graph(layers=2))
        with pytest.raises(ValueError, match="captured trace set"):
            scn.calibrate()

    def test_explicit_trace_dir_argument(self, capture_dir):
        """Calibrating an analytic scenario against an external capture
        takes the trace route internally and returns a calibrated copy."""
        scn = Scenario(trace_dir=capture_dir, cost=perturbed_cost())
        calibrated, rep = scn.calibrate(capture_dir)
        assert rep.loss_after < rep.loss_before
        assert calibrated.cost.kind_scale("compute") == \
            pytest.approx(1.0, rel=1e-6)




# ================================================== both packages, ==
@pytest.fixture(scope="module")
def capture_dirs(tmp_path_factory):
    """The same synthetic capture written by each package."""
    out = {}
    for label, (tio, cost) in {"ref": (ref_traceio, ref_core.CostModel()),
                               "port": (None, CostModel())}.items():
        d = tmp_path_factory.mktemp(f"capture_{label}")
        (tio.write_synthetic_trace_dir if tio else write_synthetic_trace_dir)(
            str(d), N_WORKERS, layers=LAYERS, cost=cost)
        out[label] = str(d)
    return out


@pytest.mark.parametrize("constants", [None, ["kind_scale:compute"], ["ici_factor"]],
                         ids=["all", "compute", "ici"])
def test_fit_equals_the_reference(capture_dirs, constants):
    fits = []
    for core, d in ((ref_core, capture_dirs["ref"]), (None, capture_dirs["port"])):
        cm, scn_cls = (core.CostModel, core.Scenario) if core else (CostModel, Scenario)
        scn = scn_cls(trace_dir=d, cost=cm(kind_scales={"compute": 1.3}, ici_factor=0.5))
        calibrated, rep = scn.calibrate(constants=constants)
        fits.append((rep.fitted, rep.loss_history, rep.rounds, rep.sim_calls,
                     rep.converged, rep.format(),
                     {k: v.wape for k, v in rep.after.per_kind().items()},
                     calibrated.cost.kind_scales, calibrated.cost.ici_factor))
    assert fits[1] == fits[0]


# ============================================ the committed card capture
CARD = Path(__file__).resolve().parent / "data" / "kineto_smoke_step.json.gz"


@pytest.fixture(scope="module")
def card_dir(tmp_path_factory):
    """The committed card capture in a directory, under the name torch.profiler
    gives its exports."""
    d = tmp_path_factory.mktemp("card")
    shutil.copy(CARD, d / "host_0.step.pt.trace.json.gz")
    return str(d)


class TestCardCapture:
    def test_import_maps_onto_lane_model(self, card_dir):
        imp = load_trace_dir(card_dir)             # format auto-detected
        assert imp.num_workers == 1
        events = imp.traces[0].events
        assert {e.thread for e in events} == {"device", "host"}
        by_lane = {}
        for e in events:
            by_lane.setdefault(e.thread, []).append(e)
        for evs in by_lane.values():
            evs.sort(key=lambda e: e.ts)
            for a, b in zip(evs, evs[1:]):
                assert b.ts >= a.end - 1e-12
        assert all(e.dur >= 0 for e in events)

    def test_scenario_calibrates_the_card_capture(self, card_dir):
        imp = load_trace_dir(card_dir)
        scn = Scenario(traces=imp, cost=CostModel(kind_scales={"compute": 1.5}))
        calibrated, rep = scn.calibrate()
        # trace durations are ground truth here, so the injected 1.5x
        # compute perturbation must fit back out
        assert rep.fitted["kind_scale:compute"][1] == pytest.approx(1.0, rel=1e-6)
        assert rep.after.per_kind()["compute"].wape < 0.05
        assert rep.loss_after < rep.loss_before
        assert calibrated.cost.kind_scale("compute") == pytest.approx(1.0, rel=1e-6)

    def test_capture_replays_itself(self, card_dir):
        """Diffed against its own capture, the imported step has no error:
        the reader's events are its graph's timeline."""
        scn = Scenario(trace_dir=card_dir)
        d = scn.diff_against(scn.traces)
        assert d.tasks and not d.unmatched_predicted and not d.unmatched_captured
        assert d.max_abs_error() < 1e-12
        _, rep = scn.calibrate()
        assert rep.converged and rep.sim_calls == 1
