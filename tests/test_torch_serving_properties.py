"""Hypothesis properties of the port's serving simulator
(``tests/test_serving_properties.py`` on ``repro_torch.serving``):

* latency is monotone non-decreasing in arrival rate: compressing the
  arrival clock of the *same* request population (``scale_arrivals``) must
  not reduce aggregate latency;
* token conservation: every request's generated token count equals its
  requested budget once the workload drains, under every policy;
* low-utilization closed form: when requests are spaced far wider than
  their service time, there is no queueing and each request's TTFT is
  exactly ``prefill(prompt) + decode_step(1, kv)``.

Every property runs with ``derandomize=True``: each run draws the same
examples, so a property is red every run or never.  Skipped wholesale when
``hypothesis`` is absent, as the other ``test_*_properties.py`` modules.
"""

import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")
torch.set_num_threads(1)

from hypothesis import given, settings  # noqa: E402

from repro_torch.serving import (ServingCostModel, ServingPolicy,  # noqa: E402
                                 ServingScenario, build_serving_graph,
                                 explicit_workload, poisson_workload,
                                 scale_arrivals)

COST = ServingCostModel()

policies = st.sampled_from([
    ServingPolicy(mode="static", slots=4),
    ServingPolicy(mode="continuous", slots=4),
    ServingPolicy(mode="continuous", slots=4, prefill_chunk=16),
    ServingPolicy(mode="continuous", slots=2, kv_capacity_tokens=400.0,
                  kv_offload=True),
])


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 1000), policy=policies,
       factor=st.floats(0.2, 0.9))
def test_latency_monotone_in_rate(seed, policy, factor):
    """Compressing arrivals (higher rate, same requests) must not reduce
    the mean end-to-end latency.  Aggregate, not pointwise: admission
    reshuffling can help an individual request, never the population."""
    wl = poisson_workload(80, 0.25, seed=seed, prompt_mean=24,
                          output_mean=6, output_sigma=0.3)
    if not wl.requests:
        return
    faster = scale_arrivals(wl, factor)

    def mean_latency(w):
        scn = ServingScenario(workload=w, policy=policy, serving_cost=COST)
        sg = scn._sgraph
        res = scn.baseline()
        last = {}
        for t in sg.graph.tasks():
            if t.attrs.get("serving") == "decode":
                rid = t.attrs["rid"]
                f = res.finish[t.uid]
                if rid not in last or f > last[rid]:
                    last[rid] = f
        return sum(last[r.rid] - r.arrival for r in w.requests) / len(w)

    assert mean_latency(faster) >= mean_latency(wl) - 1e-9


@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 1000), policy=policies)
def test_token_conservation(seed, policy):
    """generated == requested at drain, for every request, every policy."""
    wl = poisson_workload(120, 0.25, seed=seed, prompt_mean=24,
                          output_mean=6)
    sg = build_serving_graph(wl, COST, policy)
    assert sg.tokens_emitted == {r.rid: r.output_tokens
                                 for r in wl.requests}
    # and the graph really contains exactly that many decode tasks
    n = sum(1 for t in sg.graph.tasks()
            if t.attrs.get("serving") == "decode")
    assert n == wl.total_output_tokens


@settings(max_examples=25, deadline=None, derandomize=True)
@given(n=st.integers(1, 8), prompt=st.integers(1, 64),
       out=st.integers(1, 8),
       mode=st.sampled_from(["static", "continuous"]))
def test_low_utilization_ttft_closed_form(n, prompt, out, mode):
    """No queueing: spacing >> service time means each request runs alone
    and TTFT is exactly prefill(prompt) + one single-slot decode step."""
    service = COST.prefill_time(prompt) \
        + out * COST.decode_step_time(1, prompt + out)
    gap = 10.0 * service + 1e-3
    wl = explicit_workload([(1e-3 + i * gap, prompt, out)
                            for i in range(n)])
    scn = ServingScenario(workload=wl, serving_cost=COST,
                          policy=ServingPolicy(mode=mode, slots=4))
    res = scn.baseline()
    first = {}
    for t in scn._sgraph.graph.tasks():
        if t.attrs.get("serving") == "decode" and t.attrs["tok"] == 0:
            first[t.attrs["rid"]] = res.finish[t.uid]
    # static decodes against the batch's full reserved footprint; the
    # continuous engine's first step reads only the resident prompt KV
    kv = prompt + out if mode == "static" else prompt
    expect = COST.prefill_time(prompt) + COST.decode_step_time(1, kv)
    for r in wl.requests:
        ttft = first[r.rid] - r.arrival
        assert ttft == pytest.approx(expect, rel=1e-9), r


def _mean_latency(pkg, wl, policy):
    scn = pkg.ServingScenario(workload=wl, policy=policy,
                              serving_cost=pkg.ServingCostModel())
    res = scn.baseline()
    last = {}
    for t in scn._sgraph.graph.tasks():
        if t.attrs.get("serving") == "decode":
            last[t.attrs["rid"]] = max(last.get(t.attrs["rid"], 0.0),
                                       res.finish[t.uid])
    return sum(last[r.rid] - r.arrival for r in wl.requests) / len(wl)


def test_monotone_counterexample_matches_the_reference():
    """The input on which ``test_latency_monotone_in_rate`` fails (seed 74,
    continuous batching over 4 slots, arrivals compressed to 0.75) gives
    the reference's simulator the same mean latencies, bit for bit: the
    property's failure is inherited from the reference (ROADMAP queue C)."""
    import repro.serving as ref_serving
    import repro_torch.serving as port_serving
    got = []
    for pkg in (port_serving, ref_serving):
        wl = pkg.poisson_workload(80, 0.25, seed=74, prompt_mean=24,
                                  output_mean=6, output_sigma=0.3)
        policy = pkg.ServingPolicy(mode="continuous", slots=4)
        got.append((_mean_latency(pkg, wl, policy),
                    _mean_latency(pkg, pkg.scale_arrivals(wl, 0.75), policy)))
    assert got[0] == got[1]
