"""Request-level serving workloads: seeded open-loop arrival processes.

The serving simulator ("heavy traffic from millions of users") is driven
open-loop: requests arrive on their own clock regardless
of whether the engine keeps up — the regime in which batching policies
actually differ.  A :class:`Workload` is an immutable, *seed-deterministic*
list of :class:`RequestSpec`s; the same ``(rate, duration, seed, length
distributions)`` tuple produces a bit-identical request list on every run,
which is what makes :class:`repro_torch.serving.ServingPrediction`s reproducible
down to the float (an acceptance criterion of the subsystem).

Two generators:

* :func:`poisson_workload` — Poisson arrivals (exponential inter-arrival
  gaps) with lognormal prompt/output token lengths, the standard
  open-loop load model;
* :func:`trace_workload` — replay a request log (list of dicts or a JSONL
  file with ``arrival`` / ``prompt_tokens`` / ``output_tokens`` records),
  for production traces.

Everything downstream (graph generation, metrics) treats the workload as
ground truth; :func:`scale_arrivals` compresses the arrival clock to
model a rate change on the *same* request population (the apples-to-apples
comparison the monotone-latency property tests use).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One request of an open-loop workload (times in seconds, lengths in
    tokens).  ``output_tokens`` is the request's full decode budget — the
    simulator generates exactly this many tokens (token conservation)."""

    rid: int
    arrival: float
    prompt_tokens: int
    output_tokens: int

    def __post_init__(self) -> None:
        if self.prompt_tokens < 1 or self.output_tokens < 1:
            raise ValueError(
                f"request {self.rid}: prompt/output token counts must be "
                f">= 1, got {self.prompt_tokens}/{self.output_tokens}")
        if self.arrival < 0:
            raise ValueError(f"request {self.rid}: negative arrival time")


@dataclasses.dataclass(frozen=True)
class Workload:
    """An immutable arrival-ordered request list plus its provenance."""

    requests: Tuple[RequestSpec, ...]
    duration: float                 # arrival-window length (seconds)
    seed: Optional[int] = None      # None for trace-driven workloads
    source: str = "poisson"         # "poisson" | "trace" | "explicit"

    def __post_init__(self) -> None:
        arr = [r.arrival for r in self.requests]
        if any(b < a for a, b in zip(arr, arr[1:])):
            object.__setattr__(
                self, "requests",
                tuple(sorted(self.requests, key=lambda r: (r.arrival, r.rid))))

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def total_output_tokens(self) -> int:
        return sum(r.output_tokens for r in self.requests)

    @property
    def total_prompt_tokens(self) -> int:
        return sum(r.prompt_tokens for r in self.requests)

    @property
    def last_arrival(self) -> float:
        return self.requests[-1].arrival if self.requests else 0.0

    def offered_rate(self) -> float:
        """Realized request arrival rate (requests/s) over the window."""
        if not self.requests or self.duration <= 0:
            return 0.0
        return len(self.requests) / self.duration


def poisson_workload(rate: float, duration: float, *, seed: int = 0,
                     prompt_mean: int = 512, prompt_sigma: float = 0.6,
                     output_mean: int = 128, output_sigma: float = 0.6,
                     max_prompt: int = 32768,
                     max_output: int = 8192) -> Workload:
    """Seeded Poisson arrivals over ``[0, duration)`` at ``rate`` req/s.

    Prompt/output lengths are lognormal (median ``*_mean`` tokens, log-std
    ``*_sigma``) clamped to ``[1, max_*]`` — the long right tail is the
    point: a few huge prompts are what chunked prefill exists for.  All
    randomness flows through one ``numpy.random.default_rng(seed)``, so the
    workload is bit-identical across runs and platforms for a given
    parameter tuple.
    """
    if rate <= 0 or duration <= 0:
        raise ValueError(f"rate and duration must be > 0, got "
                         f"rate={rate}, duration={duration}")
    rng = np.random.default_rng(seed)
    reqs: List[RequestSpec] = []
    t = 0.0
    rid = 0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= duration:
            break
        p = int(min(max(1, round(math.exp(
            math.log(prompt_mean) + prompt_sigma * float(rng.standard_normal())
        ))), max_prompt))
        o = int(min(max(1, round(math.exp(
            math.log(output_mean) + output_sigma * float(rng.standard_normal())
        ))), max_output))
        reqs.append(RequestSpec(rid=rid, arrival=t, prompt_tokens=p,
                                output_tokens=o))
        rid += 1
    return Workload(tuple(reqs), duration=duration, seed=seed,
                    source="poisson")


def trace_workload(records: Any, *, duration: Optional[float] = None
                   ) -> Workload:
    """Build a workload from a request log.

    ``records`` is an iterable of dicts (or a path to a JSONL file of such
    dicts) with keys ``arrival`` (seconds), ``prompt_tokens``,
    ``output_tokens`` and optional ``rid``.  Records are sorted by arrival;
    ``duration`` defaults to the last arrival.
    """
    if isinstance(records, str):
        with open(records) as f:
            records = [json.loads(line) for line in f if line.strip()]
    reqs = []
    for i, rec in enumerate(records):
        reqs.append(RequestSpec(
            rid=int(rec.get("rid", i)), arrival=float(rec["arrival"]),
            prompt_tokens=int(rec["prompt_tokens"]),
            output_tokens=int(rec["output_tokens"])))
    reqs.sort(key=lambda r: (r.arrival, r.rid))
    dur = duration if duration is not None \
        else (reqs[-1].arrival if reqs else 0.0)
    return Workload(tuple(reqs), duration=dur, seed=None, source="trace")


def explicit_workload(specs: Sequence[Tuple[float, int, int]],
                      *, duration: Optional[float] = None) -> Workload:
    """Workload from explicit ``(arrival, prompt_tokens, output_tokens)``
    tuples — the test-suite's way to pin exact scenarios (e.g. a single
    full batch at t=0 for the static drain-time invariant)."""
    reqs = tuple(RequestSpec(rid=i, arrival=a, prompt_tokens=p,
                             output_tokens=o)
                 for i, (a, p, o) in enumerate(specs))
    dur = duration if duration is not None \
        else (max((r.arrival for r in reqs), default=0.0))
    return Workload(reqs, duration=dur, seed=None, source="explicit")


def scale_arrivals(workload: Workload, factor: float) -> Workload:
    """Compress (``factor < 1``) or stretch the arrival clock of the *same*
    request population — rate becomes ``rate / factor`` with identical
    prompts/outputs, the controlled comparison behind the monotone-latency
    property (higher rate on the same work must not reduce latency)."""
    if factor <= 0:
        raise ValueError(f"arrival scale factor must be > 0, got {factor}")
    reqs = tuple(dataclasses.replace(r, arrival=r.arrival * factor)
                 for r in workload.requests)
    return Workload(reqs, duration=workload.duration * factor,
                    seed=workload.seed, source=workload.source)
