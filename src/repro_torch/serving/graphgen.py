"""Lower a serving policy over a workload into a dependency graph.

This is the serving analogue of the training-step graph builders: one
deterministic pass over the workload plays the batching policy forward
(using the same :class:`~repro_torch.serving.costs.ServingCostModel` durations
the simulator will see) and emits a graph whose *edges encode exactly the
waits the policy imposes*, so :func:`repro_torch.core.simulate.simulate`
reproduces the policy's timeline — and every existing tool (critical
paths, trace export/diff, headroom erasure, cluster wiring) works on it
unchanged.

Graph encoding (lanes are simulator threads):

* ``arrivals`` — one zero-duration task per request whose ``gap`` is the
  inter-arrival time, so request ``i``'s arrival task *completes* at
  exactly ``arrival_i``; everything a request does is gated on it.  This
  is what makes the makespan of *any* policy >= the last arrival — the
  floor the serving ``headroom_targets`` bounds lean on.
* ``device`` — PREFILL tasks (one per request; one per chunk when chunked
  prefill is on), program-order serialized like a real engine's compute
  stream.
* ``sched`` — zero-duration SYNC gate tasks: one admission gate per batch
  (static) and one gate per decode step.  A step's gate waits on the
  previous step's token tasks and on any prefill work the policy ordered
  before it; its children are the step's token tasks.  Scheduler policies
  differ *only* in how these gates are wired.
* ``slot:<k>`` — chained per-token DECODE tasks on batch-slot lanes; slot
  lanes are the per-lane utilization the prediction reports.
* ``coll`` — per-step tensor-parallel all-reduce tasks (``attrs
  ["collective"]``), wired into rings by
  :meth:`repro_torch.core.cluster.ClusterGraph.wire_collective_group` when the
  scenario routes through the cluster simulator.
* ``dma`` — KV-offload streaming tasks (PCIe) when residency exceeds the
  device capacity and ``kv_offload`` is on.

KV-cache residency is a capacity constraint at admission: a request
reserves its full footprint (``prompt + output`` tokens) against
``kv_capacity_tokens`` and is queued until the reservation fits (or, with
``kv_offload``, admitted anyway with the excess streamed over PCIe each
step).

Static-batch drain-time invariant
---------------------------------
In ``mode="static"`` the engine admits up to ``slots`` arrived requests,
prefills them, then decodes the whole batch in lockstep for ``budget =
max(member output_tokens)`` steps — finished slots idle until the batch
drains, as ``repro_torch.serve.ServeEngine`` does.  Every
step reads the batch's full pre-allocated KV, so all steps cost the same
and the simulated makespan of a single full batch arriving at t=0 equals
``sum(prefill_i) + budget * decode_step`` to float precision — the
subsystem's calibration anchor, asserted by ``tests/test_torch_serving.py``.
The engine takes each request's first token from the prefill and runs
``budget - 1`` decode steps; the simulator charges ``budget`` steps, as the
reference does (ROADMAP queue C, C8), so a static drain reads about
``1 / budget`` long.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.graph import DependencyGraph
from repro_torch.core.task import Task, TaskKind, DEVICE_STREAM
from repro_torch.obs.spans import span as _obs_span
from .costs import ServingCostModel
from .workload import RequestSpec, Workload

ARRIVAL_LANE = "arrivals"
SCHED_LANE = "sched"
COLL_LANE = "coll"
DMA_LANE = "dma"


def slot_lane(k: int) -> str:
    return f"slot:{k}"


def slot_lane_classes(result, *, prefix: str = "") -> List[Tuple[int, ...]]:
    """Partition ``slot:<k>`` lanes into symmetry classes.

    Batch-slot lanes are interchangeable by construction — the engine
    admits requests into whichever slot is free — so lanes whose
    simulated busy time is exactly equal form one equivalence class.
    Returns slot-index tuples (each ascending, ordered by busy time),
    mirroring the cluster layer's worker classes: at 10k scale, report
    one representative lane per class instead of every lane.  Pass
    ``prefix="w0/"`` to scope to one worker of a namespaced cluster
    graph.
    """
    want = prefix + "slot:"
    groups: Dict[float, List[int]] = {}
    for th, busy in result.thread_busy.items():
        if not th.startswith(want):
            continue
        try:
            k = int(th[len(want):])
        except ValueError:
            continue
        groups.setdefault(busy, []).append(k)
    return [tuple(sorted(members))
            for _, members in sorted(groups.items())]


@dataclasses.dataclass(frozen=True)
class ServingPolicy:
    """How the engine batches requests — the knob surface the registered
    serving optimizations adjust (see :mod:`repro_torch.serving.scenario`).

    ``mode="static"`` is the baseline (the engine's semantics, see module
    docstring); ``mode="continuous"`` admits/retires requests at every
    decode-step boundary.  ``prefill_chunk > 0`` splits prefills into
    chunks that ride along decode steps instead of stalling them
    (continuous mode only — static mode just splits the prefill tasks).
    ``kv_capacity_tokens == 0`` derives the capacity from the cost model;
    ``float("inf")`` disables the constraint.  ``tp_degree > 1`` shards
    the model over that many workers and inserts per-step all-reduce
    collectives for the cluster simulator to wire into rings.
    """

    mode: str = "static"
    slots: int = 8
    prefill_chunk: int = 0
    kv_capacity_tokens: float = 0.0
    kv_offload: bool = False
    tp_degree: int = 1

    def __post_init__(self) -> None:
        if self.mode not in ("static", "continuous"):
            raise ValueError(
                f"serving mode must be 'static' or 'continuous', "
                f"got {self.mode!r}")
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.prefill_chunk < 0 or self.tp_degree < 1:
            raise ValueError(
                f"bad policy: prefill_chunk={self.prefill_chunk}, "
                f"tp_degree={self.tp_degree}")

    def capacity(self, cost: ServingCostModel) -> float:
        if self.kv_capacity_tokens > 0:
            return self.kv_capacity_tokens
        cap = cost.kv_capacity_tokens()
        return cap if cap > 0 else float("inf")


@dataclasses.dataclass
class ServingGraph:
    """The lowered graph plus the request bookkeeping metrics need."""

    graph: DependencyGraph
    workload: Workload
    policy: ServingPolicy
    cost: ServingCostModel          # already sharded by tp_degree
    # rid -> number of emitted DECODE token tasks (== output_tokens)
    tokens_emitted: Dict[int, int]
    num_steps: int                  # decode-step gates emitted
    num_batches: int                # admissions (static) / 1 (continuous)


class _Emitter:
    """Shared graph-emission state for both policy loops."""

    def __init__(self, wl: Workload, cost: ServingCostModel,
                 pol: ServingPolicy) -> None:
        self.g = DependencyGraph()
        self.cost = cost
        self.pol = pol
        self.arrival: Dict[int, Task] = {}
        self.tokens: Dict[int, int] = {}
        self.num_steps = 0
        prev = 0.0
        for r in wl.requests:
            t = self.g.add_task(Task(
                name=f"arrive:r{r.rid}", kind=TaskKind.HOST,
                thread=ARRIVAL_LANE, duration=0.0, gap=r.arrival - prev,
                phase="serve",
                attrs={"serving": "arrival", "rid": r.rid}))
            self.arrival[r.rid] = t
            prev = r.arrival

    def gate(self, name: str, parents: List[Task]) -> Task:
        t = self.g.add_task(Task(
            name=name, kind=TaskKind.SYNC, thread=SCHED_LANE, duration=0.0,
            phase="serve", attrs={"serving": "gate"}))
        for p in parents:
            self.g.add_edge(p, t)
        return t

    def prefill(self, r: RequestSpec, tokens: int, dur: float,
                parents: List[Task], *, chunk: int = -1) -> Task:
        name = f"prefill:r{r.rid}" if chunk < 0 \
            else f"prefill:r{r.rid}:c{chunk}"
        t = self.g.add_task(Task(
            name=name, kind=TaskKind.COMPUTE, thread=DEVICE_STREAM,
            duration=dur, phase="serve",
            flops=tokens * self.cost.prefill_flops_per_token,
            bytes_accessed=self.cost.weight_bytes
            + tokens * self.cost.kv_bytes_per_token,
            attrs={"serving": "prefill", "rid": r.rid, "tokens": tokens}))
        for p in parents:
            self.g.add_edge(p, t)
        return t

    def token(self, r: RequestSpec, slot: int, tok: int, dur: float,
              gate: Task) -> Task:
        self.tokens[r.rid] = self.tokens.get(r.rid, 0) + 1
        t = self.g.add_task(Task(
            name=f"decode:r{r.rid}:t{tok}", kind=TaskKind.COMPUTE,
            thread=slot_lane(slot), duration=dur, phase="serve",
            flops=self.cost.flops_per_token,
            attrs={"serving": "decode", "rid": r.rid, "tok": tok,
                   "slot": slot}))
        self.g.add_edge(gate, t)
        return t

    def collective(self, name: str, payload: float, dur: float,
                   parents: List[Task]) -> Task:
        t = self.g.add_task(Task(
            name=name, kind=TaskKind.COLLECTIVE, thread=COLL_LANE,
            duration=dur, phase="serve", comm_bytes=payload,
            attrs={"serving": "coll", "collective": "all-reduce"}))
        for p in parents:
            self.g.add_edge(p, t)
        return t

    def dma(self, name: str, excess_tokens: float, dur: float,
            parents: List[Task]) -> Task:
        t = self.g.add_task(Task(
            name=name, kind=TaskKind.OFFLOAD, thread=DMA_LANE,
            duration=dur, phase="serve",
            bytes_accessed=excess_tokens * self.cost.kv_bytes_per_token,
            attrs={"serving": "dma"}))
        for p in parents:
            self.g.add_edge(p, t)
        return t

    def step_coll_time(self, batch: int) -> float:
        """Estimated per-step TP all-reduce time (ring formula) — used by
        the policy loop's forward clock; the cluster wiring recomputes the
        real leg durations from ``comm_bytes`` when the graph is placed."""
        d = self.pol.tp_degree
        if d <= 1:
            return 0.0
        payload = batch * self.cost.tp_coll_bytes_per_token
        bw = self.cost.hw.ici_bandwidth
        return 2.0 * (d - 1) / d * payload / bw


def build_serving_graph(workload: Workload, cost: ServingCostModel,
                        policy: ServingPolicy) -> ServingGraph:
    """Lower ``policy`` over ``workload`` into a simulatable graph.

    The cost model is sharded by ``policy.tp_degree`` first, so task
    durations/FLOPs are per-chip; collectives carry the all-reduce payload
    for the cluster wiring.  O(requests + generated tokens) tasks.
    """
    with _obs_span("serving.graphgen", requests=len(workload.requests),
                   mode=policy.mode, tp=policy.tp_degree) as sp:
        sharded = cost.parallel(policy.tp_degree)
        em = _Emitter(workload, sharded, policy)
        if policy.mode == "static":
            batches = _static_loop(em, workload)
        else:
            batches = _continuous_loop(em, workload)
        em.g.validate()
        sp.note(tasks=len(em.g), tokens=em.tokens)
        return ServingGraph(graph=em.g, workload=workload, policy=policy,
                            cost=sharded, tokens_emitted=em.tokens,
                            num_steps=em.num_steps, num_batches=batches)


# ---------------------------------------------------------------- static
def _static_loop(em: _Emitter, wl: Workload) -> int:
    """Seed-engine semantics: admit a batch, prefill, decode in lockstep
    until the *whole batch* drains (budget = max member output)."""
    pol, cost = em.pol, em.cost
    cap = pol.capacity(cost)
    pending: List[RequestSpec] = list(wl.requests)
    prev_gate: Optional[Task] = None
    t_free = 0.0
    batches = 0
    while pending:
        # admission clock: engine free vs first pending arrival
        t_adm = max(t_free, pending[0].arrival)
        batch: List[RequestSpec] = []
        reserved = 0.0
        for r in pending:
            if len(batch) >= pol.slots or r.arrival > t_adm:
                break
            need = r.prompt_tokens + r.output_tokens
            if batch and not pol.kv_offload and reserved + need > cap:
                break               # KV capacity caps the batch
            batch.append(r)
            reserved += need
        pending = pending[len(batch):]
        batches += 1
        adm = em.gate(f"admit:b{batches - 1}",
                      ([prev_gate] if prev_gate else [])
                      + [em.arrival[r.rid] for r in batch])
        # per-request prefills, serialized on the device lane
        chunk = pol.prefill_chunk
        tail: List[Task] = []
        t_run = t_adm
        for r in batch:
            parents = [adm]
            last = None
            for c0, n in _chunks(r.prompt_tokens, chunk):
                dur = cost.prefill_time(n)
                last = em.prefill(r, n, dur, parents, chunk=c0)
                parents = []        # lane order chains further chunks
                t_run += dur
            tail.append(last)
        # lockstep decode: every step reads the batch's full pre-allocated
        # KV, so all ``budget`` steps cost the same (the drain invariant)
        budget = max(r.output_tokens for r in batch)
        kv = sum(r.prompt_tokens + r.output_tokens for r in batch)
        step_dur = cost.decode_step_time(len(batch), kv)
        excess = max(0.0, kv - cap) if pol.kv_offload else 0.0
        gate = em.gate(f"step:b{batches - 1}:s0", tail)
        for s in range(budget):
            toks = [em.token(r, k, s, step_dur, gate)
                    for k, r in enumerate(batch) if s < r.output_tokens]
            extra: List[Task] = []
            if pol.tp_degree > 1:
                extra.append(em.collective(
                    f"tp-ar:b{batches - 1}:s{s}",
                    len(toks) * cost.tp_coll_bytes_per_token,
                    em.step_coll_time(len(toks)), toks))
            if excess > 0:
                extra.append(em.dma(f"kv-dma:b{batches - 1}:s{s}", excess,
                                    cost.kv_offload_time(excess), toks))
            em.num_steps += 1
            t_run += step_dur + max(em.step_coll_time(len(toks)),
                                    cost.kv_offload_time(excess))
            gate = em.gate(f"step:b{batches - 1}:s{s + 1}", toks + extra)
        prev_gate = gate
        t_free = t_run
    return batches


def _chunks(tokens: int, chunk: int) -> List[Tuple[int, int]]:
    """(index, size) chunks of a prompt (one chunk when chunking is off)."""
    if chunk <= 0 or tokens <= chunk:
        return [(-1, tokens)]
    out = []
    done = 0
    i = 0
    while done < tokens:
        n = min(chunk, tokens - done)
        out.append((i, n))
        done += n
        i += 1
    return out


# ------------------------------------------------------------ continuous
@dataclasses.dataclass
class _Active:
    """One in-flight request of the continuous loop."""

    req: RequestSpec
    slot: int
    emitted: int = 0                # decode tokens emitted so far
    # remaining prefill chunks: (chunk index, tokens); empty == decoding
    chunks: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    last_work: Optional[Task] = None   # task the next step gate waits on


def _continuous_loop(em: _Emitter, wl: Workload) -> int:
    """Continuous batching: admit into free slots at every step boundary.

    Un-chunked prefills run on the device lane *before* the next step's
    gate — admitting a long prompt stalls every active decode (the classic
    TTFT interference chunked prefill removes).  With ``prefill_chunk``
    set, one chunk per admitted request rides along each decode step: the
    chunk task runs on the device lane in parallel with the step's token
    tasks and the next gate waits on both, so the step costs
    ``max(decode_step, chunk_time)`` instead of their sum.
    """
    pol, cost = em.pol, em.cost
    cap = pol.capacity(cost)
    pending: List[RequestSpec] = list(wl.requests)
    active: List[_Active] = []
    free_slots = list(range(pol.slots - 1, -1, -1))   # pop() -> slot 0 first
    reserved = 0.0
    t_now = 0.0
    prev_gate: Optional[Task] = None
    step_idx = 0
    while pending or active:
        if not active and pending and t_now < pending[0].arrival:
            t_now = pending[0].arrival      # idle engine: jump to arrival
        # --- admission at the step boundary ---------------------------
        admitted: List[_Active] = []
        while pending and free_slots and pending[0].arrival <= t_now:
            r = pending[0]
            need = r.prompt_tokens + r.output_tokens
            if reserved > 0 and not pol.kv_offload \
                    and reserved + need > cap:
                break               # FIFO head blocks until KV frees up
            pending.pop(0)
            a = _Active(req=r, slot=free_slots.pop(),
                        chunks=_chunks(r.prompt_tokens, pol.prefill_chunk))
            reserved += need
            active.append(a)
            admitted.append(a)
        # --- un-chunked prefills stall the engine before the next gate
        gate_parents: List[Task] = [prev_gate] if prev_gate else []
        seen = {t.uid for t in gate_parents}
        for a in admitted:
            parents = [em.arrival[a.req.rid]]
            if pol.prefill_chunk <= 0:
                (_, n), = a.chunks
                dur = cost.prefill_time(n)
                if prev_gate is not None:
                    parents.append(prev_gate)   # after the running step
                a.last_work = em.prefill(a.req, n, dur, parents)
                a.chunks = []
                t_now += dur
            else:
                a.last_work = parents[0]    # first chunk rides the step
        decoding = [a for a in active if not a.chunks]
        chunking = [a for a in active if a.chunks]
        if not decoding and not chunking:   # safety: cannot happen, but
            if pending:                     # never spin without progress
                t_now = max(t_now, pending[0].arrival)
                continue
            break
        # --- one engine step ------------------------------------------
        for a in active:
            if a.last_work is not None and a.last_work.uid not in seen:
                gate_parents.append(a.last_work)
                seen.add(a.last_work.uid)
        gate = em.gate(f"step:s{step_idx}", gate_parents)
        kv = sum(a.req.prompt_tokens + min(a.emitted, a.req.output_tokens)
                 for a in decoding) \
            + sum(a.req.prompt_tokens - sum(n for _, n in a.chunks)
                  for a in chunking)
        step_dur = cost.decode_step_time(len(decoding), kv) if decoding \
            else 0.0
        step_work: List[Task] = []
        chunk_time = 0.0            # chunks serialize on the device lane
        for a in chunking:          # one prefill chunk rides this step
            ci, n = a.chunks.pop(0)
            dur = cost.prefill_time(n)
            a.last_work = em.prefill(a.req, n, dur, [gate], chunk=ci)
            step_work.append(a.last_work)
            chunk_time += dur
        toks: List[Task] = []
        for a in decoding:
            a.last_work = em.token(a.req, a.slot, a.emitted, step_dur, gate)
            a.emitted += 1
            toks.append(a.last_work)
            step_work.append(a.last_work)
        coll_t = 0.0
        if pol.tp_degree > 1 and step_work:
            coll_t = em.step_coll_time(max(len(toks), 1))
            step_work.append(em.collective(
                f"tp-ar:s{step_idx}",
                max(len(toks), 1) * cost.tp_coll_bytes_per_token,
                coll_t, list(step_work)))
        excess = max(0.0, reserved - cap) if pol.kv_offload else 0.0
        dma_t = 0.0
        if excess > 0:
            dma_t = cost.kv_offload_time(excess)
            step_work.append(em.dma(f"kv-dma:s{step_idx}", excess, dma_t,
                                    list(toks) or list(step_work)))
        if toks:
            em.num_steps += 1
        t_now += max(step_dur, chunk_time) + max(coll_t, dma_t)
        step_idx += 1
        prev_gate = gate
        # --- retire drained requests ----------------------------------
        done = [a for a in decoding if a.emitted >= a.req.output_tokens]
        for a in done:
            active.remove(a)
            free_slots.append(a.slot)
            reserved -= a.req.prompt_tokens + a.req.output_tokens
        free_slots.sort(reverse=True)
    return 1
