"""torch.profiler (Kineto/CUPTI) events -> Daydream dependency graph.

This is the port's replacement for ``repro.core.hlo``: where the reference
reads a compiled XLA program, the port reads what the card really ran, as the
paper does on GPUs (§4.2-4.3).  The input is the ``traceEvents`` list of a
torch.profiler Chrome trace (``profile.export_chrome_trace``) taken with CPU
and CUDA activities and ``record_shapes=True``; only complete (``"ph": "X"``)
events are read, with times in microseconds.

Tasks (§4.2.1):

* every CUDA kernel, memcpy and memset record (``kernel``, ``gpu_memcpy``,
  ``gpu_memset``) is a ``device`` task with its measured duration, in
  timestamp order (all streams share the one ``device`` lane);
* every CUDA runtime or driver record (``cuda_runtime``, ``cuda_driver``:
  ``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync``,
  ``cudaStreamSynchronize``, ...) is a ``host`` task.  Records of all CPU
  threads share the one ``host`` lane in timestamp order: the autograd
  engine's thread runs the backward while the calling thread waits inside
  ``backward()``/``autograd.grad``, so the two never issue work at once.  A
  record nested in another record of its thread is part of the outer one.
  The untraced host time from a record's end to the start of the next record
  in the lane (Python, dispatch, allocator) is that record's ``gap`` (§4.2.1)
  -- except after a record that launched device work: Daydream's engine
  releases all of a task's children at its end plus its gap, so there that
  time is a ``host`` task of its own (``untraced host``, same layer and
  phase) after the launch, and the kernel is ready when its launch ends.

Edges (§4.2.2): host order and stream order (the lanes), launch -> kernel by
CUPTI correlation id, and device -> host at every synchronising call (a
record whose name contains ``Synchronize``): the call ends after the last
device task launched before it, and its duration becomes what it took after
that task had finished (the wait itself is the edge).

Launch-queue back-pressure gets the same treatment.  The host runs ahead of
the card until the CUDA driver's command buffer is full; the next launch then
blocks until the card has worked through enough of the queue.  CUPTI
records each such block as an ``overhead`` event named ``Command Buffer
Full`` (in the card's captures of the train step, inside launch records).
Each wait is released by the device task that ended last before the wait
ended: that task gets an edge to the host task whose captured span holds
the wait's end, and the host task's duration becomes what it took after
that task had finished.  The host lane then holds the host's own time, and
a what-if that shrinks the device moves the blocked launches up with it.  A
capture with no such event (a host that never waited) builds the graph it
built before.

Layer and phase (§4.3), from the ``record_function`` scopes around the
*launching* operator (the innermost ``cpu_op`` that encloses the runtime
record):

* ``layer`` is the innermost scope's name;
* ``phase`` is ``update`` under an ``update`` scope, ``bwd`` under an
  ``autograd::engine::evaluate_function`` ancestor, ``fwd`` otherwise;
* a backward op does not run inside its forward's scope, so it takes the
  layer of the forward operator with the same autograd ``Sequence number``
  as its outermost ``evaluate_function`` node (custom ``autograd.Function``s
  such as ``FlashAttentionFn`` carry one too).  The outermost, because a
  node's backward may run autograd again (``FlashAttentionFnBackward``
  differentiates a recompute; checkpointed chunks recompute their forward):
  those inner nodes were made on the backward's own thread, whose sequence
  numbers are a counter of their own.

``flops`` and ``bytes_accessed`` come from the launching operator, split
evenly over the device records it launched: FLOPs by the profiler's formula
for the matrix products (a ``flops`` argument where the trace has one),
bytes as its input tensors (``Input Dims``/``Input type``) plus an estimate
of its output: an in-place op (``add_``) writes its first input, a matrix
product writes its ``(M, N)`` result, any other op one tensor as large as its
largest input.

The route follows the device the step ran on, not the capture's content. On
``cuda`` a capture with no device record is an error (CUPTI traced nothing).
On ``cpu`` the graph is one of the operators themselves (the CPU is the
device): each operator that does the work (:func:`task_ops`) is a ``device``
task, costed from its own recorded shapes, with the untraced time to the
next one as its gap.  On both routes a task whose operator is a matrix
product carries ``attrs["opcode"] = "dot"``, as the reference's HLO graphs
tag theirs, so the AMP what-if classes it as the reference does.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .graph import DependencyGraph
from .task import DEVICE_STREAM, HOST_THREAD, Task, TaskKind

DEVICE_CATS = {"kernel": TaskKind.COMPUTE, "gpu_memcpy": TaskKind.MEMORY,
               "gpu_memset": TaskKind.MEMORY}
HOST_CATS = ("cuda_runtime", "cuda_driver")
OP_CATS = ("cpu_op", "user_annotation")
# CUPTI's record of a launch blocked on a full command buffer (Kineto's
# ``overhead`` category)
WAIT_CAT, WAIT_NAME = "overhead", "Command Buffer Full"
# a capture document's own entry (torch.profiler's export has no such key):
# ``issue_s``, the host seconds from the call to its return under the
# profiler
CAPTURE_KEY = "repro_torch"
ENGINE = "autograd::engine::evaluate_function"
UPDATE_SCOPE = "update"

_DTYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8,
                "long int": 8, "int": 4, "short int": 2, "signed char": 1,
                "unsigned char": 1, "bool": 1, "c10::complex<float>": 8,
                "c10::complex<double>": 16, "c10::Float8_e4m3fn": 1,
                "c10::Float8_e5m2": 1}
_MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
KERNEL_PREFIX = "repro_torch::"    # the kernels' meta operators (kernels/*.py)
# aten operators that move no data and compute nothing: views, allocations,
# metadata, and composites that are no-ops unless a child op does the work
NO_WORK = frozenset("aten::" + n for n in (
    "empty", "empty_like", "empty_strided", "empty_permuted", "new_empty",
    "new_empty_strided", "resize_", "as_strided", "as_strided_", "view",
    "_unsafe_view", "view_as", "reshape", "_reshape_alias", "expand",
    "expand_as", "broadcast_to", "t", "numpy_T", "mT", "transpose", "permute",
    "movedim", "swapaxes", "unsqueeze", "squeeze", "slice", "select",
    "narrow", "split", "split_with_sizes", "unsafe_split", "chunk", "unbind",
    "flatten", "unflatten", "diagonal", "unfold", "alias", "detach",
    "detach_", "lift_fresh", "resolve_conj", "resolve_neg", "real",
    "result_type", "to", "contiguous", "type_as", "size", "stride", "numel",
    "dim", "is_nonzero", "_has_compatible_shallow_copy_type",
    "_debug_has_internal_overlap", "set_", "record_stream"))
# aten operators that the card runs as one kernel but whose meta
# implementation calls other aten operators, each of which would be a task
# (the ssm family's softplus and its causal masks)
ONE_KERNEL = frozenset("aten::" + n for n in (
    "softplus", "softplus_backward", "triu"))


# ------------------------------------------------------------------ events
class _Event:
    """One complete event and its place in its thread's nesting."""

    __slots__ = ("e", "name", "cat", "tid", "ts", "end", "parent")

    def __init__(self, e: Dict[str, Any]) -> None:
        self.e = e
        self.name = str(e.get("name", "?"))
        self.cat = e.get("cat")
        self.tid = (e.get("pid"), e.get("tid"))
        self.ts = float(e["ts"])
        self.end = self.ts + float(e.get("dur", 0.0))
        self.parent: Optional["_Event"] = None

    @property
    def args(self) -> Dict[str, Any]:
        return self.e.get("args") or {}

    def ancestors(self):
        p = self.parent
        while p is not None:
            yield p
            p = p.parent


def _nest(events: Sequence[_Event]) -> None:
    """Set each host-side event's parent: the innermost event of its thread
    that is still open when it starts."""
    by_tid: Dict[Any, List[_Event]] = {}
    for ev in events:
        by_tid.setdefault(ev.tid, []).append(ev)
    for evs in by_tid.values():
        evs.sort(key=lambda ev: (ev.ts, -ev.end))
        stack: List[_Event] = []
        for ev in evs:
            while stack and stack[-1].end <= ev.ts:
                stack.pop()
            if stack:
                ev.parent = stack[-1]
            stack.append(ev)


def _tensor_bytes(args: Dict[str, Any]) -> List[float]:
    out = []
    for dims, typ in zip(args.get("Input Dims") or [], args.get("Input type") or []):
        size = _DTYPE_BYTES.get(typ)
        if size is None or not isinstance(dims, list):
            continue
        n = 1
        for d in dims:
            if not isinstance(d, int):
                break
            n *= d
        else:
            out.append(float(n * size))
    return out


def _matmul_mnk(name: str, dims: List[Any]) -> Optional[Tuple[int, int, int, int]]:
    """(batch, M, N, K) of a matrix product from its input dims."""
    try:
        if name == "aten::mm":
            (m, k), (_, n) = dims[0], dims[1]
            return 1, m, n, k
        if name == "aten::addmm":
            (m, k), (_, n) = dims[1], dims[2]
            return 1, m, n, k
        if name == "aten::bmm":
            (b, m, k), (_, _, n) = dims[0], dims[1]
            return b, m, n, k
        if name == "aten::baddbmm":
            (b, m, k), (_, _, n) = dims[1], dims[2]
            return b, m, n, k
    except (TypeError, ValueError, IndexError):
        return None
    return None


def op_cost(op: Optional[_Event]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one operator from its recorded input shapes."""
    if op is None:
        return 0.0, 0.0
    args = op.args
    ins = _tensor_bytes(args)
    dims = args.get("Input Dims") or []
    flops = float(args.get("flops", 0.0) or 0.0)
    mnk = _matmul_mnk(op.name, dims) if op.name in _MATMULS else None
    if mnk is not None:
        b, m, n, k = mnk
        flops = flops or 2.0 * b * m * n * k
        typ = (args.get("Input type") or ["float"])[-1]
        out = float(b * m * n * _DTYPE_BYTES.get(typ, 4))
    elif op.name.endswith("_") and not op.name.endswith("__"):
        out = ins[0] if ins else 0.0
    else:
        out = max(ins, default=0.0)
    return flops, sum(ins) + out


class _Context:
    """Layer and phase of a host-side event, from its ancestors."""

    def __init__(self, events: Sequence[_Event]) -> None:
        self.fwd_layer: Dict[int, str] = {}
        for ev in events:
            seq = ev.args.get("Sequence number")
            if ev.cat != "cpu_op" or seq is None or seq < 0:
                continue
            layer, phase, _ = self.of(ev)
            if phase == "fwd" and layer is not None:
                self.fwd_layer.setdefault(seq, layer)

    def of(self, ev: _Event) -> Tuple[Optional[str], str, Optional[_Event]]:
        """(layer, phase, launching operator) of ``ev`` (an operator counts
        as its own launching operator)."""
        scope = op = engine = None
        update = False
        chain = [ev] if ev.cat in OP_CATS else []
        for a in chain + list(ev.ancestors()):
            if a.cat == "user_annotation":
                scope = scope or a.name
                update = update or a.name == UPDATE_SCOPE
            elif a.cat == "cpu_op":
                op = op or a
                if a.name.startswith(ENGINE):
                    engine = a          # the outermost: a node of the step's graph
        if update:
            phase = "update"
        elif engine is not None:
            phase = "bwd"
        else:
            phase = "fwd"
        layer = scope
        if phase == "bwd":
            seq = engine.args.get("Sequence number")
            layer = self.fwd_layer.get(seq, layer)
        return layer, phase, op


def _is_work(ev: _Event) -> bool:
    return (ev.cat == "cpu_op" and ev.name.startswith(("aten::", KERNEL_PREFIX))
            and ev.name not in NO_WORK)


def task_ops(host_side: Sequence[_Event]) -> List[_Event]:
    """The operators that are tasks when operators are the device's work,
    in program order: each ``aten::`` operator (or kernel meta operator)
    that does work and has no such operator below it -- except that an
    atomic operator is one task with whatever it calls: a matrix product, a
    kernel's meta operator, an operator whose implementation is a
    decomposition into ``prims::`` (on meta tensors a bf16 ``mul`` casts
    its inputs to f32 with ``copy_`` calls around ``prims::mul``, where the
    card runs one kernel), and the operators in ``ONE_KERNEL``.  Views,
    allocations and autograd's own nodes are none (``NO_WORK``)."""
    ops = [ev for ev in host_side if ev.cat == "cpu_op"]
    atomic = {id(ev) for ev in ops
              if ev.name in _MATMULS or ev.name in ONE_KERNEL
              or ev.name.startswith(KERNEL_PREFIX)}
    for ev in ops:
        if ev.name.startswith("prims::"):
            owner = next((a for a in ev.ancestors() if a.cat == "cpu_op"
                          and a.name.startswith("aten::")), None)
            if owner is not None:
                atomic.add(id(owner))
    has_work_below, under_atomic = set(), set()
    for ev in ops:
        above = [a for a in ev.ancestors() if a.cat == "cpu_op"]
        if any(id(a) in atomic for a in above):
            under_atomic.add(id(ev))
        if _is_work(ev):
            has_work_below.update(id(a) for a in above)
    return sorted((ev for ev in ops if _is_work(ev) and id(ev) not in under_atomic
                   and (id(ev) in atomic or id(ev) not in has_work_below)),
                  key=lambda ev: (ev.ts, -ev.end))


def _opcode(op: Optional[_Event]) -> Dict[str, str]:
    return {"opcode": "dot"} if op is not None and op.name in _MATMULS else {}


# ------------------------------------------------------------------- graph
def graph_from_events(events: Sequence[Dict[str, Any]],
                      device: str = "cuda") -> DependencyGraph:
    """Build the dependency graph of a step that ran on ``device`` (``cuda``
    or ``cpu``) from its torch.profiler trace events."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    complete = [_Event(e) for e in events
                if e.get("ph") == "X" and "ts" in e]
    host_side = [ev for ev in complete if ev.cat in OP_CATS or ev.cat in HOST_CATS]
    _nest(host_side)
    ctx = _Context(host_side)
    if device == "cpu":
        return _cpu_graph(host_side, ctx)
    records = sorted((ev for ev in complete if ev.cat in DEVICE_CATS),
                     key=lambda ev: ev.ts)
    if not records:
        raise ValueError("a CUDA capture with no kernel, memcpy or memset "
                         "record: CUPTI traced nothing on the card")
    waits = sorted(ev.end for ev in complete
                   if ev.cat == WAIT_CAT and ev.name == WAIT_NAME)
    return _cuda_graph(host_side, records, ctx, waits)


def _sec(us: float) -> float:
    return us * 1e-6


def _cuda_graph(host_side: List[_Event], device: List[_Event],
                ctx: _Context, waits: Sequence[float]) -> DependencyGraph:
    """``waits`` are the end times of the capture's command-buffer waits."""
    g = DependencyGraph()
    records = sorted((ev for ev in host_side if ev.cat in HOST_CATS),
                     key=lambda ev: (ev.ts, -ev.end))
    top: List[_Event] = []
    owner: Dict[Any, _Event] = {}          # correlation id -> top-level record
    for ev in records:
        outer = None
        for a in ev.ancestors():
            if a.cat in HOST_CATS:
                outer = a
        if outer is None:
            top.append(ev)
        owner[ev.args.get("correlation")] = outer or ev
    info = {id(ev): ctx.of(ev) for ev in top}     # (layer, phase, launching op)

    # each launching op's FLOPs and bytes are split over the records it launched
    launched_by: Dict[int, List[_Event]] = {}
    per_op: Dict[int, int] = {}
    for dv in device:
        rec = owner.get(dv.args.get("correlation"))
        if rec is not None:
            launched_by.setdefault(id(rec), []).append(dv)
            op = info[id(rec)][2]
            per_op[id(op)] = per_op.get(id(op), 0) + 1

    # the host lane's captured spans in order: (start, end, task, position of
    # its record in ``top``, whether it is the record itself); a wait is
    # charged to the span that holds its end
    spans: List[Tuple[float, float, Task, int, bool]] = []
    host_tasks: Dict[int, Task] = {}
    for i, ev in enumerate(top):
        layer, phase, op = info[id(ev)]
        nxt = top[i + 1].ts if i + 1 < len(top) else ev.end
        gap = _sec(max(0.0, nxt - ev.end))
        # the untraced time after a launch (or one that holds a wait's end)
        # is a host task of its own, not the record's gap
        k = bisect.bisect_right(waits, ev.end)
        own = id(ev) in launched_by or (k < len(waits) and waits[k] <= nxt)
        sync = "Synchronize" in ev.name
        t = Task(name=ev.name, kind=TaskKind.SYNC if sync else TaskKind.HOST,
                 thread=HOST_THREAD, duration=_sec(ev.end - ev.ts),
                 gap=0.0 if own else gap, layer=layer, phase=phase,
                 attrs={"op": op.name if op else None,
                        "correlation": ev.args.get("correlation")})
        host_tasks[id(ev)] = g.add_task(t)
        spans.append((ev.ts, ev.end, t, i, True))
        if own and gap > 0:
            u = g.add_task(Task(name="untraced host", kind=TaskKind.HOST,
                                thread=HOST_THREAD, duration=gap, layer=layer,
                                phase=phase, attrs={"op": None, "correlation": None}))
            spans.append((ev.end, nxt, u, i, False))

    dev_tasks: Dict[int, Task] = {}
    for dv in device:
        rec = owner.get(dv.args.get("correlation"))
        layer, phase, op = info[id(rec)] if rec is not None else (None, "fwd", None)
        flops, nbytes = op_cost(op)
        share = per_op.get(id(op), 1)
        t = Task(name=dv.name, kind=DEVICE_CATS[dv.cat], thread=DEVICE_STREAM,
                 duration=_sec(dv.end - dv.ts), layer=layer, phase=phase,
                 flops=flops / share, bytes_accessed=nbytes / share,
                 attrs={"op": op.name if op else None,
                        "stream": dv.args.get("stream"),
                        "correlation": dv.args.get("correlation"),
                        **_opcode(op)})
        dev_tasks[id(dv)] = g.add_task(t)
        if rec is not None:
            g.add_edge(host_tasks[id(rec)], t)

    if waits:
        _release_waits(g, spans, device, dev_tasks, owner, top, waits)

    # device -> host: a synchronising call waits for every earlier launch
    last: Optional[_Event] = None
    for ev in top:
        if "Synchronize" in ev.name and last is not None:
            t = host_tasks[id(ev)]
            g.add_edge(dev_tasks[id(last)], t)
            t.duration = _sec(max(0.0, ev.end - max(ev.ts, last.end)))
        for dv in launched_by.get(id(ev), ()):
            if last is None or dv.ts > last.ts:
                last = dv
    return g


def scale_host_lane(graph: DependencyGraph, scale: float) -> DependencyGraph:
    """``graph`` with every host-lane task's duration and gap times
    ``scale``, in place (and returned): the profiler's slowing of the host
    taken out by ``trace.trace_measured``'s ``host_scale`` (a calibration
    on the traced step's own host time, ROADMAP C5)."""
    if scale != 1.0:
        for t in graph.lane_tasks(HOST_THREAD):
            t.duration *= scale
            t.gap *= scale
    return graph


def _release_waits(g: DependencyGraph, spans, device: List[_Event],
                   dev_tasks: Dict[int, Task], owner: Dict[Any, _Event],
                   top: List[_Event], waits: Sequence[float]) -> None:
    """device -> host at each command-buffer wait: the device task that
    ended last before the wait ended releases the host task whose span holds
    that end, which keeps only the time it took after the release.  A device
    task cannot release the record that launched it, nor anything before."""
    by_end = sorted(device, key=lambda dv: dv.end)
    ends = [dv.end for dv in by_end]
    pos = {id(ev): i for i, ev in enumerate(top)}
    starts = [sp[0] for sp in spans]
    release: Dict[int, _Event] = {}         # span index -> releasing record
    for w in waits:
        s = bisect.bisect_right(starts, w) - 1
        d = bisect.bisect_right(ends, w) - 1
        if s < 0 or d < 0 or w > spans[s][1]:
            continue
        dv = by_end[d]
        rec = owner.get(dv.args.get("correlation"))
        _, _, t, i, record = spans[s]
        if rec is not None and (pos[id(rec)] > i or (pos[id(rec)] == i and record)):
            continue
        if s not in release or dv.end > release[s].end:
            release[s] = dv
    for s, dv in release.items():
        start, end, t, _, _ = spans[s]
        g.add_edge(dev_tasks[id(dv)], t)
        t.duration = _sec(max(0.0, end - max(start, dv.end)))


def _cpu_graph(host_side: List[_Event], ctx: _Context) -> DependencyGraph:
    g = DependencyGraph()
    ops = task_ops(host_side)
    for i, ev in enumerate(ops):
        layer, phase, _ = ctx.of(ev)
        flops, nbytes = op_cost(ev)
        nxt = ops[i + 1].ts if i + 1 < len(ops) else ev.end
        g.add_task(Task(name=ev.name, kind=TaskKind.COMPUTE, thread=DEVICE_STREAM,
                        duration=_sec(ev.end - ev.ts),
                        gap=_sec(max(0.0, nxt - ev.end)), layer=layer,
                        phase=phase, flops=flops, bytes_accessed=nbytes,
                        attrs={"op": ev.name, **_opcode(ev)}))
    return g
