"""The analytical trace route: a step run on meta tensors -> dependency graph.

The port's counterpart of ``repro.core.hlo``'s ``extract_graph`` and
``aggregate_costs``.  Where the reference compiles the step and reads the
HLO program, the port runs the step once on ``meta`` tensors (shapes and
dtypes, no storage, nothing computed) under torch.profiler and reads the
operators it dispatched (:func:`repro_torch.core.trace.trace_compiled`).  No
card is needed, so a what-if can be asked of a step that was never run.

Tasks: one ``device`` task per operator that does work, in program order
(:func:`repro_torch.core.kineto.task_ops`: views, reshapes, allocations and
autograd's own nodes are none, as ``_CostVisitor.classify`` returns ``None``
for the reference's bookkeeping ops).  Each is priced by its own recorded
shapes:

* a kernel's meta operator (``repro_torch::flash_attention``, ``::rmsnorm``,
  ``::fused_adam``, ``::dgc_mask``; see ``kernels/ops.py``) is one task for
  the one launch the card would make, with that kernel's FLOPs and bytes
  (``kernels/cost.py``);
* a matrix product (``aten::mm``/``addmm``/``bmm``/``baddbmm``) has
  2·M·N·K FLOPs and is tagged ``attrs["opcode"] = "dot"``, as HLO graphs tag
  theirs, so the AMP what-if classes it as the reference does;
* a copy, gather, scatter (the MoE layer's dispatch and combine),
  concatenation or fill (``MEMORY_OPS``) is a ``MEMORY`` task that moves
  bytes only;
* any other operator is ``COMPUTE`` with one FLOP per element of its
  largest input.

Bytes are its inputs plus an estimate of its output (``kineto.op_cost``).
The duration is ``CostModel.compute_time(flops, bytes)``.  ``layer`` and
``phase`` come from the model's ``record_function`` scopes and autograd's
sequence numbers, exactly as on the measured route (``kineto._Context``).  A
``host:dispatch`` task precedes the step and a ``host:sync`` task follows
its last device task, as in the reference's graphs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.kernels import cost as kernel_cost
from .costmodel import CostModel
from .graph import DependencyGraph
from .kineto import (OP_CATS, KERNEL_PREFIX, _DTYPE_BYTES, _MATMULS, _Context,
                     _Event, _nest, op_cost, task_ops)
from .task import DEVICE_STREAM, HOST_THREAD, Task, TaskKind

MEMORY_OPS = frozenset("aten::" + n for n in (
    "copy_", "_to_copy", "clone", "cat", "stack", "index_select", "embedding",
    "gather", "scatter", "scatter_", "scatter_add", "scatter_add_", "index",
    "index_put", "index_put_", "_index_put_impl_", "index_add", "index_add_",
    "fill_", "zero_", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "new_zeros", "new_ones", "new_full", "arange",
    "scalar_tensor", "repeat", "slice_scatter", "select_scatter",
    "constant_pad_nd", "flip", "roll"))


def _dims(op: _Event) -> List[Any]:
    return op.args.get("Input Dims") or []


def _itemsize(op: _Event, i: int = 0) -> int:
    types = op.args.get("Input type") or []
    return _DTYPE_BYTES.get(types[i], 4) if i < len(types) else 4


def _numel(dims) -> int:
    return math.prod(dims) if isinstance(dims, list) else 0


def _kernel_cost(op: _Event) -> Tuple[float, float]:
    """(FLOPs, bytes) of the launch a kernel's meta operator stands for."""
    name, dims = op.name[len(KERNEL_PREFIX):], _dims(op)
    if name == "flash_attention":
        (B, H, S, D), KH, Dv = dims[0], dims[1][1], dims[2][3]
        concrete = list(op.args.get("Concrete Inputs") or []) + [""] * 5
        causal = str(concrete[3]) != "False"
        window = int(concrete[4]) if str(concrete[4]).isdigit() else 0
        return kernel_cost.flash_attention(B, H, KH, S, D, D_v=Dv, causal=causal,
                                           window=window, itemsize=_itemsize(op))
    if name == "rmsnorm":
        x = dims[0]
        return kernel_cost.rmsnorm(_numel(x[:-1]), x[-1], itemsize=_itemsize(op),
                                   w_itemsize=_itemsize(op, 1))
    if name == "fused_adam":
        return kernel_cost.fused_adam(_numel(dims[0]))
    if name == "dgc_mask":
        return kernel_cost.dgc_mask(_numel(dims[0]), itemsize=_itemsize(op))
    raise ValueError(f"no cost for the kernel operator {op.name!r}")


def classify(op: _Event) -> Tuple[TaskKind, float, float, Dict[str, str]]:
    """(kind, FLOPs, bytes, attrs) of one task operator."""
    if op.name.startswith(KERNEL_PREFIX):
        flops, nbytes = _kernel_cost(op)
        return TaskKind.COMPUTE, flops, nbytes, {"kernel": op.name[len(KERNEL_PREFIX):]}
    flops, nbytes = op_cost(op)
    if op.name in _MATMULS:
        return TaskKind.COMPUTE, flops, nbytes, {"opcode": "dot"}
    if op.name in MEMORY_OPS:
        return TaskKind.MEMORY, 0.0, nbytes, {}
    elems = max((_numel(d) for d in _dims(op)), default=0)
    return TaskKind.COMPUTE, float(elems), nbytes, {}


def graph_from_meta_events(events: Sequence[Dict[str, Any]],
                           cost: Optional[CostModel] = None,
                           max_tasks: int = 60_000
                           ) -> Tuple[DependencyGraph, Dict[str, float]]:
    """(graph, aggregates) of a step captured on meta tensors.

    The graph holds at most ``max_tasks`` device tasks, the first in program
    order, as the reference's ``extract_graph`` stops emitting at its
    budget; the aggregates count every operator, as ``aggregate_costs``
    does, with the reference's keys (no collectives on one card)."""
    cost = cost or CostModel()
    host_side = [_Event(e) for e in events if e.get("ph") == "X" and "ts" in e
                 and e.get("cat") in OP_CATS]
    _nest(host_side)
    ctx = _Context(host_side)
    agg = {"flops": 0.0, "bytes": 0.0, "collective_bytes": 0.0,
           "collective_s": 0.0, "compute_ops": 0.0, "memory_ops": 0.0,
           "collective_ops": 0.0, "device_time_s": 0.0}
    g = DependencyGraph()
    dispatch = g.add_task(Task(name="host:dispatch", kind=TaskKind.HOST,
                               thread=HOST_THREAD,
                               duration=cost.host_dispatch_time()))
    last: Optional[Task] = None
    emitted = 0
    for op in task_ops(host_side):
        kind, flops, nbytes, attrs = classify(op)
        duration = cost.compute_time(flops, nbytes)
        agg["flops"] += flops
        agg["bytes"] += nbytes
        agg["device_time_s"] += duration
        agg["compute_ops" if kind == TaskKind.COMPUTE else "memory_ops"] += 1
        if emitted >= max_tasks:
            continue
        emitted += 1
        layer, phase, _ = ctx.of(op)
        t = g.add_task(Task(name=op.name, kind=kind, thread=DEVICE_STREAM,
                            duration=duration, flops=flops,
                            bytes_accessed=nbytes, layer=layer, phase=phase,
                            attrs={"op": op.name, **attrs}))
        if last is None:
            g.add_edge(dispatch, t)
        last = t
    sync = g.add_task(Task(name="host:sync", kind=TaskKind.SYNC,
                           thread=HOST_THREAD, duration=1e-6))
    if last is not None:
        g.add_edge(last, sync)
    return g, agg
