"""Task -> layer mapping utilities (paper §4.3).

The mapping itself is synchronization-free by construction on this stack:
``jax.named_scope`` survives lowering into per-instruction HLO metadata and
:func:`repro_torch.core.hlo.split_op_name` turns it into (layer, phase) tags at parse
time.  This module provides the query side: grouping, per-layer rollups, and
the layer->bucket mapping used when injecting communication tasks (the paper's
gradient-bucketing instrumentation for PyTorch DDP, §4.2.1 "Communication").
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .graph import DependencyGraph
from .task import Task, TaskKind


@dataclasses.dataclass
class LayerProfile:
    layer: str
    duration_s: float = 0.0
    flops: float = 0.0
    bytes_accessed: float = 0.0
    tasks: int = 0
    phases: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))


class LayerMap:
    """Per-layer rollup over a dependency graph."""

    def __init__(self, graph: DependencyGraph) -> None:
        self.graph = graph
        self.profiles: Dict[str, LayerProfile] = {}
        for t in graph.tasks():
            key = t.layer or "<unmapped>"
            p = self.profiles.setdefault(key, LayerProfile(key))
            p.duration_s += t.duration
            p.flops += t.flops
            p.bytes_accessed += t.bytes_accessed
            p.tasks += 1
            if t.phase:
                p.phases[t.phase] += t.duration

    def layers(self) -> List[str]:
        return sorted(k for k in self.profiles if k != "<unmapped>")

    def mapped_fraction(self) -> float:
        total = sum(p.duration_s for p in self.profiles.values())
        unmapped = self.profiles.get("<unmapped>", LayerProfile("")).duration_s
        return 1.0 - (unmapped / total) if total > 0 else 0.0

    def tasks_for(self, layer_pattern: str) -> List[Task]:
        import re
        rx = re.compile(layer_pattern)
        return [t for t in self.graph.tasks()
                if t.layer is not None and rx.search(t.layer)]

    def phase_tasks(self, phase: str) -> List[Task]:
        return [t for t in self.graph.tasks() if t.phase == phase]

    def top_layers(self, n: int = 10) -> List[LayerProfile]:
        return sorted(self.profiles.values(), key=lambda p: -p.duration_s)[:n]


def bucket_layers(layer_grad_bytes: Dict[str, float],
                  bucket_bytes: float = 25 * 1024 * 1024,
                  reverse_order: Optional[Sequence[str]] = None,
                  ) -> List[Tuple[List[str], float]]:
    """Group per-layer gradients into communication buckets.

    Mirrors PyTorch DDP's 25MB gradient bucketing that the paper instruments
    (§4.2.1): gradients become ready in reverse layer order during the backward
    pass; consecutive ready gradients are coalesced until ``bucket_bytes``.
    Returns [(layers, payload_bytes), ...] in ready order.
    """
    order = list(reverse_order) if reverse_order is not None else (
        list(reversed(list(layer_grad_bytes))))
    buckets: List[Tuple[List[str], float]] = []
    cur: List[str] = []
    cur_bytes = 0.0
    for layer in order:
        b = layer_grad_bytes[layer]
        cur.append(layer)
        cur_bytes += b
        if cur_bytes >= bucket_bytes:
            buckets.append((cur, cur_bytes))
            cur, cur_bytes = [], 0.0
    if cur:
        buckets.append((cur, cur_bytes))
    return buckets
