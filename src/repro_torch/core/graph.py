"""Dependency graph construction (paper §4.2).

The graph is a DAG over :class:`repro_torch.core.task.Task` nodes.  Edges come from the
paper's five dependency types, re-grounded for the XLA/TPU stack (DESIGN.md §2):

  1. host-thread program order          (paper: CPU same-thread order)
  2. device-stream program order        (paper: same-CUDA-stream order)
  3. dispatch: host enqueue -> device   (paper: cudaLaunchKernel correlation)
  4. synchronization: device -> host    (paper: cudaDeviceSynchronize etc.)
  5. communication: grad-ready -> collective -> consumer (wait-free backprop)

Program-order edges (types 1 and 2) are implied by thread membership and are
added explicitly between consecutive same-thread tasks at build time so that the
simulator and the transformation primitives can treat all dependencies uniformly
while insert/remove only needs local splicing (paper Fig. 4).
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .task import Task, TaskKind


class GraphError(RuntimeError):
    pass


class DependencyGraph:
    """Mutable task DAG with thread-ordered lanes.

    Nodes are Tasks (uid-keyed); edges are stored as adjacency sets.  Same-thread
    program order is maintained as per-thread ordered lists (``lanes``), which is
    what makes insert/remove constant-time local operations, mirroring the
    paper's "appending a node to a linked list" description (§4.4).
    """

    def __init__(self) -> None:
        self._tasks: Dict[int, Task] = {}
        self._children: Dict[int, Set[int]] = collections.defaultdict(set)
        self._parents: Dict[int, Set[int]] = collections.defaultdict(set)
        self.lanes: Dict[str, List[int]] = collections.defaultdict(list)
        self._next_uid = 0

    # ------------------------------------------------------------------ nodes
    def add_task(self, task: Task, *, after: Optional[Task] = None,
                 link_lane: bool = True) -> Task:
        """Add ``task`` to its thread lane.

        If ``after`` is given the task is spliced into the lane right after it
        (program-order edges re-wired); otherwise it is appended to the lane
        tail.  ``link_lane=False`` adds the node without program-order edges
        (used while bulk-loading traces that add edges separately).
        """
        task.uid = self._next_uid
        self._next_uid += 1
        self._tasks[task.uid] = task
        lane = self.lanes[task.thread]
        if not link_lane:
            lane.append(task.uid)
            return task
        if after is None:
            if lane:
                self.add_edge(self._tasks[lane[-1]], task)
            lane.append(task.uid)
        else:
            if after.thread != task.thread:
                raise GraphError(
                    f"cannot splice {task.name} after {after.name}: different threads")
            idx = lane.index(after.uid)
            nxt = lane[idx + 1] if idx + 1 < len(lane) else None
            if nxt is not None:
                self.remove_edge(after, self._tasks[nxt])
                self.add_edge(task, self._tasks[nxt])
            self.add_edge(after, task)
            lane.insert(idx + 1, task.uid)
        return task

    def remove_task(self, task: Task, *, bridge: bool = True) -> None:
        """Remove a task (paper Fig. 4).

        With ``bridge=True`` (default) every parent is connected to every child
        so downstream work keeps its transitive dependencies — this is what
        "removing a kernel" means in the paper's fusion what-ifs.
        """
        uid = task.uid
        if uid not in self._tasks:
            raise GraphError(f"task {task} not in graph")
        parents = list(self._parents[uid])
        children = list(self._children[uid])
        if bridge:
            for p in parents:
                for c in children:
                    if p != c:
                        self._children[p].add(c)
                        self._parents[c].add(p)
        for p in parents:
            self._children[p].discard(uid)
        for c in children:
            self._parents[c].discard(uid)
        del self._parents[uid]
        del self._children[uid]
        lane = self.lanes[task.thread]
        lane.remove(uid)
        del self._tasks[uid]

    # ------------------------------------------------------------------ edges
    def add_edge(self, src: Task, dst: Task) -> None:
        if src.uid == dst.uid:
            raise GraphError(f"self-edge on {src}")
        self._children[src.uid].add(dst.uid)
        self._parents[dst.uid].add(src.uid)

    def remove_edge(self, src: Task, dst: Task) -> None:
        self._children[src.uid].discard(dst.uid)
        self._parents[dst.uid].discard(src.uid)

    # ------------------------------------------------------------ accessors
    def tasks(self) -> List[Task]:
        return list(self._tasks.values())

    def __len__(self) -> int:
        return len(self._tasks)

    def __contains__(self, task: Task) -> bool:
        return task.uid in self._tasks

    def get(self, uid: int) -> Task:
        return self._tasks[uid]

    def children(self, task: Task) -> List[Task]:
        return [self._tasks[c] for c in self._children[task.uid]]

    def parents(self, task: Task) -> List[Task]:
        return [self._tasks[p] for p in self._parents[task.uid]]

    def lane_tasks(self, thread: str) -> List[Task]:
        return [self._tasks[u] for u in self.lanes.get(thread, [])]

    def threads(self) -> List[str]:
        return [t for t, lane in self.lanes.items() if lane]

    def select(self, pred: Callable[[Task], bool]) -> List[Task]:
        """The paper's Select primitive (§4.4)."""
        return [t for t in self._tasks.values() if pred(t)]

    # -------------------------------------------------------------- analysis
    def toposort(self) -> List[Task]:
        indeg = {u: len(self._parents[u]) for u in self._tasks}
        queue = collections.deque(u for u, d in indeg.items() if d == 0)
        order: List[Task] = []
        while queue:
            u = queue.popleft()
            order.append(self._tasks[u])
            for c in self._children[u]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    queue.append(c)
        if len(order) != len(self._tasks):
            raise GraphError("dependency graph contains a cycle")
        return order

    def validate(self) -> None:
        """Invariants: acyclic; lanes consistent; edge symmetry."""
        self.toposort()
        for thread, lane in self.lanes.items():
            for uid in lane:
                t = self._tasks.get(uid)
                if t is None or t.thread != thread:
                    raise GraphError(f"lane {thread} references bad task {uid}")
        for u, cs in self._children.items():
            for c in cs:
                if u not in self._parents[c]:
                    raise GraphError(f"asymmetric edge {u}->{c}")

    def critical_path(self) -> float:
        """Longest duration(+gap) path — lower bound on any simulated makespan."""
        finish: Dict[int, float] = {}
        for t in self.toposort():
            start = max((finish[p.uid] for p in self.parents(t)), default=0.0)
            finish[t.uid] = start + t.duration + t.gap
        return max(finish.values(), default=0.0)

    def total_work(self) -> float:
        return sum(t.duration + t.gap for t in self._tasks.values())

    def copy(self) -> "DependencyGraph":
        g = DependencyGraph()
        remap: Dict[int, Task] = {}
        for thread, lane in self.lanes.items():
            for uid in lane:
                nt = self._tasks[uid].clone()
                g.add_task(nt, link_lane=False)
                remap[uid] = nt
        for u, cs in self._children.items():
            for c in cs:
                g.add_edge(remap[u], remap[c])
        return g

    def stats(self) -> Dict[str, float]:
        by_kind: Dict[str, float] = collections.defaultdict(float)
        for t in self._tasks.values():
            by_kind[t.kind.value] += t.duration
        return {
            "num_tasks": float(len(self._tasks)),
            "num_edges": float(sum(len(c) for c in self._children.values())),
            "critical_path_s": self.critical_path(),
            "total_work_s": self.total_work(),
            **{f"dur_{k}_s": v for k, v in sorted(by_kind.items())},
        }
