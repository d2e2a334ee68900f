"""The graphs of ``tests/synthgraphs.py``, built with ``repro_torch.core``.

Not a test module: the port's twins of the reference's trace and analysis
tests (``test_torch_traceio.py``, ``test_torch_analysis.py``,
``test_torch_calibrate.py``) build the same fixed topologies as the
reference's tests, task for task, without importing the JAX package.
"""

import random

from repro_torch.core import (DependencyGraph, Task, TaskKind, DEVICE_STREAM,
                              HOST_THREAD)


def training_step_graph(layers=6, fwd=2e-3, bwd=4e-3, upd=1e-3,
                        dispatch=20e-6):
    """A canonical single-worker step: host dispatch -> fwd chain -> bwd
    chain -> per-layer update -> host sync, with layer/phase tags so the
    DDP/P3/ZeRO what-ifs can bucket gradients."""
    g = DependencyGraph()
    h = g.add_task(Task("host:dispatch", TaskKind.HOST, HOST_THREAD, dispatch))
    first = True
    for i in range(layers):
        t = g.add_task(Task(f"fwd:l{i}", TaskKind.COMPUTE, DEVICE_STREAM, fwd,
                            layer=f"l{i}", phase="fwd", flops=2e9,
                            bytes_accessed=1e6))
        if first:
            g.add_edge(h, t)
            first = False
    for i in reversed(range(layers)):
        g.add_task(Task(f"bwd:l{i}", TaskKind.COMPUTE, DEVICE_STREAM, bwd,
                        layer=f"l{i}", phase="bwd", flops=4e9,
                        bytes_accessed=2e6))
    for i in range(layers):
        g.add_task(Task(f"upd:l{i}", TaskKind.COMPUTE, DEVICE_STREAM, upd,
                        layer=f"l{i}", phase="update", flops=1e8,
                        bytes_accessed=3e6))
    s = g.add_task(Task("host:sync", TaskKind.SYNC, HOST_THREAD, 1e-6))
    g.add_edge(g.lane_tasks(DEVICE_STREAM)[-1], s)
    return g


def random_dag(seed, n_tasks=40, threads=("device", "host", "ici:x", "ici:y"),
               edge_prob=0.08, lane_prob=0.8):
    """Seeded random DAG mixing lane-ordered and free-floating tasks."""
    rng = random.Random(seed)
    g = DependencyGraph()
    tasks = []
    for i in range(n_tasks):
        th = rng.choice(threads)
        t = Task(f"t{i}", TaskKind.COMPUTE, th,
                 duration=rng.uniform(0.01, 5.0), gap=rng.uniform(0.0, 1.0))
        t.attrs["priority"] = rng.randint(0, 9)
        g.add_task(t, link_lane=rng.random() < lane_prob)
        for p in tasks:
            if rng.random() < edge_prob:
                g.add_edge(p, t)
        tasks.append(t)
    return g
