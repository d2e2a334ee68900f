"""Calibration on the local device (counterpart of ``repro/core/calibrate.py``).

Measures the device's effective matrix-product FLOP/s, element-wise memory
rate and the host's round trip for one launch of a no-op, plus the
(multi-GPU) collective bandwidth, producing a
:class:`repro_torch.core.costmodel.CostModel` whose analytical durations are
in the device's own wall-clock units.  The data-sheet constants
(``H100_SXM``) stay as they are: calibration is for checking the analytical
route against a measured step.

Every function takes ``device`` (default ``"cuda"``, which raises without
CUDA; the tests pass ``"cpu"``).  Each time is the median of 5 calls after
2 warm-up calls, each call ending in ``torch.cuda.synchronize`` (the
counterpart of ``jax.block_until_ready``).  At the reference's defaults
(1024², float32) a card finishes the matrix product and the element-wise
pass in tens of microseconds, so those readings include the host's launch
and sync; pass a size that fills the card (e.g. 8192, ``"bfloat16"``) to
read the card's own rates.  ``torch.matmul`` is what is measured here, not a
kernel of the port; float32 products run on the CUDA cores unless the caller
enabled TF32.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from .costmodel import CollectiveModel, CostModel, MeshTopology
from .task import HardwareSpec


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":          # every card: a collective spans several
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _time(fn, *args, iters: int = 5, warmup: int = 2, device="cuda") -> float:
    """Median seconds per call of ``fn(*args)``, each call ending in a sync."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn(*args)
        _sync(dev)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def measure_local_backend(size: int = 1024, dtype_str: str = "float32",
                          device="cuda") -> Dict[str, float]:
    """Measure matmul FLOP/s and elementwise bytes/s on ``device``."""
    return _measure_local_backend(size, dtype_str, str(resolve_device(device)))


@functools.lru_cache(maxsize=4)
def _measure_local_backend(size: int, dtype_str: str, device: str
                           ) -> Dict[str, float]:
    dev = torch.device(device)
    dtype = getattr(torch, dtype_str)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((size, size), generator=gen, device=dev, dtype=dtype)
    b = torch.randn((size, size), generator=gen, device=dev, dtype=dtype)

    t_mm = _time(torch.matmul, a, b, device=dev)
    flops = 2.0 * size ** 3
    flops_per_s = flops / max(t_mm, 1e-9)

    big = torch.randn((size * size * 8,), generator=gen, device=dev, dtype=dtype)
    # one read and one write per element, the traffic of the reference's
    # fused x * 1.0001 + 0.5: eager torch would run its + 0.5 as a second
    # pass, and a scalar held in a tensor keeps the kernel from vectorising
    t_ew = _time(torch.mul, big, 1.0001, device=dev)
    traffic = 2.0 * big.numel() * big.element_size()
    bytes_per_s = traffic / max(t_ew, 1e-9)

    one = torch.ones((), dtype=dtype, device=dev)
    return {
        "matmul_flops_per_s": flops_per_s,
        "elementwise_bytes_per_s": bytes_per_s,
        "op_overhead_s": max(_time(lambda x: x + 1, one, device=dev), 1e-7),
    }


def _devices(num_devices: Optional[int], device) -> tuple:
    dev = resolve_device(device)
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = num_devices or have
    if n > have:
        raise ValueError(f"{n} devices asked for, {have} {dev.type} device(s) here")
    return dev, n


def _all_reduce(n: int, elems: int):
    """A sum over ``n`` CUDA devices, replicated on every one of them (the
    reference's jitted ``sum`` with a replicated output)."""
    xs = [torch.ones(elems, dtype=torch.float32, device=f"cuda:{i}")
          for i in range(n)]

    def run():
        total = torch.cuda.comm.reduce_add(xs, destination=0)
        return torch.cuda.comm.broadcast(total, list(range(n)))
    return run


def measure_collective_bandwidth(num_devices: Optional[int] = None,
                                 payload_mb: int = 8, device="cuda") -> float:
    """All-reduce bus bandwidth across the local devices (bytes/s per device)."""
    dev, n = _devices(num_devices, device)
    if n < 2:
        return 8e9
    elems = payload_mb * 1024 * 1024 // 4
    t = _time(_all_reduce(n, elems), device=dev)
    payload = elems * 4
    # ring all-reduce equivalent: 2*(n-1)/n * payload / bw = t
    return 2 * (n - 1) / n * payload / max(t, 1e-9)


def hop_latency_from_measurement(t_small: float, payload_bytes: float,
                                 num_devices: int, bandwidth: float) -> float:
    """Per-ring-step latency implied by one tiny-payload all-reduce time.

    The ring model (``CollectiveModel.axis_time``) predicts
    ``t = 2*(n-1)/n * payload/bw + 2*(n-1)*hop``; a tiny payload makes the
    latency term dominant, so subtracting the measured-bandwidth transfer
    term and dividing by the hop count recovers ``hop`` — the collective
    analogue of deriving ``op_overhead`` from a measured no-op dispatch.
    Degenerate inputs (n < 2, negative residual from noise) fall back to the
    analytical default.
    """
    if num_devices < 2 or t_small <= 0:
        return CollectiveModel.HOP_LATENCY
    transfer = 2 * (num_devices - 1) / num_devices * payload_bytes \
        / max(bandwidth, 1e-9)
    hop = (t_small - transfer) / (2 * (num_devices - 1))
    return hop if hop > 0 else CollectiveModel.HOP_LATENCY


def measure_collective_hop_latency(num_devices: Optional[int] = None,
                                   payload_kb: int = 4,
                                   bandwidth: Optional[float] = None,
                                   device="cuda") -> float:
    """Measured per-ring-step latency of the local devices' collectives.

    Times a tiny (``payload_kb``) all-reduce — latency-dominated — and
    solves the ring formula for the per-hop term
    (:func:`hop_latency_from_measurement`), so cluster ring legs land in
    local wall-clock units, as compute durations do.  One device returns the
    analytical default.
    """
    dev, n = _devices(num_devices, device)
    if n < 2:
        return CollectiveModel.HOP_LATENCY
    bw = bandwidth if bandwidth is not None \
        else measure_collective_bandwidth(n, device=dev)
    elems = max(payload_kb * 1024 // 4, 1)
    t_small = _time(_all_reduce(n, elems), device=dev)
    return hop_latency_from_measurement(t_small, elems * 4, n, bw)


def calibrated_cost_model(num_devices: int = 1, device="cuda", *,
                          size: int = 1024, dtype_str: str = "float32"
                          ) -> CostModel:
    """CostModel whose constants are the *local* device's measured rates
    (``measure_local_backend(size, dtype_str, device)``); the hardware spec
    is named ``local-<device type>``."""
    dev = resolve_device(device)
    m = measure_local_backend(size, dtype_str, device=dev)
    if num_devices > 1:
        coll_bw = measure_collective_bandwidth(num_devices, device=dev)
        hop = measure_collective_hop_latency(num_devices, bandwidth=coll_bw,
                                             device=dev)
    else:
        coll_bw, hop = 8e9, CollectiveModel.HOP_LATENCY
    hw = HardwareSpec(
        name=f"local-{dev.type}",
        peak_flops=m["matmul_flops_per_s"],
        hbm_bandwidth=m["elementwise_bytes_per_s"],
        ici_bandwidth=coll_bw,
        dcn_bandwidth=8e9,
        op_overhead=m["op_overhead_s"] * 0.25,
        host_dispatch=m["op_overhead_s"],
    )
    topo = MeshTopology({"data": num_devices}, {"data": "ici"})
    return CostModel(hw=hw, topo=topo, hop_latency=hop)
