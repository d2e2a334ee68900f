"""Task and resource model for Daydream's kernel-granularity dependency graph.

Paper mapping (Daydream §4.2.1): tasks are GPU kernels / CPU calls / data loading /
communication primitives, each bound to an *execution thread* (CPU process, GPU
stream, or communication channel).  On the TPU/JAX side the resources are:

  - ``host``        : the host Python/runtime thread that feeds steps (CPU tasks)
  - ``device``      : the TPU core's compute stream (one XLA program executes
                      HLO ops in schedule order — the analogue of a CUDA stream)
  - ``ici:<axis>``  : one communication channel per mesh axis (collectives)
  - ``dma``         : HBM<->host DMA engine (offload / infeed / outfeed copies)
  - ``data``        : the data-loading pipeline thread

Every task carries a ``gap`` — Daydream's mechanism (§4.2.1 "Gap") for the
untraced runtime between consecutive tasks on the same thread — and an optional
``layer`` tag produced by the task->layer mapping (§4.3).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple


class TaskKind(enum.Enum):
    """Coarse task taxonomy used by selection predicates and what-ifs."""

    COMPUTE = "compute"            # dots / convolutions / fusions on the device stream
    MEMORY = "memory"              # copies, transposes, dynamic-update-slice, bitcasts
    COLLECTIVE = "collective"      # all-reduce / all-gather / reduce-scatter / all-to-all / permute
    COMM = "comm"                  # point-to-point send/recv legs (pipeline hops, ppermute)
    HOST = "host"                  # host-side dispatch, callbacks, optimizer driver logic
    DATA = "data"                  # data loading (one task per micro/mini-batch)
    SYNC = "sync"                  # device->host completion events / blocking copies
    OFFLOAD = "offload"            # HBM<->host DMA traffic (vDNN-style what-ifs insert these)


# Resource (execution-thread) name constants.
HOST_THREAD = "host"
DEVICE_STREAM = "device"
DATA_THREAD = "data"
DMA_CHANNEL = "dma"


def ici_channel(axis: str) -> str:
    """Communication channel resource for a mesh axis (e.g. ``ici:data``)."""
    return f"ici:{axis}"


def p2p_channel(dst: int) -> str:
    """Channel resource of the point-to-point link *towards* worker ``dst``.

    Pipeline-parallel activation/gradient hops serialize per link: every
    send from one worker to the same destination shares this channel, so
    back-to-back microbatch hops queue exactly like ring legs on an ICI
    link do.
    """
    return f"ici:p2p>w{dst}"


def _json_safe(v: Any) -> bool:
    """Whether ``v`` survives a JSON round-trip unchanged (trace records)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return True
    if isinstance(v, (list, tuple)):
        return all(_json_safe(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _json_safe(x) for k, x in v.items())
    return False


def worker_thread(worker: int, thread: str) -> str:
    """Thread name of a worker-local resource inside a cluster graph.

    The cluster simulator (:mod:`repro_torch.core.cluster`) replicates a
    single-worker graph; each replica's resources are namespaced as
    ``w<i>/<thread>`` so one global simulation can model N workers.
    """
    return f"w{worker}/{thread}"


def split_worker_thread(thread: str) -> Tuple[Optional[int], str]:
    """Inverse of :func:`worker_thread`: ``(worker or None, local thread)``."""
    if thread.startswith("w") and "/" in thread:
        head, rest = thread.split("/", 1)
        if head[1:].isdigit():
            return int(head[1:]), rest
    return None, thread


@dataclasses.dataclass
class Task:
    """One node of the dependency graph (paper §4.2.1).

    Attributes mirror the paper's task record: execution thread, duration, gap,
    and layer.  ``flops``/``bytes`` let the analytical cost model re-derive
    duration after transformations (e.g. precision what-ifs halve bytes).
    """

    name: str
    kind: TaskKind
    thread: str
    duration: float                 # seconds
    gap: float = 0.0                # seconds of untraced follow-on host time (§4.2.1)
    layer: Optional[str] = None     # task->layer mapping (§4.3); None == unmapped
    phase: Optional[str] = None     # fwd / bwd / update / comm (derived from layer scope)
    flops: float = 0.0
    bytes_accessed: float = 0.0
    comm_bytes: float = 0.0         # payload bytes for collectives
    comm_axes: Tuple[str, ...] = () # mesh axes the collective spans
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # --- simulation state (reset by the simulator) -------------------------
    uid: int = -1                   # assigned by the graph; stable identity

    def clone(self) -> "Task":
        t = dataclasses.replace(self)
        t.attrs = dict(self.attrs)
        return t

    def is_on_device(self) -> bool:
        return self.thread == DEVICE_STREAM

    def is_collective(self) -> bool:
        return self.kind == TaskKind.COLLECTIVE

    def is_comm(self) -> bool:
        """Any communication task: group collective or point-to-point leg.

        Bandwidth-style what-ifs act on this superset — a pipeline hop is as
        much network traffic as an all-reduce leg.
        """
        return self.kind in (TaskKind.COLLECTIVE, TaskKind.COMM)

    # ------------------------------------------------------- trace records
    def to_record(self) -> Dict[str, Any]:
        """JSON-safe dict of the task's trace-facing fields.

        This is the per-event schema of the native JSONL trace format
        (:mod:`repro_torch.traceio`): ``dur``/``gap`` in seconds, ``kind`` as the
        :class:`TaskKind` value string, byte counts under ``bytes`` /
        ``comm_bytes``.  ``gap`` is always written (even 0.0) so importers
        never re-infer gaps for records we produced; zero/empty optional
        fields are dropped.  Non-JSON-safe ``attrs`` values are skipped.
        """
        rec: Dict[str, Any] = {"name": self.name, "kind": self.kind.value,
                               "thread": self.thread, "dur": self.duration,
                               "gap": self.gap}
        if self.layer:
            rec["layer"] = self.layer
        if self.phase:
            rec["phase"] = self.phase
        if self.flops:
            rec["flops"] = self.flops
        if self.bytes_accessed:
            rec["bytes"] = self.bytes_accessed
        if self.comm_bytes:
            rec["comm_bytes"] = self.comm_bytes
        if self.comm_axes:
            rec["comm_axes"] = list(self.comm_axes)
        attrs = {k: v for k, v in self.attrs.items() if _json_safe(v)}
        if attrs:
            rec["attrs"] = attrs
        return rec

    @staticmethod
    def from_record(rec: Dict[str, Any]) -> "Task":
        """Inverse of :meth:`to_record` (missing fields take defaults)."""
        return Task(
            name=str(rec.get("name", "?")),
            kind=TaskKind(rec.get("kind", "compute")),
            thread=str(rec.get("thread", DEVICE_STREAM)),
            duration=float(rec.get("dur", 0.0)),
            gap=float(rec.get("gap", 0.0) or 0.0),
            layer=rec.get("layer"),
            phase=rec.get("phase"),
            flops=float(rec.get("flops", 0.0)),
            bytes_accessed=float(rec.get("bytes", 0.0)),
            comm_bytes=float(rec.get("comm_bytes", 0.0)),
            comm_axes=tuple(rec.get("comm_axes", ())),
            attrs=dict(rec.get("attrs", {})))

    def __repr__(self) -> str:  # keep graphs printable
        lay = f" layer={self.layer}" if self.layer else ""
        return (f"Task#{self.uid}({self.name!r}, {self.kind.value}, {self.thread}, "
                f"{self.duration * 1e6:.2f}us{lay})")


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Target-hardware constants (TPU v5e-class chip unless overridden).

    These are the constants the roofline and the analytical cost model share.
    """

    name: str = "tpu-v5e"
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bandwidth: float = 819e9        # bytes/s per chip
    ici_bandwidth: float = 50e9         # bytes/s per link per direction
    ici_links_per_axis: int = 1         # torus links usable per mesh axis
    dcn_bandwidth: float = 25e9         # bytes/s cross-pod (data-centre network)
    vmem_bytes: int = 128 * 1024 * 1024
    hbm_bytes: int = 16 * 1024 * 1024 * 1024
    op_overhead: float = 0.5e-6         # fixed per-HLO-op issue overhead (seconds)
    host_dispatch: float = 20e-6        # host enqueue of one device program
    pcie_bandwidth: float = 32e9        # host<->device DMA for offload what-ifs

    def matmul_time(self, flops: float, bytes_accessed: float) -> float:
        return max(flops / self.peak_flops, bytes_accessed / self.hbm_bandwidth)


TPU_V5E = HardwareSpec()

# One NVIDIA H100 SXM, from NVIDIA's public data sheet (dense rates, no
# sparsity, at the card's full 700 W): the default of the measured-trace route
# (repro_torch.core.trace) on CUDA.  ``ici_bandwidth`` is NVLink's 450 GB/s
# each way, ``pcie_bandwidth`` PCIe Gen5 x16's 64 GB/s; ``dcn_bandwidth`` and
# ``vmem_bytes`` keep the class defaults (no single-card route reads them).
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,                  # bf16 FLOP/s, tensor cores
    hbm_bandwidth=3.35e12,              # HBM3 bytes/s
    ici_bandwidth=450e9,                # NVLink bytes/s per direction
    hbm_bytes=80 * 1024 ** 3,
    pcie_bandwidth=64e9,
    # The two launch constants below are assumed, not read off the card; they
    # stay, since every golden and parity test prices inserted tasks with
    # them.  The card's own values come from repro_torch.core.calibrate
    # (measure_local_backend's no-op launch and sync: calibrated_cost_model
    # puts a quarter of it in op_overhead and all of it in host_dispatch),
    # as chip_smoke.py's launch phase measures and prints them.
    op_overhead=2e-6,                   # per-kernel issue overhead (seconds)
    host_dispatch=5e-6,                 # host enqueue of one kernel launch
)
