"""Analytical per-task cost model for the target hardware (TPU v5e-class).

Daydream needs a duration for every task.  On GPU the paper reads durations from
CUPTI; with no TPU in the loop we derive durations from first principles, the
same way the paper derives *new* task durations (communication formulas, §4.2.1
"Duration"; NCCL ring formulas, §6.5):

  - compute/memory ops:  max(FLOPs / peak_FLOPs, bytes / HBM_bw) + issue overhead
  - collectives:         ring / bidirectional-ring formulas over the mesh axes
  - host dispatch:       fixed per-program enqueue cost
  - data loading:        bytes / host IO bandwidth

A *calibrated* mode replaces the hardware constants with CPU-measured ones
(:mod:`repro_torch.core.calibrate`) so that simulated makespans can be validated
against wall-clock ground truth in this container.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .task import HardwareSpec, TPU_V5E


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Physical interpretation of mesh axes for the collective model.

    ``axis_kind`` maps each mesh axis to the interconnect it travels over:
    ``ici`` (intra-pod torus links) or ``dcn`` (cross-pod data-centre network).
    """

    axis_sizes: Dict[str, int]
    axis_kind: Dict[str, str]

    @staticmethod
    def single_pod(data: int = 16, model: int = 16) -> "MeshTopology":
        return MeshTopology({"data": data, "model": model},
                            {"data": "ici", "model": "ici"})

    @staticmethod
    def multi_pod(pods: int = 2, data: int = 16, model: int = 16) -> "MeshTopology":
        return MeshTopology({"pod": pods, "data": data, "model": model},
                            {"pod": "dcn", "data": "ici", "model": "ici"})

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.axis_sizes.values():
            n *= s
        return n


class CollectiveModel:
    """Time model for mesh collectives (paper §6.5 / NCCL-tests formulas [56]).

    Ring algorithms on a bidirectional torus axis of size ``n``:

      all-reduce      : 2 * (n-1)/n * bytes / bw     (reduce-scatter + all-gather)
      reduce-scatter  :     (n-1)/n * bytes / bw
      all-gather      :     (n-1)/n * bytes / bw     (bytes = full output size)
      all-to-all      :     (n-1)/n * bytes / bw     (each device keeps 1/n)
      permute         :           bytes / bw

    ``bytes`` is the per-device payload.  A per-hop latency term models the
    (n-1) link traversals.  BlueConnect-style axis decomposition falls out of
    running the formula per mesh axis (DESIGN.md §2).
    """

    # Default seconds per ring step (link + switch latency).  Kept as a class
    # constant for the analytical TPU model; pass ``hop_latency`` (or set
    # ``CostModel.hop_latency``) to use a *measured* value — calibration
    # (:func:`repro_torch.core.calibrate.calibrated_cost_model`) derives it from
    # tiny-payload collectives the same way compute durations are calibrated
    # from measured FLOP rates.
    HOP_LATENCY = 1e-6

    def __init__(self, hw: HardwareSpec = TPU_V5E,
                 topo: Optional[MeshTopology] = None,
                 hop_latency: Optional[float] = None,
                 ici_factor: float = 1.0,
                 dcn_factor: float = 1.0) -> None:
        self.hw = hw
        self.topo = topo or MeshTopology.single_pod()
        self.hop_latency = (self.HOP_LATENCY if hop_latency is None
                            else hop_latency)
        self.ici_factor = ici_factor
        self.dcn_factor = dcn_factor

    def _axis_bw(self, kind: str) -> float:
        if kind == "dcn":
            return self.hw.dcn_bandwidth * self.dcn_factor
        return self.hw.ici_bandwidth * self.hw.ici_links_per_axis \
            * self.ici_factor

    def axis_time(self, op: str, payload_bytes: float, axis_size: int,
                  kind: str = "ici") -> float:
        if axis_size <= 1 or payload_bytes <= 0:
            return 0.0
        bw = self._axis_bw(kind)
        frac = (axis_size - 1) / axis_size
        steps = axis_size - 1
        if op == "all-reduce":
            return 2 * frac * payload_bytes / bw + 2 * steps * self.hop_latency
        if op in ("reduce-scatter", "all-gather", "all-to-all"):
            return frac * payload_bytes / bw + steps * self.hop_latency
        if op == "collective-permute":
            return payload_bytes / bw + self.hop_latency
        raise ValueError(f"unknown collective {op!r}")

    def p2p_time(self, payload_bytes: float, bandwidth: float) -> float:
        """One point-to-point hop over a link of ``bandwidth`` bytes/s.

        The primitive under both ring legs and pipeline-parallel
        activation/gradient hops: payload transfer plus the per-hop
        link/switch latency.  Zero payload is a pure synchronization edge
        and costs nothing (matching :meth:`axis_time`'s empty-collective
        contract).
        """
        if payload_bytes <= 0:
            return 0.0
        return payload_bytes / bandwidth + self.hop_latency

    def group_time(self, op: str, payload_bytes: float, group_size: int,
                   crosses_pod: bool = False) -> float:
        """Time for one collective over an opaque replica group.

        Used when the HLO replica groups don't align with a single mesh axis:
        treat the group as one ring over the slowest link it crosses.
        """
        kind = "dcn" if crosses_pod else "ici"
        return self.axis_time(op, payload_bytes, group_size, kind)

    def hierarchical_all_reduce(self, payload_bytes: float,
                                axes: Sequence[str]) -> float:
        """BlueConnect / TPU-hierarchical decomposition over multiple axes:
        reduce-scatter along each axis in turn, then all-gather in reverse.
        Payload shrinks by the axis size after each reduce-scatter."""
        t = 0.0
        p = payload_bytes
        for ax in axes:
            n = self.topo.axis_sizes[ax]
            t += self.axis_time("reduce-scatter", p, n, self.topo.axis_kind[ax])
            p /= max(n, 1)
        for ax in reversed(list(axes)):
            n = self.topo.axis_sizes[ax]
            p *= max(n, 1)
            t += self.axis_time("all-gather", p, n, self.topo.axis_kind[ax])
        return t


@dataclasses.dataclass(frozen=True)
class FittableConstant:
    """One CostModel constant the trace-fit loop may adjust.

    ``name`` is the key :meth:`CostModel.with_constants` accepts
    (``"kind_scale:<task-kind>"``, ``"ici_factor"``, ``"dcn_factor"``,
    ``"hop_latency"``); ``lo``/``hi`` bound the search, ``log`` says the
    constant lives on a multiplicative scale (search in log-space), and
    ``kind`` names the task kind a per-kind scale applies to (None for
    link-level constants).
    """

    name: str
    value: float
    lo: float
    hi: float
    log: bool = True
    kind: Optional[str] = None


# Task kinds whose traced/cloned durations a per-kind scale multiplies
# (collective/comm durations are bandwidth-derived instead — fit those
# through ici_factor/dcn_factor/hop_latency).
SCALED_KINDS: Tuple[str, ...] = ("compute", "memory", "host", "data",
                                 "offload")


@dataclasses.dataclass
class CostModel:
    """Duration assignment for HLO-derived tasks."""

    hw: HardwareSpec = dataclasses.field(default_factory=lambda: TPU_V5E)
    topo: MeshTopology = dataclasses.field(
        default_factory=MeshTopology.single_pod)
    # Calibration multipliers (1.0 = analytical model; calibrate.py overrides).
    compute_scale: float = 1.0
    memory_scale: float = 1.0
    collective_scale: float = 1.0
    # Per-ring-step latency override (None = CollectiveModel.HOP_LATENCY);
    # calibrate.py measures it from tiny-payload local collectives.
    hop_latency: Optional[float] = None
    # Trace-fit constants (repro_torch.analysis.calibrate): per-task-kind duration
    # multipliers applied to traced/cloned durations on the cluster routes,
    # and link-bandwidth factors multiplying the ICI / DCN hardware
    # bandwidths everywhere they are read (ring legs, p2p hops, analytical
    # collective formulas).  All default to 1.0 == the uncalibrated model.
    kind_scales: Dict[str, float] = dataclasses.field(default_factory=dict)
    ici_factor: float = 1.0
    dcn_factor: float = 1.0

    def __post_init__(self) -> None:
        self.collectives = CollectiveModel(self.hw, self.topo,
                                           hop_latency=self.hop_latency,
                                           ici_factor=self.ici_factor,
                                           dcn_factor=self.dcn_factor)

    # ------------------------------------------------------- trace-fit API
    def kind_scale(self, kind) -> float:
        """Duration multiplier for one task kind (TaskKind or value string);
        1.0 unless calibration set one."""
        return self.kind_scales.get(getattr(kind, "value", kind), 1.0)

    def link_bandwidth(self, link: str) -> float:
        """Effective bandwidth of one ``"ici"`` / ``"dcn"`` link, the
        calibration factors applied — the single source the cluster ring /
        p2p wiring and the analytical collective formulas share."""
        return self.collectives._axis_bw(link)

    def fittable_constants(self, kinds: Optional[Sequence[str]] = None
                           ) -> List[FittableConstant]:
        """The typed list of constants the trace-fit loop may adjust.

        ``kinds`` restricts the per-kind scales (default:
        :data:`SCALED_KINDS`).  Bounds are generous-but-physical: duration
        and bandwidth multipliers within 20x either way, hop latency
        between 10ns and 1ms.
        """
        out = [FittableConstant(f"kind_scale:{k}", self.kind_scale(k),
                                0.05, 20.0, kind=k)
               for k in (SCALED_KINDS if kinds is None else kinds)]
        out.append(FittableConstant("ici_factor", self.ici_factor,
                                    0.05, 20.0))
        out.append(FittableConstant("dcn_factor", self.dcn_factor,
                                    0.05, 20.0))
        out.append(FittableConstant(
            "hop_latency",
            self.collectives.hop_latency, 1e-8, 1e-3))
        return out

    def with_constants(self, mapping: Dict[str, float]) -> "CostModel":
        """A copy of this model with fittable constants overridden;
        ``mapping`` keys are :class:`FittableConstant` names."""
        ks = dict(self.kind_scales)
        kwargs: Dict[str, float] = {}
        for name, val in mapping.items():
            if name.startswith("kind_scale:"):
                ks[name.split(":", 1)[1]] = float(val)
            elif name in ("ici_factor", "dcn_factor", "hop_latency"):
                kwargs[name] = float(val)
            else:
                raise ValueError(f"unknown fittable constant {name!r}")
        return dataclasses.replace(self, kind_scales=ks, **kwargs)

    # ------------------------------------------------------------- durations
    def compute_time(self, flops: float, bytes_accessed: float) -> float:
        t_flops = self.compute_scale * flops / self.hw.peak_flops
        t_bytes = self.memory_scale * bytes_accessed / self.hw.hbm_bandwidth
        return max(t_flops, t_bytes) + self.hw.op_overhead

    def collective_time(self, op: str, payload_bytes: float, group_size: int,
                        crosses_pod: bool = False) -> float:
        t = self.collectives.group_time(op, payload_bytes, group_size, crosses_pod)
        return self.collective_scale * t + self.hw.op_overhead

    def host_dispatch_time(self) -> float:
        return self.hw.host_dispatch

    def offload_time(self, bytes_moved: float) -> float:
        return bytes_moved / self.hw.pcie_bandwidth + self.hw.op_overhead

    # --------------------------------------------------------------- roofline
    def roofline_terms(self, flops_per_device: float, bytes_per_device: float,
                       collective_seconds: float) -> Dict[str, float]:
        """The three §Roofline terms, in seconds (per device ≡ per chip)."""
        compute = flops_per_device / self.hw.peak_flops
        memory = bytes_per_device / self.hw.hbm_bandwidth
        terms = {
            "compute_s": compute,
            "memory_s": memory,
            "collective_s": collective_seconds,
        }
        dom = max(terms, key=terms.get)
        terms["bound"] = dom.replace("_s", "")   # type: ignore[assignment]
        return terms
