"""Typed recovery-cost model: what one fault episode costs, in seconds.

The recovery pipeline after a fail-stop failure is::

    detection -> (replacement | hot spare | elastic re-mesh) -> restore
              -> restart

``detection_s`` defaults to the ``runtime.fault.Heartbeat`` staleness
timeout (60s) — the simulator assumes failures are noticed when the
heartbeat goes stale, not instantly.  Checkpoint write/restore time is
``checkpoint_bytes`` over the host<->device DMA bandwidth from the
CostModel's :class:`HardwareSpec` (``pcie_bandwidth``), matching how
``repro_torch/ckpt`` moves arrays through host memory to disk.  Replacement
acquisition (``repair_s``) models waiting for a fresh machine; a hot spare
short-circuits it to ``spare_activation_s``; an elastic job skips it
entirely and pays ``remesh_s`` to re-close collectives over N-k workers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["RecoveryModel"]

#: runtime.fault.Heartbeat.is_alive default staleness timeout
_HEARTBEAT_TIMEOUT_S = 60.0


@dataclasses.dataclass(frozen=True)
class RecoveryModel:
    """Per-episode recovery costs for the goodput simulator."""

    #: heartbeat-staleness detection latency after a fail-stop failure
    detection_s: float = _HEARTBEAT_TIMEOUT_S
    #: process restart / framework re-init after state is restored
    restart_s: float = 30.0
    #: re-closing collectives over the surviving group (elastic only)
    remesh_s: float = 15.0
    #: acquiring a replacement machine (cold path, no spare)
    repair_s: float = 600.0
    #: promoting a provisioned hot spare into the job
    spare_activation_s: float = 20.0
    #: checkpoint payload per worker, bytes (params + optimizer state)
    checkpoint_bytes: float = 0.0
    #: host<->device / host<->disk staging bandwidth for ckpt I/O
    ckpt_bandwidth: float = 32e9
    #: fixed per-checkpoint overhead (fsync, commit rename, barrier)
    ckpt_latency_s: float = 0.5

    def __post_init__(self) -> None:
        for name in ("detection_s", "restart_s", "remesh_s", "repair_s",
                     "spare_activation_s", "checkpoint_bytes",
                     "ckpt_latency_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if self.ckpt_bandwidth <= 0:
            raise ValueError("ckpt_bandwidth must be > 0")

    @property
    def checkpoint_write_s(self) -> float:
        """Synchronous checkpoint write cost on the step path."""
        return self.checkpoint_bytes / self.ckpt_bandwidth + \
            self.ckpt_latency_s

    @property
    def restore_s(self) -> float:
        """Reading the checkpoint back and placing it on device."""
        return self.checkpoint_bytes / self.ckpt_bandwidth + \
            self.ckpt_latency_s

    def downtime_s(self, *, elastic: bool = False,
                   hot_spare: bool = False) -> float:
        """Wall-clock pause after one failure, excluding lost work.

        Elastic jobs drop the failed worker and re-mesh; non-elastic jobs
        wait for a replacement (a hot spare if provisioned, else the cold
        ``repair_s`` acquisition path) before restoring.
        """
        t = self.detection_s + self.restore_s + self.restart_s
        if elastic:
            return t + self.remesh_s
        return t + (self.spare_activation_s if hot_spare else self.repair_s)

    @classmethod
    def from_scenario(cls, scenario, params_tree=None, *,
                      optimizer_state_factor: float = 3.0,
                      **overrides) -> "RecoveryModel":
        """Derive a model from a :class:`~repro_torch.core.optimize.Scenario`.

        Checkpoint bytes come from, in order of preference: an explicit
        ``params_tree`` sized with :func:`repro_torch.ckpt.checkpoint_bytes`, or
        the scenario's per-layer gradient byte map scaled by
        ``optimizer_state_factor`` (params + Adam moments ~= 3x the
        gradient payload, which is itself param-sized).  Bandwidth comes
        from the CostModel's host<->device DMA path.
        """
        byte_total = 0.0
        if params_tree is not None:
            from repro_torch.ckpt import checkpoint_bytes
            byte_total = float(checkpoint_bytes(params_tree))
        elif getattr(scenario, "layer_grad_bytes", None):
            byte_total = (sum(scenario.layer_grad_bytes.values())
                          * optimizer_state_factor)
        kw = dict(checkpoint_bytes=byte_total)
        cost = getattr(scenario, "cost", None)
        hw = getattr(cost, "hw", None)
        if hw is not None and getattr(hw, "pcie_bandwidth", 0):
            kw["ckpt_bandwidth"] = float(hw.pcie_bandwidth)
        kw.update(overrides)
        return cls(**kw)

    def describe(self) -> str:
        return (f"detection {self.detection_s:.0f}s, restore "
                f"{self.restore_s:.1f}s ({self.checkpoint_bytes / 1e9:.2f} "
                f"GB @ {self.ckpt_bandwidth / 1e9:.0f} GB/s), restart "
                f"{self.restart_s:.0f}s, repair {self.repair_s:.0f}s, "
                f"remesh {self.remesh_s:.0f}s")
