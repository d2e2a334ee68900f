"""Analytic serving cost model: prefill and decode-step durations.

The training-side :class:`repro_torch.core.costmodel.CostModel` prices one task
from its FLOPs/bytes; serving needs two *shape-level* quantities instead —
the wall-clock of one prefill over ``p`` prompt tokens and of one decode
step over the current batch and KV residency.  Both are rooflines over the
same :class:`~repro_torch.core.task.HardwareSpec` constants:

  prefill(p)        = max(p * flops_per_token / peak_flops,
                          (weight_bytes + p * kv_bytes_per_token) / hbm_bw)
                        * prefill_scale + step_overhead
  decode_step(b, k) = max(b * flops_per_token / peak_flops,
                          (weight_bytes + k * kv_bytes_per_token) / hbm_bw)
                        * decode_scale + step_overhead

where ``b`` is the active batch and ``k`` the resident KV tokens the step
reads — decode is memory-bound at small batch (weights dominate) and the
model is monotone in both arguments, which the latency properties rely on.

``prefill_scale`` / ``decode_scale`` / ``step_overhead`` are *fittable
constants* in exactly the :meth:`CostModel.fittable_constants` /
:meth:`CostModel.with_constants` sense: the timing harness
(:mod:`repro_torch.serving.measure`) times ``repro_torch.serve.ServeEngine``'s
prefill/decode steps on the card, fits the scales, and prints the
``ServingCostModel.with_constants({...})`` line to reuse; per-model fitted
defaults live in :mod:`repro_torch.configs.serving`.  The class default
``hw`` stays ``TPU_V5E`` as in the reference, so the reference's golden
reproduces; :func:`repro_torch.configs.serving_cost` prices on
``H100_SXM``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.costmodel import FittableConstant
from repro_torch.core.task import HardwareSpec, TPU_V5E

# Fraction of HBM the KV cache may occupy after weights (rest is
# activations/workspace) when deriving the default capacity.
_KV_HBM_FRACTION = 0.9


@dataclasses.dataclass(frozen=True)
class ServingCostModel:
    """Per-model serving constants (derived or fitted) plus the roofline.

    Build one analytically with :meth:`from_model_config` (pure shape
    math over a :class:`repro_torch.models.model.ModelConfig`) and refine it
    with measured constants via :meth:`with_constants`.
    """

    hw: HardwareSpec = TPU_V5E
    flops_per_token: float = 2e9        # decode FLOPs per generated token
    prefill_flops_per_token: float = 2e9
    weight_bytes: float = 2e9           # resident parameter bytes
    kv_bytes_per_token: float = 1e5     # K+V bytes per resident token
    tp_coll_bytes_per_token: float = 1e4  # per-step TP all-reduce payload
    # ---- fittable constants (measure.py / with_constants) ---------------
    prefill_scale: float = 1.0
    decode_scale: float = 1.0
    step_overhead: float = 0.0          # fixed per-step host/dispatch cost

    # ------------------------------------------------------------ derive
    @classmethod
    def from_model_config(cls, cfg, hw: HardwareSpec = TPU_V5E
                          ) -> "ServingCostModel":
        """Analytic constants from a model config (no compilation):
        2*N_active FLOPs per token, bf16 weights, per-layer K+V heads."""
        from repro_torch.models.model import active_params, count_params
        n_active = float(active_params(cfg))
        head_dim = cfg.head_dim or cfg.d_model // max(cfg.n_heads, 1)
        # K and V, bf16, per layer; SSM/hybrid archs keep a constant-size
        # state instead but the per-token bound still applies to their
        # attention blocks (window caps full-attention residency).
        kv = 2.0 * 2.0 * cfg.n_layers * max(cfg.n_kv_heads, 1) * head_dim
        return cls(hw=hw,
                   flops_per_token=2.0 * n_active,
                   prefill_flops_per_token=2.0 * n_active,
                   weight_bytes=2.0 * float(count_params(cfg)),
                   kv_bytes_per_token=kv,
                   tp_coll_bytes_per_token=2.0 * cfg.d_model * cfg.n_layers,
                   step_overhead=hw.host_dispatch)

    # ---------------------------------------------------------- rooflines
    def prefill_time(self, prompt_tokens: int) -> float:
        """Wall-clock of one prefill pass over ``prompt_tokens`` tokens."""
        flops = prompt_tokens * self.prefill_flops_per_token
        byts = self.weight_bytes + prompt_tokens * self.kv_bytes_per_token
        return max(flops / self.hw.peak_flops,
                   byts / self.hw.hbm_bandwidth) * self.prefill_scale \
            + self.step_overhead

    def decode_step_time(self, batch: int, kv_tokens: float) -> float:
        """Wall-clock of one decode step: ``batch`` active slots reading
        ``kv_tokens`` resident KV tokens.  Monotone non-decreasing in both
        arguments (the latency properties' load-monotonicity backbone)."""
        if batch <= 0:
            return 0.0
        flops = batch * self.flops_per_token
        byts = self.weight_bytes + kv_tokens * self.kv_bytes_per_token
        return max(flops / self.hw.peak_flops,
                   byts / self.hw.hbm_bandwidth) * self.decode_scale \
            + self.step_overhead

    def kv_offload_time(self, excess_tokens: float) -> float:
        """Per-step PCIe streaming cost of KV resident beyond HBM."""
        if excess_tokens <= 0:
            return 0.0
        return excess_tokens * self.kv_bytes_per_token \
            / self.hw.pcie_bandwidth

    def kv_capacity_tokens(self) -> float:
        """Device KV capacity: HBM minus weights, with headroom."""
        free = self.hw.hbm_bytes - self.weight_bytes
        if free <= 0 or self.kv_bytes_per_token <= 0:
            return 0.0
        return _KV_HBM_FRACTION * free / self.kv_bytes_per_token

    # ------------------------------------------------------ parallelism
    def parallel(self, degree: int) -> "ServingCostModel":
        """Tensor-parallel shard of this model over ``degree`` chips:
        weights, KV heads, and per-token FLOPs all divide; the fixed step
        overhead does not (each chip still dispatches every step)."""
        if degree <= 1:
            return self
        return dataclasses.replace(
            self,
            flops_per_token=self.flops_per_token / degree,
            prefill_flops_per_token=self.prefill_flops_per_token / degree,
            weight_bytes=self.weight_bytes / degree,
            kv_bytes_per_token=self.kv_bytes_per_token / degree)

    # ------------------------------------------------- fittable constants
    _FITTABLE = ("prefill_scale", "decode_scale", "step_overhead")

    def fittable_constants(self) -> List[FittableConstant]:
        """The measurable constants, in :class:`FittableConstant` form —
        the same contract :meth:`CostModel.fittable_constants` exposes to
        the calibration loop."""
        bounds = {"prefill_scale": (1e-3, 1e4, True),
                  "decode_scale": (1e-3, 1e4, True),
                  "step_overhead": (0.0, 1.0, False)}
        return [FittableConstant(n, getattr(self, n), lo, hi, log=log)
                for n in self._FITTABLE
                for (lo, hi, log) in (bounds[n],)]

    def with_constants(self, mapping: Dict[str, float]
                       ) -> "ServingCostModel":
        """Copy with measured constants applied (keys from
        :meth:`fittable_constants`) — the reuse line
        :mod:`repro_torch.serving.measure` prints."""
        bad = [k for k in mapping if k not in self._FITTABLE]
        if bad:
            raise ValueError(
                f"unknown serving constant(s) {bad}; fittable: "
                f"{list(self._FITTABLE)}")
        return dataclasses.replace(
            self, **{k: float(v) for k, v in mapping.items()})
