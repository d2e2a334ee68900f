"""Roofline-term derivation from a compiled dry-run artifact (§Roofline).

Terms (seconds, per chip — the compiled HLO is the per-device program):

  compute    = HLO_FLOPs_per_device / peak_FLOP/s
  memory     = HLO_bytes_per_device / HBM_bw
  collective = sum over collective ops of ring-model time on the mesh links

plus MODEL_FLOPS (6*N*D train / 2*N*D prefill / 2*N*B decode) and the
useful-compute ratio MODEL_FLOPS / (HLO_FLOPs * chips) which catches
remat/redundancy waste.  Sources: trip-count-aware ``aggregate_costs`` over
the parsed HLO (XLA's own cost_analysis visits while bodies once and
undercounts; both are reported).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from .costmodel import CostModel
from .task import HardwareSpec, TPU_V5E


def model_flops(kind: str, n_active_params: float, seq_len: int,
                global_batch: int) -> float:
    tokens = seq_len * global_batch
    if kind == "train":
        return 6.0 * n_active_params * tokens
    if kind == "prefill":
        return 2.0 * n_active_params * tokens
    if kind == "decode":
        return 2.0 * n_active_params * global_batch   # one new token per seq
    raise ValueError(kind)


def roofline_report(agg: Dict[str, float], *, chips: int, kind: str,
                    n_active_params: float, seq_len: int, global_batch: int,
                    hw: HardwareSpec = TPU_V5E,
                    xla_cost: Optional[Dict[str, float]] = None,
                    memory_stats: Optional[Any] = None) -> Dict[str, Any]:
    compute_s = agg["flops"] / hw.peak_flops
    memory_s = agg["bytes"] / hw.hbm_bandwidth
    collective_s = agg["collective_s"]
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bound = max(terms, key=terms.get).replace("_s", "")
    mf = model_flops(kind, n_active_params, seq_len, global_batch)
    hlo_total = agg["flops"] * chips
    step_s = max(compute_s, memory_s, collective_s)     # perfect-overlap bound
    ideal_s = mf / (chips * hw.peak_flops)
    report = {
        **terms,
        "bound": bound,
        "chips": chips,
        "hlo_flops_per_device": agg["flops"],
        "hlo_bytes_per_device": agg["bytes"],
        "collective_bytes_per_device": agg["collective_bytes"],
        "model_flops": mf,
        "useful_compute_ratio": mf / hlo_total if hlo_total else 0.0,
        "roofline_fraction": ideal_s / step_s if step_s > 0 else 0.0,
        "step_time_lower_bound_s": step_s,
        "arithmetic_intensity": (agg["flops"] / agg["bytes"]
                                 if agg["bytes"] else 0.0),
    }
    for k, v in agg.items():
        if k.startswith("bytes_"):
            report[k] = v
    if xla_cost:
        report["xla_flops"] = xla_cost.get("flops", 0.0)
        report["xla_bytes"] = xla_cost.get("bytes accessed", 0.0)
    if memory_stats is not None:
        for f in ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes",
                  "alias_size_in_bytes"):
            report[f"mem_{f}"] = getattr(memory_stats, f, 0)
        report["hbm_bytes_per_device"] = (
            report["mem_argument_size_in_bytes"]
            + report["mem_output_size_in_bytes"]
            + report["mem_temp_size_in_bytes"]
            - report["mem_alias_size_in_bytes"])
        report["fits_hbm"] = bool(report["hbm_bytes_per_device"]
                                  <= hw.hbm_bytes)
    return report


def format_row(arch: str, shape: str, mesh: str, r: Dict[str, Any]) -> str:
    return (f"{arch:24s} {shape:12s} {mesh:6s} "
            f"comp={r['compute_s']*1e3:9.3f}ms "
            f"mem={r['memory_s']*1e3:9.3f}ms "
            f"coll={r['collective_s']*1e3:9.3f}ms "
            f"bound={r['bound']:10s} "
            f"useful={r['useful_compute_ratio']:5.2f} "
            f"roofline={r['roofline_fraction']:5.2f}")
