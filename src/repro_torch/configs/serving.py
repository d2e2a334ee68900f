"""Per-model ServingCostModel defaults for the port's architecture registry
(counterpart of ``repro/configs/serving.py``).

Every ported arch gets an analytic :class:`repro_torch.serving.ServingCostModel`
derived from its exact :class:`~repro_torch.models.model.ModelConfig` shape
(:meth:`ServingCostModel.from_model_config`); archs that have been run
through the :mod:`repro_torch.serving.measure` timing harness on the card
additionally carry fitted constants in :data:`SERVING_COSTS`.

:func:`serving_cost` is the one-stop lookup the serving CLIs use; it
accepts CLI-style underscore names (``llama3_405b``) as well as the
registry's canonical dashed ids (``llama3-405b``).  It prices on
``H100_SXM`` unless given another ``HardwareSpec``: the constants here were
fitted against that roofline.
"""

from __future__ import annotations

from typing import Dict

from .registry import ARCHS, fold_name

# arch -> {prefill_scale, decode_scale, step_overhead} fitted on the card at
# full width by measure_serving_costs (batch 4 x 512 prompt tokens, max_seq
# 576, decode timed in runs of measure.DECODE_STEPS steps, against H100_SXM
# rooflines), as `python -m repro_torch.serving.measure --arch <arch>` does,
# in the chip_smoke.py run that PERF.md's serving findings list as run 6
# (tinyllama-1.1b: the median of each constant over its 11 fits;
# llama3.2-1b: its one fit).  The engine is eager and its decode host-bound,
# hence the large decode scales.  They are one host's pace: the fits of
# runs 1-5 there, on other machines of the same kind, read 0.70-2.17x these.
# Archs absent here use the pure analytic model.
SERVING_COSTS: Dict[str, Dict[str, float]] = {
    # NVIDIA H100 80GB HBM3, 700.00 W; run 6
    "tinyllama-1.1b": {"prefill_scale": 3.93596, "decode_scale": 41.0643,
                       "step_overhead": 5e-06},
    # NVIDIA H100 80GB HBM3, 700.00 W; run 6
    "llama3.2-1b": {"prefill_scale": 4.20645, "decode_scale": 26.591,
                    "step_overhead": 5e-06},
}


def normalize_arch(name: str) -> str:
    """Map a CLI-style name (``llama3_405b``, ``llama3.2-1b``…) to the
    registry's canonical arch id, via the same dash/dot folding the
    config-module loader uses."""
    if name in ARCHS:
        return name
    folded = fold_name(name)
    for arch in ARCHS:
        if fold_name(arch) == folded:
            return arch
    raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")


def serving_cost(name: str, hw=None, *, smoke: bool = False,
                 fitted: bool = True):
    """The arch's :class:`repro_torch.serving.ServingCostModel` on ``hw``
    (default ``H100_SXM``): analytic shape math plus (``fitted=True``) the
    constants fitted on the card.  Those constants are one host's pace
    (the engine is host-bound): on another machine the engine can run
    about 2x faster or slower than they say, so fit afresh
    (:mod:`repro_torch.serving.measure`) where the price must be close.

    ``smoke=True`` prices the reduced smoke config instead.
    """
    from repro_torch.core.task import H100_SXM
    from repro_torch.serving.costs import ServingCostModel
    from .registry import get_config, get_smoke_config
    arch = normalize_arch(name)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = ServingCostModel.from_model_config(cfg, hw or H100_SXM)
    consts = SERVING_COSTS.get(arch) if fitted else None
    if consts:
        model = model.with_constants(consts)
    return model
