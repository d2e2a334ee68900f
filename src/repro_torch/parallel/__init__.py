"""Parallel-plan placement of the port (``repro.parallel`` without its
JAX-side ``pipeline.py``): ``plan.py`` is carried over file-for-file, so the
``pipeline`` what-if of :mod:`repro_torch.core.optimize` runs as the
reference's does."""

from .plan import (ParallelPlan, StageProfile, partition_stages,
                   schedule_order, SCHEDULES)

__all__ = ["ParallelPlan", "StageProfile", "partition_stages",
           "schedule_order", "SCHEDULES"]
