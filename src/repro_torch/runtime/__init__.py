"""Training runtime helpers (counterpart of ``repro.runtime``)."""

from .fault import (FaultTolerantRunner, Heartbeat, StragglerMonitor,
                    RetryPolicy)

__all__ = ["FaultTolerantRunner", "Heartbeat", "StragglerMonitor",
           "RetryPolicy"]
