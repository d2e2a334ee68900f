"""Training runtime helpers (counterpart of ``repro.runtime``)."""

from .fault import Heartbeat, StragglerMonitor

__all__ = ["Heartbeat", "StragglerMonitor"]
