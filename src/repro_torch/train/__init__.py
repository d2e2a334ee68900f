"""Training loop (counterpart of ``repro.train``)."""

from .loop import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
