"""Optimizers (counterpart of ``repro.optim``)."""

from .adamw import AdamW, adamw, global_norm, opt_state
from .dgc import DGCState, dgc_compress, dgc_decompress, dgc_init, dgc_step
from .schedules import constant, warmup_cosine

__all__ = ["AdamW", "adamw", "global_norm", "opt_state", "constant",
           "warmup_cosine", "dgc_compress", "dgc_decompress", "DGCState",
           "dgc_init", "dgc_step"]
