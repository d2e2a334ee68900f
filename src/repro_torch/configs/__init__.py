from .registry import (ARCHS, SHAPES, ShapeSpec, cells, get_config,
                       get_smoke_config, list_archs, runnable)
from .serving import SERVING_COSTS, normalize_arch, serving_cost

__all__ = ["ARCHS", "get_config", "get_smoke_config", "list_archs", "SHAPES",
           "ShapeSpec", "cells", "runnable",
           "SERVING_COSTS", "normalize_arch", "serving_cost"]
