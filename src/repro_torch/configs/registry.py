"""Architecture registry of the port (counterpart of ``repro/configs/registry.py``).

Every ported arch has ``repro_torch/configs/<id>.py`` exporting ``CONFIG``
(the public pool's numbers) and ``SMOKE`` (reduced, same family, for CPU
tests), with the reference's numbers.  An arch the port does not run yet
raises ``NotImplementedError``.

Shape semantics (the reference's):
  train_4k     seq 4,096   global_batch 256   train step
  prefill_32k  seq 32,768  global_batch 32    prefill step
  decode_32k   seq 32,768  global_batch 128   serve step (1 new tok)
  long_500k    seq 524,288 global_batch 1     serve step; sub-quadratic archs
               only -- full-attention archs SKIP.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models.model import ModelConfig

# the archs whose model the port builds (families dense, moe, mla_moe, ssm,
# hybrid)
ARCHS = ["tinyllama-1.1b", "llama3.2-1b", "llama3-405b", "moonshot-v1-16b-a3b",
         "deepseek-v2-236b", "mamba2-2.7b", "recurrentgemma-9b"]


def fold_name(arch: str) -> str:
    """The config module's name for an arch id (dashes and dots folded)."""
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    if arch not in ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ported: {', '.join(ARCHS)})")
    return importlib.import_module(f"repro_torch.configs.{fold_name(arch)}")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def list_archs() -> List[str]:
    return list(ARCHS)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def runnable(arch: str, shape: str) -> Tuple[bool, str]:
    """(runnable?, reason-if-skipped) for a cell, by the reference's rules."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    if spec.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attention): 500k dense-KV decode inapplicable"
    if spec.kind == "decode" and not cfg.decode_supported:
        return False, "SKIP(no-decoder)"
    return True, ""


def cells(include_skipped: bool = False) -> List[Tuple[str, str]]:
    out = []
    for a in ARCHS:
        for s in SHAPES:
            ok, _ = runnable(a, s)
            if ok or include_skipped:
                out.append((a, s))
    return out
