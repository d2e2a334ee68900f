"""Architecture registry of the port (counterpart of ``repro/configs/registry.py``).

Every ported arch has ``repro_torch/configs/<id>.py`` exporting ``CONFIG``
(the public pool's numbers) and ``SMOKE`` (reduced, same family, for CPU
tests), with the reference's numbers.  An arch the port does not run yet
raises ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.model import ModelConfig

ARCHS = ["tinyllama-1.1b"]


def _module(arch: str):
    if arch not in ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ported: {', '.join(ARCHS)})")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
