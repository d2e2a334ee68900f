"""Training loop (counterpart of ``repro/train/loop.py``) on one device.

Composition:
  models.make_train_step  (loss + AdamW update, grad-accum aware)
  data.SyntheticLM        (numpy batches, prefetch)
  ckpt.CheckpointManager  (atomic, async; the reference's on-disk layout)
  runtime.StragglerMonitor

Each step's batch is copied to the device, the step is enqueued, and its
metrics are read back as floats, which waits for the step to end: the
host-clock ``step_time_s`` is the step's time.  Checkpoints hold the state
in the reference's layout (``convert.state_to_reference``), so either
package's trainer resumes from the other's.  As in the reference, a resumed
``fit`` starts at the restored ``step`` and draws its batches from the
caller's iterator as given: a fresh ``iter(SyntheticLM(...))`` starts at
batch 0, so pass an iterator that starts at the restored step to train each
step on its own batch.  Meshes are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.convert import state_from_reference, state_to_reference
from repro_torch.models.model import ModelConfig, init_params, make_train_step
from repro_torch.optim import AdamW
from repro_torch.runtime import StragglerMonitor


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_async: bool = True
    seed: int = 0
    straggler_threshold: float = 2.5


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 optimizer: Optional[AdamW] = None, device="cuda") -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tc = tc
        self.opt = optimizer or AdamW()
        self.step_fn = make_train_step(cfg, self.opt)
        self.ckpt = (CheckpointManager(tc.ckpt_dir) if tc.ckpt_dir else None)
        self.straggler = StragglerMonitor(threshold=tc.straggler_threshold)
        self.metrics_log: list = []

    def init_state(self, device=None) -> Dict[str, Any]:
        """Fresh state on the trainer's device; on ``device="meta"`` its
        shapes and dtypes only (the reference's ``jax.eval_shape``)."""
        dev = self.device if device is None else resolve_device(device)
        params = init_params(self.cfg, self.tc.seed, dev)
        return {"params": params, "opt": self.opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def restore_or_init(self) -> Dict[str, Any]:
        """The latest committed checkpoint on the trainer's device, else a
        fresh state."""
        if self.ckpt and self.ckpt.latest_step() is not None:
            like = state_to_reference(self.cfg, self.init_state("meta"))
            tree, _ = self.ckpt.restore_latest(like, device=self.device)
            return state_from_reference(self.cfg, tree, self.device)
        return self.init_state()

    def fit(self, batches: Iterator[Dict[str, np.ndarray]],
            steps: Optional[int] = None,
            hooks: Optional[Callable[[int, Dict], None]] = None
            ) -> Dict[str, Any]:
        steps = steps or self.tc.steps
        state = self.restore_or_init()
        start = int(state["step"])
        it = iter(batches)
        for i in range(start, steps):
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in next(it).items()}
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.straggler.record(i, dt)
            metrics.update(step=i, step_time_s=dt)
            self.metrics_log.append(metrics)
            if hooks:
                hooks(i, metrics)
            if self.tc.log_every and (i % self.tc.log_every == 0):
                print(f"step {i:6d} loss={metrics['loss']:.4f} "
                      f"gnorm={metrics.get('grad_norm', 0):.3f} "
                      f"dt={dt*1e3:.1f}ms", flush=True)
            if self.ckpt and ((i + 1) % self.tc.ckpt_every == 0
                              or i + 1 == steps):
                # save_async takes its host copy before it returns
                save = (self.ckpt.save_async if self.tc.ckpt_async
                        else self.ckpt.save)
                save(i, state_to_reference(self.cfg, state))
        if self.ckpt:
            self.ckpt.wait()
        return state
