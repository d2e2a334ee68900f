#!/usr/bin/env python3
"""Capture the Kineto fixture of tests/test_torch_trace.py on one NVIDIA GPU.

    python3 tests/data/capture_kineto.py [OUT]

Writes ``OUT`` (default ``tests/data/kineto_smoke_step.json.gz``): the torch.profiler trace
events (``repro_torch.core.trace.profile_events``, as ``trace_measured``
takes them) of one training step of the tinyllama smoke config in bf16,
sequence 64, micro-batch 2, with the per-leaf AdamW, after two warm-up
steps; with the card's name and power limit and the torch version beside
them.  It needs CUDA and fails without it.
"""

import gzip
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.trace import profile_events  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

OUT = Path(__file__).resolve().parent / "kineto_smoke_step.json.gz"


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("capture_kineto: needs an NVIDIA GPU")
    cfg = get_smoke_config("tinyllama-1.1b")
    trainer = Trainer(cfg, TrainerConfig(steps=1, log_every=0, seed=0),
                      optimizer=AdamW(), device="cuda")
    holder = {"state": trainer.init_state()}
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_batch(cfg, seq_len=64, batch=2, step=0).items()}

    def step():
        holder["state"], _ = trainer.step_fn(holder["state"], batch)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    events = profile_events(step, device="cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else OUT
    with gzip.open(out, "wt") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "traceEvents": events}, f)
    print(f"capture_kineto: {len(events)} events from {card} -> {out}")


if __name__ == "__main__":
    main()
