"""Training launcher (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 50 \
        --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 20 --batch 2 --seq 4096

``--smoke`` uses the arch's reduced config; otherwise the full config, at
full width on one card (``--device``, default ``cuda``).  Weights are random
from the trainer's seed; batches are ``make_batch``'s synthetic stream.
The optimizer is the reference's default, the per-leaf AdamW with a
warmup-cosine schedule.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import Prefetcher, make_batch
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt = AdamW(lr=warmup_cosine(args.lr, args.steps // 10, args.steps))
    tc = TrainerConfig(steps=args.steps, log_every=args.log_every,
                       ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, tc, optimizer=opt, device=args.device)

    def batches():
        step = 0
        while True:
            yield make_batch(cfg, seq_len=args.seq, batch=args.batch, step=step)
            step += 1

    trainer.fit(Prefetcher(batches()), steps=args.steps)
    first = trainer.metrics_log[0]["loss"]
    last = trainer.metrics_log[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} over {args.steps} steps "
          f"(device={trainer.device})")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(trainer.metrics_log, f)


if __name__ == "__main__":
    main()
