"""Serving launcher: batched greedy generation with the port's ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve              # full width, CUDA
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Weights are random, from ``--seed``.  Prints tokens/s, prefill ms and decode
ms/token (host clock, each phase ending in a device synchronise).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeEngine


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, args.seed, args.device)
    engine = ServeEngine(cfg, params, max_seq=args.max_seq, device=args.device)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab,
                                                         args.prompt_len)],
                    max_new_tokens=args.max_new)
            for _ in range(args.batch)]
    results = engine.generate(reqs)
    st = engine.stats
    total = sum(len(r.tokens) for r in results)
    wall = st["prefill_s"] + st["decode_s"]
    per_tok = st["decode_s"] / st["decode_steps"] if st["decode_steps"] else 0.0
    print(f"generated {total} tokens in {wall:.3f}s ({total / wall:.1f} tok/s "
          f"batch={args.batch} device={engine.device})")
    print(f"prefill {st['prefill_s'] * 1e3:.2f} ms  decode "
          f"{per_tok * 1e3:.3f} ms/token ({st['decode_steps']} steps)")
    for i, r in enumerate(results[:2]):
        print(f"  req{i}: {r.tokens[:12]}...")


if __name__ == "__main__":
    main()
