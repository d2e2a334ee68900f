"""Timing harness: fit ServingCostModel constants to the port's ServeEngine
(counterpart of ``repro/serving/measure.py``).

Times :class:`repro_torch.serve.ServeEngine`'s prefill and decode steps
(``engine._prefill``, ``engine._decode``: the functions ``generate`` loops
over) on the card, and solves the analytic
:class:`~repro_torch.serving.costs.ServingCostModel` rooflines for
``prefill_scale`` / ``decode_scale``, printing the
``ServingCostModel.from_model_config(...).with_constants({...})`` line to
paste into :data:`repro_torch.configs.serving.SERVING_COSTS`.

The reference times its engine's jitted functions; the port's engine runs
eagerly, so this times what the port's engine actually runs, host launch
cost included (its decode step is host-bound, so ``decode_scale`` comes
out large).

The reference times one decode step per sample.  The port's decode is
host-bound, and one step (a few tens of milliseconds) samples the host's
pace where it jitters most, so each decode sample here times a run of
:data:`DECODE_STEPS` back-to-back steps, as ``generate`` runs them, and
divides by that count.  The host's pace drifts by 10-20% over seconds and
differs by up to 2x between machines, so constants fitted on one machine
price another machine's engine only roughly; fit in the same session as
what the constants are to predict.

Usage, on a machine with the card (full width, the shape whose constants
:data:`~repro_torch.configs.serving.SERVING_COSTS` holds)::

    python -m repro_torch.serving.measure --arch tinyllama-1.1b

``--smoke --device cpu`` runs the harness on the smoke config on the CPU;
times taken there are the CPU's, not the card's.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.task import H100_SXM, HardwareSpec
from .costs import ServingCostModel

DECODE_STEPS = 32       # back-to-back decode steps per timed decode sample


def _time(fn, *args, sync: Callable[[], None], warmup: int = 1,
          iters: int = 3) -> float:
    """Median host-clock seconds of ``fn(*args)``, each call ending in
    ``sync()`` (a device synchronise on the card)."""
    for _ in range(warmup):
        fn(*args)
        sync()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


def measure_serving_costs(arch: str = "tinyllama-1.1b", *,
                          smoke: bool = False, prompt_tokens: int = 512,
                          batch: int = 4, max_seq: int = 576,
                          hw: HardwareSpec = H100_SXM, device="cuda"
                          ) -> Tuple[ServingCostModel, Dict[str, float]]:
    """Time the prefill and decode step of ``arch``'s config (random weights
    from seed 0) on ``device`` and return the fitted model plus the
    constants mapping.

    One prefill of ``batch`` x ``prompt_tokens`` tokens, then decode steps
    on its cache (``engine._prefill`` / ``engine._decode``, as ``generate``
    calls them), each decode sample a run of :data:`DECODE_STEPS` steps
    divided by that count.  The fixed per-step overhead is pinned to
    ``hw.host_dispatch``.  Decode is solved as the reference solves it::

        decode_scale = (t_decode - overhead) / roof_decode(batch, batch * prompt_tokens)

    Prefill differs from the reference on purpose (ROADMAP C7): the timed
    prefill runs the whole batch, and static mode prices a batch as
    ``batch`` prefills of ``prompt_tokens`` each, so the scale is solved
    against the whole batch::

        prefill_scale = (t_prefill - batch * overhead) / (batch * roof_prefill(prompt_tokens))

    and a static batch of this shape is priced at exactly the measured
    prefill (the reference's fit prices it at ``batch`` times that).
    """
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    eng = ServeEngine(cfg, init_params(cfg, seed=0, device=device),
                      max_seq=max_seq, device=device)
    params = eng.params
    with torch.inference_mode():
        toks = torch.ones((batch, prompt_tokens), dtype=torch.long,
                          device=eng.device)
        t_prefill = _time(eng._prefill, params, {"tokens": toks},
                          sync=eng._sync)
        nxt, prefix = eng._prefill(params, {"tokens": toks})
        cache = eng._grow_cache(prefix, prompt_tokens)
        del prefix
        t_decode = _time(
            lambda: [eng._decode(params, cache, nxt, prompt_tokens)
                     for _ in range(DECODE_STEPS)],
            sync=eng._sync) / DECODE_STEPS

    # analytic model for the *measured* config, so the rooflines match
    # the shapes we actually ran
    analytic = ServingCostModel.from_model_config(cfg, hw)
    overhead = hw.host_dispatch
    pf_roof = (analytic.prefill_time(prompt_tokens) - analytic.step_overhead
               ) / analytic.prefill_scale
    kv = batch * prompt_tokens
    dc_roof = (analytic.decode_step_time(batch, kv) - analytic.step_overhead
               ) / analytic.decode_scale
    consts = {
        "prefill_scale": max(1e-3, (t_prefill - batch * overhead)
                             / (batch * pf_roof)),
        "decode_scale": max(1e-3, (t_decode - overhead) / dc_roof),
        "step_overhead": overhead,
    }
    return analytic.with_constants(consts), consts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fit ServingCostModel constants to the port's "
                    "ServeEngine prefill/decode (host clock, synchronised)")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="measure the reduced smoke config")
    ap.add_argument("--prompt-tokens", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=576)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    fitted, consts = measure_serving_costs(
        args.arch, smoke=args.smoke, prompt_tokens=args.prompt_tokens,
        batch=args.batch, max_seq=args.max_seq, device=args.device)
    dev = torch.device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    c = ", ".join(f"{k!r}: {v:.6g}" for k, v in consts.items())
    print(f"# measured {args.arch}{' (smoke config)' if args.smoke else ''} "
          f"on {where}, batch {args.batch} x {args.prompt_tokens} prompt "
          f"tokens, against H100_SXM rooflines; reuse with:")
    print(f"ServingCostModel.from_model_config("
          f"get_config({args.arch!r}), H100_SXM).with_constants({{{c}}})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
