"""Time a checkout's fused AdamW (``ops.fused_adam``) on the card at the port's main-path sizes.

    python3 tools/time_fused_adam.py [ROOT]

ROOT (default: this checkout) is a tree holding ``src/repro_torch`` and
``chip_smoke.py``; it builds ROOT's kernels.  To compare two designs on one
card, run it on both checkouts in one call, in turns (parent, change,
change, parent).  Prints one JSON line per N (tinyllama-1.1b's parameters,
moonshot-v1-16b-a3b's at the moe phase's trained depth, mamba2-2.7b's at the
ssm phase's): the largest error of p, m and v against ``ref.fused_adam_ref``
(checked in chunks of 2^26), torch.profiler device ms per call held against
CUDA events on the same calls (``chip_smoke.profiled_event_ms``), the events
with no profiler on, the bound by bytes and the share of it, and on the same
buffers ``torch._fused_adamw_`` and a ``copy_`` of one vector into another
(with its share of its own bound: what the card's memory gives a plain
stream).  ``torch._fused_adamw_`` launches many kernels a call (its
multi-tensor chunks), so its calls fill the launch queue and cannot wait
behind a sleep: it is timed back to back
(``chip_smoke.call_ms``, CUDA events; the device is slower than the host's
launches) and by torch.profiler, and the kernel the same way beside it
(``call_ms``).  Where ROOT plans its launch
(``fused_adam._plan``), the plan and the blocks an SM; then the card's name
and power limit.
"""
import json
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]).resolve()
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import fused_adam as adam_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import count_params  # noqa: E402

ITERS = 10      # as chip_smoke.py times fused_adam
CHUNK = 1 << 26


def sizes() -> list:
    return [("tinyllama-1.1b", count_params(get_config(cs.ARCH))),
            (f"moe, {cs.MOE_TRAIN_LAYERS} layers", count_params(
                get_config(cs.MOE_ARCH).with_(n_layers=cs.MOE_TRAIN_LAYERS))),
            (f"ssm, {cs.SSM_TRAIN_LAYERS} layers", count_params(
                get_config(cs.SSM_ARCH).with_(n_layers=cs.SSM_TRAIN_LAYERS)))]


def row(gen, label: str, n: int) -> dict:
    kw = cs.ADAM_KW
    p, g, m, v = cs._adam_inputs(gen, n)
    got = ops.fused_adam(p.clone(), g, m.clone(), v.clone(), **kw)
    errs = [0.0, 0.0, 0.0]
    for s0 in range(0, n, CHUNK):
        sl = slice(s0, s0 + CHUNK)
        want = ref.fused_adam_ref(p[sl], g[sl], m[sl], v[sl], **kw)
        errs = [max(e, cs.max_err(a[sl], b)) for e, a, b in zip(errs, got, want)]
    del got, want
    torch.cuda.empty_cache()
    lr, c1, c2 = (torch.full((1,), kw[k], device=cs.DEV) for k in ("lr", "c1", "c2"))
    step = torch.ones((), device=cs.DEV)

    def kernel():
        ops.fused_adam(p, g, m, v, lr=lr, c1=c1, c2=c2, b1=kw["b1"], b2=kw["b2"],
                       eps=kw["eps"], wd=kw["wd"])

    def library():
        torch._fused_adamw_([p], [g], [m], [v], [], [step], lr=kw["lr"], beta1=kw["b1"],
                            beta2=kw["b2"], weight_decay=kw["wd"], eps=kw["eps"],
                            amsgrad=False, maximize=False)

    prof, ev = cs.profiled_event_ms(kernel, ITERS)
    call = cs.call_ms(kernel, ITERS)
    lib_call = cs.call_ms(library, ITERS)
    copy_ms = cs.event_ms(lambda: m.copy_(p), ITERS)
    bound = cs.bound(*cs.kernel_cost.fused_adam(n), cs.PEAK_F32_FLOPS)
    plan = getattr(adam_kernel, "_plan", None)
    per_sm = getattr(adam_kernel, "blocks_per_sm", None)
    out = {"root": str(ROOT), "size": label, "n": n, "max_abs_err": errs,
           "ms": prof.ms, "records": prof.records, "event_ms": ev,
           "event_ms_apart": cs.event_ms(kernel, ITERS), **bound,
           "share_of_bound": bound["bound_ms"] / ev,
           "call_ms": call, "library_ms": cs.device_ms(library, ITERS),
           "library_call_ms": lib_call, "kernel_over_library": call / lib_call,
           "copy_event_ms": copy_ms,
           "copy_share_of_bound": 8 * n / cs.PEAK_BYTES * 1e3 / copy_ms,
           "plan": plan(n, [t.data_ptr() for t in (p, g, m, v)])._asdict() if plan else None,
           "blocks_per_sm": per_sm() if per_sm else None}
    del p, g, m, v
    torch.cuda.empty_cache()
    return out


def main() -> None:
    cs.device_phase()
    cs.build_phase()
    cs.prime_profiler()
    gen = torch.Generator(device=cs.DEV).manual_seed(1)
    for label, n in sizes():
        print(json.dumps(row(gen, label, n)), flush=True)
    print(cs.card())


if __name__ == "__main__":
    main()
