"""Time a checkout's flash attention (``ops.flash_attention``) on the card at
the port's bf16 main-path shapes.

    python3 tools/time_flash.py [ROOT] [--sessions N]

ROOT (default: this checkout) is a tree holding ``src/repro_torch`` and
``chip_smoke.py``; it builds ROOT's kernels.  To compare two designs on one
card, run it on both checkouts in one call, in turns (parent, change,
change, parent).  Prints N (default 1) JSON lines per shape
(tinyllama-1.1b's serve and train rows, moonshot-v1-16b-a3b's train row,
deepseek-v2-236b's MLA serve and train rows, recurrentgemma-9b's serve row
and its windowed train row, all as (B, S, H, D) views, causal), one per
measurement: the kernel ROOT's dispatch launched, torch.profiler device ms
per call held against CUDA events on the same calls
(``chip_smoke.profiled_event_ms``: its records, their span and which
session agreed), the events with no profiler on, the bound and the largest
error against the plain version; then the card's name and power limit.
"""
import json
import sys
from pathlib import Path

ARGS = sys.argv[1:]
SESSIONS = int(ARGS.pop(ARGS.index("--sessions") + 1)) if "--sessions" in ARGS else 1
ARGS = [a for a in ARGS if a != "--sessions"]
ROOT = Path(ARGS[0] if ARGS else Path(__file__).resolve().parents[1]).resolve()
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import flash_attention as flash_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SHAPES = [(4, 32, 4, 512, 64, 64, 0), (2, 32, 4, 4096, 64, 64, 0),
          (1, 16, 16, 4096, 128, 128, 0), (4, 128, 128, 512, 192, 128, 0),
          (1, 128, 128, 4096, 192, 128, 0),
          (4, 16, 1, 512, 256, 256, 0), (1, 16, 1, 4096, 256, 256, 2048)]  # B, H, KH, S, D, Dv, window


def main() -> None:
    cs.device_phase()
    cs.build_phase()
    cs.prime_profiler()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, H, KH, S, D, Dv, W in SHAPES:
        q, k, v = (cs.randn(gen, B, S, h, d, dtype=torch.bfloat16).transpose(1, 2)
                   for h, d in ((H, D), (KH, D), (KH, Dv)))
        out, variant = cs._counted_variant(lambda: ops.flash_attention(q, k, v, window=W))
        err = cs.max_err(out, ref.flash_attention_ref(q, k, v, window=W))
        del out
        bound_ms = cs.bound(*cs.kernel_cost.flash_attention(
            B, H, KH, S, D, D_v=Dv, causal=True, window=W, itemsize=2))["bound_ms"]
        for _ in range(SESSIONS):
            prof, ev = cs.profiled_event_ms(lambda: ops.flash_attention(q, k, v, window=W), 20)
            print(json.dumps({
                "root": str(ROOT), "shape": [B, H, KH, S, D, Dv], "window": W,
                "variant": variant, "ms": prof.ms, "records": prof.records,
                "span_ms": prof.span_ms, "session": prof.session, "event_ms": ev,
                "event_ms_apart": cs.event_ms(lambda: ops.flash_attention(q, k, v, window=W),
                                              20),
                "bound_ms": bound_ms, "max_abs_err": err}), flush=True)
        del q, k, v
    print(f"flash launches by kernel {flash_kernel.launches_by_variant}")
    print(cs.card())


if __name__ == "__main__":
    main()
