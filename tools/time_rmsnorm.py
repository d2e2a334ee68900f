"""Time a checkout's RMSNorm (``ops.rmsnorm``) on the card at the port's bf16 shapes.

    python3 tools/time_rmsnorm.py [ROOT]

ROOT (default: this checkout) is a tree holding ``src/repro_torch`` and
``chip_smoke.py``; it builds ROOT's kernels.  To compare two designs on one
card, run it on both checkouts in one call, in turns (parent, change,
change, parent).  Prints one JSON line per shape (tinyllama's serve, train
and decode rows, moonshot's train, mamba2's two norms, deepseek's q_norm and
its strided kv_norm): torch.profiler device ms per call held against CUDA
events on the same calls (``chip_smoke.profiled_event_ms``), the events with
no profiler on, the bound, the largest error against the plain version and,
where ROOT plans its launch (``rmsnorm._plan``), the plan; then the card's
name and power limit.
"""
import json
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]).resolve()
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rmsnorm_kernel  # noqa: E402

SHAPES = [(4096, 2560, 0), (4096, 5120, 0), (8192, 2048, 0), (4096, 2048, 0),
          (2048, 2048, 0), (2048, 1536, 0), (2048, 512, 576), (4, 2048, 0)]   # rows, cols, width


def main() -> None:
    cs.device_phase()
    cs.build_phase()
    cs.prime_profiler()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, cols, width in SHAPES:
        x = cs.randn(gen, rows, width or cols, dtype=torch.bfloat16)[:, :cols]
        w = cs.randn(gen, cols, dtype=torch.bfloat16)
        err = cs.max_err(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w))
        prof, ev = cs.profiled_event_ms(lambda: ops.rmsnorm(x, w), 20)
        plan = getattr(rmsnorm_kernel, "_plan", None)
        print(json.dumps({
            "root": str(ROOT), "shape": [rows, cols, width], "ms": prof.ms,
            "records": prof.records, "event_ms": ev,
            "event_ms_apart": cs.event_ms(lambda: ops.rmsnorm(x, w), 20),
            "bound_ms": cs.bound(*cs.kernel_cost.rmsnorm(rows, cols))["bound_ms"],
            "max_abs_err": err, "plan": plan(x, w)._asdict() if plan else None}), flush=True)
    print(cs.card())


if __name__ == "__main__":
    main()
