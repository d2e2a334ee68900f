#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA C++ kernel in ``src/repro_torch/csrc`` with nvcc (all at
   once), and Triton's import;
3. kernels: each kernel against its plain PyTorch version on the card over the
   JAX package's kernel-test sweep (``tests/test_kernels.py``), both dtypes,
   both ``causal`` values, and the main-path shapes; then the kernel, the plain
   version and one PyTorch library call timed at the main-path shapes: device
   time from torch.profiler (``ms``) and time per back-to-back call from CUDA
   events (``call_ms``, host launch cost included);
4. serve: tinyllama-1.1b at full width in bf16 from a seeded generator, four
   requests of 128-512 prompt tokens and 32 new tokens each through
   ``ServeEngine.generate``, with the kernels' launch counts read around that
   one run (after one short warm-up run); then each generated token checked
   against a fresh prefill of the tokens before it, and decode-step logits
   against a fresh prefill's (see serve_phase for the weights this uses);
5. the ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line.  Without CUDA, or
without the repository's ``src`` beside this file, it fails at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.models import (build_model, init_cache,  # noqa: E402
                                init_params)
from repro_torch.serve import Request, ServeEngine  # noqa: E402

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores (data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
FLASH_SWEEP = [(1, 2, 1, 128, 64), (2, 4, 2, 256, 128), (1, 8, 2, 96, 80),
               (1, 1, 1, 64, 128)]                   # (B, H, KH, S, D)
RMS_SWEEP = [(4, 64), (3, 5, 300), (16, 1024), (1, 7)]
FLASH_ATOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
RMS_ATOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
PROMPT_LENS = [128, 256, 384, 512]
NEW_TOKENS = 32
ARCH = "tinyllama-1.1b"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def call_ms(fn, iters: int = 50) -> float:
    """Mean time per call of ``fn`` over back-to-back calls (CUDA events).
    Where the host launches slower than the device runs, this is host time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 20):
    """(device ms, device operations) per call of ``fn``: the CUDA kernels and
    copies that torch.profiler records over ``iters`` calls, after 3 warm-up
    calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops_ = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in ops_)
    if not us > 0:
        fail("torch.profiler recorded no device time")
    return us / iters / 1e3, len(ops_) / iters


def device_ms(fn, iters: int = 20) -> float:
    return device_profile(fn, iters)[0]


def timings(kernel, plain, library) -> dict:
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain, 5),
            "library_ms": device_ms(library),
            "call_ms": {"kernel": call_ms(kernel), "plain": call_ms(plain, 10),
                        "library": call_ms(library)}}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


# --------------------------------------------------------------- phases
def device_phase() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0])
    return name


def build_phase() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    t1 = time.perf_counter()
    import triton
    print(f"build: nvcc {t1 - t0:.2f}s for {sorted(libs)}; "
          f"triton {triton.__version__} imported in "
          f"{time.perf_counter() - t1:.2f}s (its kernels compile at first launch)")
    for path in libs.values():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())


def kernel_phase(cfg, batch: int, seq: int) -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim or cfg.d_model // cfg.n_heads
    bad = []
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for B, h, kh, S, d in FLASH_SWEEP + [(batch, H, KH, seq, D)]:
                q, k, v = randn(B, h, S, d, dtype=dt), randn(B, kh, S, d, dtype=dt), \
                    randn(B, kh, S, d, dtype=dt)
                err = max_err(ops.flash_attention(q, k, v, causal=causal),
                              ref.flash_attention_ref(q, k, v, causal=causal))
                worst["flash_attention"] = max(worst.get("flash_attention", 0), err)
                if not err <= FLASH_ATOL[dt]:
                    bad.append(f"flash {(B, h, kh, S, d)} {dt} causal={causal}: {err}")
        for shape in RMS_SWEEP + [(batch * seq, cfg.d_model), (batch, 1, cfg.d_model)]:
            x, w = randn(*shape, dtype=dt), randn(shape[-1])
            err = max_err(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w))
            worst["rmsnorm"] = max(worst.get("rmsnorm", 0), err)
            if not err <= RMS_ATOL[dt]:
                bad.append(f"rmsnorm {shape} {dt}: {err}")
    torch.cuda.synchronize()
    print(f"kernels: largest abs error over the sweeps {worst} "
          f"(atol flash 2e-3 f32 / 3e-2 bf16, rmsnorm 1e-5 f32 / 5e-2 bf16)")
    if bad:
        fail("kernel disagrees with its plain version: " + "; ".join(bad))

    # main-path shapes, as the model passes them: bf16, (B, S, H, hd) views
    bf = torch.bfloat16
    q = randn(batch, seq, H, D, dtype=bf).transpose(1, 2)
    k = randn(batch, seq, KH, D, dtype=bf).transpose(1, 2)
    v = randn(batch, seq, KH, D, dtype=bf).transpose(1, 2)
    flash_err = max_err(ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v))
    pairs = batch * H * seq * (seq + 1) // 2            # causal (q, k) pairs
    flops = 4 * D * pairs
    nbytes = 2 * (2 * batch * H * seq * D + 2 * batch * KH * seq * D)
    flash = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:31",
             "max_abs_err": flash_err,
             **timings(lambda: ops.flash_attention(q, k, v),
                       lambda: ref.flash_attention_ref(q, k, v),
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, is_causal=True, enable_gqa=True)),
             **bound(flops, nbytes),
             "shape": f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal"}
    x = randn(batch * seq, cfg.d_model, dtype=bf)
    w = randn(cfg.d_model, dtype=bf)
    rows = batch * seq
    rms = {"name": "rmsnorm", "route": "triton",
           "source": "src/repro_torch/kernels/rmsnorm.py",
           "replaces": "src/repro/kernels/rmsnorm.py:24",
           "max_abs_err": max_err(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w)),
           **timings(lambda: ops.rmsnorm(x, w), lambda: ref.rmsnorm_ref(x, w),
                     lambda: F.rms_norm(x, (cfg.d_model,), w, 1e-6)),
           **bound(4 * rows * cfg.d_model, 2 * (2 * rows * cfg.d_model + cfg.d_model)),
           "shape": f"x {tuple(x.shape)} bf16"}
    xd = randn(batch, 1, cfg.d_model, dtype=bf)
    print(f"kernels: rmsnorm at the decode shape {tuple(xd.shape)}: device "
          f"{device_ms(lambda: ops.rmsnorm(xd, w)):.4f} ms, per call "
          f"{call_ms(lambda: ops.rmsnorm(xd, w)):.4f} ms")
    for kern in (flash, rms):
        print(f"kernels: {kern['name']} {kern['shape']}: device {kern['ms']:.4f} ms "
              f"(plain {kern['plain_ms']:.4f}, library {kern['library_ms']:.4f}, "
              f"bound {kern['bound_ms']:.4f} by {kern['bound_by']}); per call "
              f"{kern['call_ms']}")
    return [flash, rms]


def bound(flops: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def serve_phase(cfg, kernels: list) -> None:
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serve: {cfg.name} full width, {n_params / 1e9:.3f}e9 params in "
          f"{cfg.dtype}, initialised in {time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab, n)],
                    max_new_tokens=NEW_TOKENS) for n in PROMPT_LENS]
    plen = max(PROMPT_LENS)
    engine = ServeEngine(cfg, params, max_seq=plen + NEW_TOKENS, device="cuda")
    # set-up, not counted: the first call of each GEMM shape and kernel loads it
    engine.generate([Request(r.prompt, 2) for r in reqs])

    ops.reset_launch_counts()
    results = engine.generate(reqs)
    counts = ops.launch_counts()

    st = engine.stats
    steps = st["decode_steps"]
    total = sum(len(r.tokens) for r in results)
    print(f"serve: {len(reqs)} requests, prompts {PROMPT_LENS} (left-padded to "
          f"{plen}), {total} tokens; prefill {st['prefill_s'] * 1e3:.2f} ms, "
          f"decode {st['decode_s'] / steps * 1e3:.3f} ms/token over {steps} "
          f"steps, {total / (st['prefill_s'] + st['decode_s']):.1f} tokens/s")
    per_fwd = 2 * cfg.n_layers + 1
    want = {"flash_attention": cfg.n_layers, "rmsnorm": per_fwd * (1 + steps)}
    print(f"serve: launches {counts}; expected {want} "
          f"({cfg.n_layers} flash per prefill, {per_fwd} rmsnorm per forward)")
    if counts != want:
        fail(f"launch counts {counts} != {want}")
    for kern in kernels:
        kern["launches"] = counts[kern["name"]]
    for r in results:
        if len(r.tokens) != NEW_TOKENS or not all(0 <= t < cfg.vocab for t in r.tokens):
            fail(f"bad generation {r.tokens}")

    # where the time goes: device time of one prefill and one decode step at
    # the served shapes, against the host clock's time for them above
    model = build_model(cfg)
    with torch.inference_mode():
        toks = torch.ones(len(reqs), plen, dtype=torch.long, device="cuda")
        pre_ms, pre_n = device_profile(lambda: model.prefill(params, {"tokens": toks}), 3)
        cache = init_cache(cfg, len(reqs), plen + 1, "cuda")
        dec_ms, dec_n = device_profile(
            lambda: model.decode(params, cache, toks[:, :1], plen), 5)
    host_pre, host_dec = st["prefill_s"] * 1e3, st["decode_s"] / steps * 1e3
    print(f"serve: device time per prefill {pre_ms:.3f} ms over {pre_n:.0f} device "
          f"ops (busy {pre_ms / host_pre:.1%} of the served prefill's "
          f"{host_pre:.2f} ms); per decode step {dec_ms:.3f} ms over {dec_n:.0f} "
          f"ops (busy {dec_ms / host_dec:.1%} of {host_dec:.3f} ms)")

    # Consistency of decode with prefill.  The reference's fan-in rule scales
    # the (d, H, hd) projections by 1/sqrt(H) and wo by 1/sqrt(hd), so the
    # random full-width model has attention logits with a std in the hundreds
    # and is chaotic: rounding differences between the decode and prefill
    # paths grow layer by layer, in f32 as in bf16.  With these weights the
    # numbers are printed only (bf16, then f32: 4.4 GB); the check runs on the
    # same bf16 weights with the attention projections rescaled to the usual
    # fan-in (1/sqrt(d) over the contracted dimensions), where the two paths
    # must agree.
    seq = torch.tensor(rng.integers(1, cfg.vocab, (len(reqs), plen + 1)), device="cuda")
    print("serve: reference init, bf16 (printed, not checked): "
          + _consistency(cfg, params, reqs, results, seq)[0])
    cfg32, params32 = cfg.with_(dtype="float32"), _tree_map(torch.Tensor.float, params)
    res32 = ServeEngine(cfg32, params32, max_seq=plen + NEW_TOKENS,
                        device="cuda").generate(reqs)
    print("serve: reference init, f32 (printed, not checked): "
          + _consistency(cfg32, params32, reqs, res32, seq)[0])
    del params32
    _rescale_attention(cfg, params)
    res = engine.generate(reqs)
    text, ok = _consistency(cfg, params, reqs, res, seq)
    print("serve: attention rescaled to the usual fan-in: " + text)
    if not ok:
        fail("served tokens or decode logits disagree with prefill")


def _rescale_attention(cfg, params) -> None:
    """In place: wq, wk, wv to std 1/sqrt(d), wo to std 1/sqrt(H * hd)."""
    d, H, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    for lp in params["blocks"]:
        a = lp["attn"]
        a["wq"] *= (H / d) ** 0.5
        a["wk"] *= (K / d) ** 0.5
        a["wv"] *= (K / d) ** 0.5
        a["wo"] *= (1 / H) ** 0.5


def _consistency(cfg, params, reqs, results, seq):
    """Each generated token against a fresh prefill of the tokens before it,
    and decode step S's logits against a fresh prefill of S + 1 tokens."""
    model = build_model(cfg)
    plen = max(len(r.prompt) for r in reqs)
    with torch.inference_mode():
        toks = torch.zeros(len(reqs), plen, dtype=torch.long, device="cuda")
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = torch.tensor(r.prompt)
        gen = torch.tensor([r.tokens for r in results], device="cuda")
        agree = []
        for t in range(gen.shape[1]):
            logits, _ = model.prefill(params, {"tokens": torch.cat([toks, gen[:, :t]], 1)})
            agree.append((logits.argmax(-1) == gen[:, t]).float().mean().item())
        teacher = float(np.mean(agree))
        S = seq.shape[1] - 1
        full, _ = model.prefill(params, {"tokens": seq})
        _, prefix = model.prefill(params, {"tokens": seq[:, :S]})
        cache = init_cache(cfg, seq.shape[0], S + 1, "cuda")
        for layer, pre in zip(cache, prefix):
            layer["k"][:, :S], layer["v"][:, :S] = pre["k"], pre["v"]
        dec, _ = model.decode(params, cache, seq[:, S:], S)
        a, b = full.float(), dec.float()
        finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
        top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        rel = ((a - b).abs().max() / (a.abs().max() + 1e-6)).item()
    text = (f"share of the {gen.numel()} generated tokens equal to a fresh "
            f"prefill's argmax {teacher:.4f}; decode vs prefill at S={S}: top-1 "
            f"agreement {top1:.3f}, relative max error {rel:.3g}, finite "
            f"{finite} (need >= 0.5, >= 0.5, < 0.05, True)")
    return text, finite and teacher >= 0.5 and top1 >= 0.5 and rel < 0.05


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    name = device_phase()
    build_phase()
    cfg = get_config(ARCH)
    kernels = kernel_phase(cfg, len(PROMPT_LENS), max(PROMPT_LENS))
    serve_phase(cfg, kernels)
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "call_ms", "shape"]
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
