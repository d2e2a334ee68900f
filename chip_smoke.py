#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA C++ kernel in ``src/repro_torch/csrc`` with nvcc (all at
   once: flash attention's two, RMSNorm, fused_adam, dgc);
3. kernels: each kernel against its plain PyTorch version on the card over the
   JAX package's kernel-test sweeps (``tests/test_kernels.py``) and the
   main-path shapes; fused_adam also over the edges of its ring of bulk
   copies (sizes around a tile and a full ring, tails of 1 to 3 entries,
   each vector in turn off 16-byte alignment, guard entries unwritten);
   flash attention also over the tensor-core kernel's edges
   (ragged S, group 8, D 80 and 128, (B, S, H, D) tensors as transposed
   views) and the inputs that must take the CUDA-core kernel, printing which
   kernel each case took; the gradients through the flash-attention and RMSNorm
   ``autograd.Function``s against autograd of the plain versions; then each
   kernel, its plain version and one PyTorch library call timed at the
   main-path shapes: device time from torch.profiler (``ms``; its raw
   record count and unscaled time kept beside it), held against the device
   time from CUDA events on the same calls, with the host's launches hidden
   behind a sleep kernel (``event_ms``; ``event_ms_apart`` the same with no
   profiler on), and time per back-to-back call from CUDA events
   (``call_ms``, host launch cost included); flash attention's CUDA-core kernel timed on the same inputs
   as its tensor-core kernel; flash attention with v's own head dim (q/k up
   to 192, v up to 128) over its sweep and gradients; then flash attention
   checked and timed at deepseek-v2-236b's MLA shapes beside SDPA (phase
   12's), with RMSNorm at its q_norm and strided kv_norm widths,
   flash attention, RMSNorm and fused_adam at the moe model's
   shapes (phase 11's), and RMSNorm at mamba2-2.7b's 2560 and 5120 columns
   (phase 13's); flash attention at head dim 256 (recurrentgemma-9b's, on
   the tensor-core kernel's (256, 256) bucket in bf16, each case through
   the CUDA-core kernel too) over its sweep and gradients, and timed at
   that model's serve shape beside the CUDA-core kernel and SDPA; and its
   local window on both kernels (phase 14's);
4. serve: tinyllama-1.1b at full width in bf16 from a seeded generator, four
   requests of 128-512 prompt tokens and 32 new tokens each through
   ``ServeEngine.generate``, with the kernels' launch counts read around that
   one run (after one short warm-up run), every flash launch on the
   tensor-core kernel; then each generated token checked
   against a fresh prefill of the tokens before it, and decode-step logits
   against a fresh prefill's (see serve_phase for the weights this uses);
5. train: tinyllama-1.1b at full width and depth in bf16, sequence 4096,
   micro-batch 2, ``SyntheticLM`` batches, through ``Trainer.fit`` with
   ``AdamW(fused=True)``: one warm-up step and 3 timed steps, launch counts
   (and flash's per kernel) read per step; every param's gradient finite and nonzero; the per-leaf
   and the fused update on the same gradients and state, timed and held
   against each other; the DGC threshold kernel on the unembedding's
   gradient; the loss falling over 5 steps on one batch;
6. whatif: Daydream on the card (paper §6.3, Algorithm 4) at the train
   shape.  The per-leaf AdamW step (``Trainer`` with ``AdamW()``) is traced
   with ``repro_torch.core.trace_measured`` (torch.profiler: CUDA kernels and
   runtime calls -> dependency graph, layers from the model's scopes); the
   graph is checked (acyclic, fwd/bwd/update present, >= 90% of device time
   mapped to a layer, every kernel launched by a host task), simulated and
   held within 10% of its capture's span (the simulation replays its input)
   and of the step's measured time; ``fused_optimizer`` is
   predicted on it and held within 16% of the fused step (``AdamW(fused=True)``,
   one fused_adam launch) measured interleaved per-leaf / fused / per-leaf,
   both speedups above 1;
7. amp: the same for AMP (paper Algorithm 3): the float32 config's fused
   step (flash on the CUDA-core kernel) traced, simulated and held within
   10% of its measured time; ``amp`` predicted on it (and ``fused_optimizer``,
   as the reference's quickstart asks), and a diagnostic prediction that
   leaves the attention backward and the update alone; the bfloat16 step
   (the implementation) measured interleaved float32 / bfloat16 / float32
   and traced; a per-layer table of device time (float32 measured,
   AMP-predicted, bfloat16 measured) and the bfloat16 step's update by
   operation from its capture (the flat copies around fused_adam, the
   gradient norm and clip, the kernel, the cast back; printed, not gated);
   both speedups above 1 and the launch
   counts exact (per step 22 flash, all on ``scalar`` in float32 and on
   ``wgmma`` in bfloat16, 45 RMSNorm, 1 fused_adam); the prediction errors
   printed, not gated (the float32 trace's launch-queue waits are
   device -> host edges, ``core/kineto.py``).  Then the analytical route
   (``trace_compiled``) on meta tensors of both steps: 22 flash, 45 RMSNorm
   and 1 fused_adam tasks, a phase on every device task, the allocated
   device memory unchanged, its simulated step against the measured one and
   its AMP prediction printed;
8. traceio: the captures of phases 6 and 7, profiled nothing again, through
   ``repro_torch.traceio`` and ``repro_torch.analysis``: the bfloat16 fused
   step written as torch.profiler exports it and read back by
   ``load_trace_dir``, then exported with ``TraceBundle.export_chrome`` and
   re-imported (each within 1e-6 of ``trace_measured``'s makespan); the
   per-leaf step with ``fused_optimizer`` diffed against the fused capture
   task by task (per-kind WAPE, makespan error, top 5); the fused step's
   critical path and the registry's opportunity bounds; ``calibrate`` on the
   capture itself (a faithful replay, loss 0) and the H100 cost model's
   constants fitted to it, with the analytical bfloat16 step priced before
   and after;
9. launch: Daydream's command-line tools and ``core/calibrate.py`` on the
   card, reading phases 6 and 7's captures.  ``measure_local_backend`` at
   the reference's defaults (1024, float32) and filling the card (8192, in
   float32 and bfloat16): matmul FLOP/s, element-wise bytes/s and the no-op
   launch and sync, each held above 0 and at most 1.05x the data sheet;
   both ``calibrated_cost_model``s printed; the host microseconds per
   operator with and without torch.profiler; ``perf_report``'s compiled
   route (the per-device train_4k step of the reference's 256-chip cell,
   1 x 4096, on meta tensors: its roofline rows gated, 22 / 45 / 1 kernel
   tasks) simulated with the data sheet and the calibrated rates, against
   the same step measured on the card (launch counts exact, ratios
   printed); then ``diagnose``, ``calibrate``, ``perf_report`` (trace,
   goodput, serving and compiled routes) and ``hillclimb
   --search-whatif 2`` run as subprocesses at once: exit 0, their key
   lines, the exported prediction re-imported, hillclimb's rounds never
   slower;
10. faults: checkpoint/restart and the goodput simulator
   (``repro_torch.{ckpt,runtime,faults}``), checkpoints in a temporary
   directory (its filesystem and free bytes printed).  At full width and
   depth, bf16, fused AdamW: ``Trainer.fit`` of 3 steps with one
   synchronous save (``checkpoint_bytes`` equal to the ``.npy`` payloads,
   12 B per parameter + 12), one ``save_async`` (blocking part and wait),
   a restore into a fresh trainer (``restore_or_init``, ``like`` on meta
   tensors), bit-equal with flat-backed moments, and its next step against
   two live ones (bit-equal where the step is deterministic, else within
   their spread; launches exact).  Then a drill at 2 layers, in each of 3
   rounds predicted first and then run: the checkpoint operations the
   drills perform sampled at 2 layers (saves that only write, saves that
   also delete the oldest, a restore), the checkpoint cost fitted (weighted
   least squares, latency >= 0) to them and to the full depth's save as a
   run makes it (a write, then the oldest deleted) and restore, each kind
   weighted by its share of each gated drill's operations, printed beside
   ``H100_SXM``'s default; the step traced (``trace_measured``) once, a
   ``FaultScenario`` with the round's fitted cost, no detection, repair or
   restart time, and one fail-stop where the drill injects it; the wall
   time at which the committed steps reach 16, for the baseline (a save
   every 4 steps) and ``ckpt_interval:steps=2``.  Then ``FaultTolerantRunner``
   runs each drill (16 steps on ``SyntheticLM.batch_at(i)``, one failure
   before step 10, restores through ``CheckpointManager``), and once
   without a failure: one restart each, launches exact per executed step,
   final states equal to the uninterrupted one, the baseline within 10%
   and the what-if within 16% of their measured wall times (the medians of
   the 3 rounds' errors); last
   ``python -m repro_torch.launch.goodput`` on the drill step's capture;
11. moe: the moe family, moonshot-v1-16b-a3b, after every tinyllama tensor
   is freed (the memory still allocated printed and gated).  Served at full
   width and depth in bf16 (57.78 GB of weights) through
   ``ServeEngine.generate`` as in phase 4, launch counts exact (48 flash per
   prefill, all on the tensor-core kernel, 97 RMSNorm per forward), device
   time per prefill and decode step against the decode step's read bound
   (every expert's weights: the reference dispatches decode at capacity 1
   over all experts), logits finite.  At 2 layers in float32 on the same
   weights (attention rescaled): the kernel path against the plain path
   (``kernels/ref.py`` swapped in), expert indices and prefill logits
   gated; decode against a fresh prefill at the config's capacity
   (printed) and where no slot can drop (gated at the reference's MoE
   tolerance).  Trained at 2 layers, 1 x 4096, bf16, ``SyntheticLM``,
   ``Trainer.fit(AdamW(fused=True))``, through ``Prefetcher`` and again on
   batches made before the loop: launches exact per step, the loss
   split into cross-entropy and the aux term, every gradient finite, the
   router's and every expert's nonzero, ``moe_ffn`` forward and backward
   with syncs made errors.  Daydream's FusedAdam case on that step (phase
   6's gates) with a device-ms table by layer, then ``perf_report.trace_cell``
   of the fused step on meta tensors (2 / 5 / 1 kernel tasks), its
   simulated step printed against the measured one;
12. deepseek: the mla_moe family, deepseek-v2-236b, after every earlier
   tensor is freed (gated, and the free memory against the weights).
   Served at full width and 8 of its 60 layers in bf16 (65.65 GB of
   weights; depth the only cut) as in phase 11: launch counts exact (8
   flash per prefill, all on the tensor-core kernel at q/k head dim 192
   and v head dim 128, 33 RMSNorm per forward: ln1, q_norm, kv_norm, ln2
   per layer and the final norm), device time against the decode step's
   read bound.  At 2 layers in float32: phase 11's paths and gates.
   Forward and backward at full width and 2 layers, 1 x 4096 (no
   optimizer: its state does not fit), launches exact, the loss split
   into cross-entropy and aux, every gradient finite and nonzero; that
   step traced, simulated and held within 10% of its measured time; then
   ``perf_report.trace_cell`` of the served 8 layers' train_4k step on
   meta tensors (printed; all 60 layers took 30 s, given to phase 13);
13. ssm: the ssm family, mamba2-2.7b (no attention; the SSD chunked scan
   in plain PyTorch), after every earlier tensor is freed (gated).  Served
   at full width and depth in bf16 (5.66 GB) as in phase 11: launch counts
   exact (no flash, 129 RMSNorm per forward), device time per prefill and
   decode step against the decode step's read bound (every weight but the
   embedding table, and the constant-size cache read and written; the same
   ``_serve`` as phases 11 and 12); one
   request at a context of 512 and one of 8192, the engine's cache bytes
   gated equal, each decode step's device time beside the serving
   simulator's price.  At 2 layers in float32: prefill and decode logits
   through the kernel against its plain version, the engine's greedy tokens
   on both equal, decode against a fresh prefill within 1e-4.  Trained at
   full width and ``SSM_TRAIN_LAYERS`` layers (1 x 4096, bf16,
   ``Trainer.fit(AdamW(fused=True))``): launches exact per step, the peak
   memory under 70 GB, the loss falling over 5 steps on one batch, every
   gradient finite and nonzero (the reference's SSD form gives NaN at the
   config's chunk of 128), the 5 steps timed by CUDA events; the layer's
   five input products against one over the concatenated weights (printed).
   Daydream's FusedAdam case at ``SSM_WHATIF_LAYERS`` (16) layers, a
   host-bound step: phase 6's gates but the baseline against the measured
   step, printed beside the baseline calibrated on the step's unprofiled
   host time (ROADMAP C5), ``fused_optimizer`` predicted on the calibrated
   graph; a device-ms table by layer and the host lane's share;
   ``perf_report.trace_cell`` of all 64 layers and of the trained depth on
   meta tensors, the latter against the measured step (printed);
14. hybrid: the hybrid family, recurrentgemma-9b (12 groups of two RG-LRU
   sub-blocks and a local-attention one, window 2048, and 2 recurrent tail
   layers), after every earlier tensor is freed (gated).  Served at full
   width and depth in bf16 (20.9 GB) through ``_serve``: flash one a group
   per prefill (12), all on the tensor-core kernel with the window, 77
   RMSNorm per forward.  One request of 2560 tokens, past the window, at
   max_seq 4096 and 8192: the engine's cache bytes and tokens gated equal.
   At 4 layers in float32 (attention projections rescaled): prefill and
   decode logits through the kernels against their plain versions, the
   engine's greedy tokens on both equal, decode past the window against a
   fresh prefill within 1e-3.  Trained at 3 layers (one group, 1 x 4096,
   ``AdamW(fused=True)``, 4 steps on one batch timed by CUDA events): the
   loss falling, launches exact per step, the peak memory printed.  Its
   windowed flash row (1 x 4096, 16 query heads and one KV head of 256,
   window 2048; a sweep of windows in f32 and bf16, causal or not, and
   gradients, first) is checked and timed right after the ssm rows, beside
   the CUDA-core kernel, its plain version and SDPA with the same boolean
   mask;
15. serving: the serving simulator (``repro_torch.serving``) fitted to the
   engine and checked against it at full width, last, so that no profiled
   phase follows its launches.  ``measure_serving_costs`` of llama3.2-1b
   once, and of tinyllama-1.1b in each of ``SERVING_ROUNDS`` rounds, at 4
   requests x 512 prompt tokens (every constant finite and > 0; the ratio
   to the committed ``SERVING_COSTS`` printed).  Each round's tinyllama fit
   predicts that round's runs: the static drain of 4 x (256 prompt, 64 new
   tokens), another shape than the fit's, against the mean of the
   ``generate`` before and after the fit (median error within 10%), and
   ``static_slots:slots=8`` on 8 x (512, 64) from a baseline of two static
   batches of 4, against the ``generate`` of 8 that follows the fit (median
   error within 16%; both speedups above 1, the baseline measured in every
   third round); the serve phase's mixed prompts predicted and measured
   (printed); launch counts read around the whole phase, exact;
16. the card's name and power limit again (the limit the run ended under),
   the ``whatif``, ``amp``, ``traceio``, ``faults``, ``serving``, ``launch``,
   ``moe``, ``deepseek``, ``ssm``, ``hybrid``, ``phase_s`` (each phase's seconds,
   also printed as it ends) and ``kernels`` JSON lines (each kernel's
   ``launches`` from the launch phase's measured steps, DGC's from its own
   path, the windowed flash row's from the hybrid phase), then the last
   line ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line.  Without CUDA, or
without the repository's ``src`` beside this file, it fails at once.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.ckpt import (CheckpointManager, checkpoint_bytes,  # noqa: E402
                              latest_step)
from repro_torch.configs import (SERVING_COSTS, SHAPES, get_config,  # noqa: E402
                                 serving_cost)
from repro_torch.convert import state_from_reference, state_to_reference  # noqa: E402
from repro_torch.analysis import rank_opportunities  # noqa: E402
from repro_torch.core import (DEVICE_STREAM, H100_SXM, HOST_THREAD,  # noqa: E402
                              ClusterGraph, CostModel, GraphTransform,
                              Scenario, TaskKind, all_of, measure_wallclock,
                              on_device, simulate, trace_compiled,
                              trace_measured)
from repro_torch.core.analytical import graph_from_meta_events  # noqa: E402
from repro_torch.core.calibrate import (calibrated_cost_model,  # noqa: E402
                                        measure_local_backend)
from repro_torch.core.kineto import WAIT_CAT, WAIT_NAME, scale_host_lane  # noqa: E402
from repro_torch.core.trace import PACE_CALLS  # noqa: E402
from repro_torch.data import Prefetcher, SyntheticLM, make_batch  # noqa: E402
from repro_torch.faults import (FaultEvent, FaultScenario,  # noqa: E402
                                FaultTimeline, RecoveryModel)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import cost as kernel_cost  # noqa: E402
from repro_torch.kernels import flash_attention as flash_kernel  # noqa: E402
from repro_torch.kernels import fused_adam as adam_kernel  # noqa: E402
from repro_torch.kernels import rmsnorm as rmsnorm_kernel  # noqa: E402
from repro_torch.launch import perf_report  # noqa: E402
from repro_torch.models import (active_params, build_model,  # noqa: E402
                                cache_axes, count_params, init_cache, init_params,
                                loss_and_grads, loss_fn, make_train_step)
from repro_torch.models import moe as moe_layer  # noqa: E402
from repro_torch.optim import AdamW, opt_state  # noqa: E402
from repro_torch.optim.adamw import _flat_buffer  # noqa: E402
from repro_torch.runtime import FaultTolerantRunner, RetryPolicy  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.serving import (ServingPolicy, ServingScenario,  # noqa: E402
                                 explicit_workload)
from repro_torch.serving.measure import measure_serving_costs  # noqa: E402
from repro_torch.traceio import load_trace_dir  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

DEV = "cuda"
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores (data sheet)
PEAK_F32_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
FLASH_SWEEP = [(1, 2, 1, 128, 64), (2, 4, 2, 256, 128), (1, 8, 2, 96, 80),
               (1, 1, 1, 64, 128)]                   # (B, H, KH, S, D)
# the tensor-core kernel's edges: S not a multiple of its 128-row tiles,
# GQA group 8, D 80 (run as 128) and 128; forward only
FLASH_EDGES = [(1, 8, 1, 300, 64), (2, 32, 4, 1024, 64), (1, 4, 1, 200, 80),
               (1, 2, 2, 130, 128)]
# bf16 head dims below 64 and between 64 and 128 (run in the 64- and 128-column
# buckets with TMA zero-fill) and S below one tile, S = 1 a one-token prompt:
# the smoke configs' head dim is 16; forward only
FLASH_SMALL = [(1, 4, 2, S, D) for D in (16, 32, 96) for S in (1, 7, 64)]
# bf16 inputs that the CUDA-core kernel takes: D % 8 != 0, and rows padded to
# D + 4 elements (an S stride that is no multiple of 8)
FLASH_SCALAR_BF16 = [((1, 4, 2, 100, 12), 0), ((2, 4, 1, 96, 64), 4)]
# q/k and v of their own head dims (B, H, KH, S, D, Dv): MLA's 192 and 128
# (the tensor-core kernel's (192, 128) bucket, 2 K/V stages), its smoke
# config's 24 and 16, and the buckets' edges; forward, and the gradients
# through FlashAttentionFn at FLASH_MLA_GRAD
FLASH_MLA = [(1, 4, 4, 300, 192, 128), (2, 8, 2, 130, 192, 128), (1, 4, 4, 64, 24, 16),
             (1, 4, 2, 200, 192, 16), (1, 4, 4, 100, 24, 128), (1, 2, 2, 1, 192, 128),
             (1, 4, 4, 257, 136, 128)]
FLASH_MLA_GRAD = [(1, 4, 4, 256, 192, 128), (1, 4, 2, 96, 24, 16)]
# head dim 256, the tensor-core kernel's (256, 256) bucket in bf16 (64-key
# tiles) and the CUDA-core kernel in f32, each bf16 case through the
# CUDA-core kernel too: recurrentgemma-9b's MQA (16 query heads, one KV
# head; the reference's src/repro/configs/recurrentgemma_9b.py) from one
# token to 1024, and v of 256 and of 128 beside q/k 256; forward, and the
# gradients at FLASH_D256_GRAD; timed at RG_SERVE (B, H, KH, S, D): its
# serve prefill
FLASH_D256 = [(1, 16, 1, S, 256) for S in (1, 7, 300, 1024)] + [
    (2, 4, 2, 130, 256, 256), (2, 4, 2, 130, 256, 128)]
FLASH_D256_GRAD = [(1, 4, 1, 256, 256)]
RG_SERVE = (4, 16, 1, 512, 256)
RMS_SWEEP = [(4, 64), (3, 5, 300), (16, 1024), (1, 7)]
# RMSNorm's other paths: the families' widths (deepseek's 1536, mamba2's 2560
# and 5120, recurrentgemma's 4096: two to eight warps a row), rows past
# the register widths (the loop over the row in chunks) and an odd width
# (one element a load); and each width again with x one element past an
# aligned base (one element a load, in chunks past 1280 columns)
RMS_WIDE = [(64, 1536), (64, 2560), (64, 5120), (16, 4096), (8, 20000), (3, 2049)]
# fused_adam: the JAX package's sizes, and the ring's edges: no entry, less
# than one 16-byte chunk, a chunk and a tail, a tile and one entry either
# side (and, added in adam_dgc_phase, a full ring for every block of the
# grid plus a tail of 3); each with all four vectors 16-byte aligned and
# with one of them an entry off (the plain loop)
ADAM_SWEEP = [100, 1024, 5000, 1 << 14, 0, 1, 3, 4, 5, adam_kernel.TILE - 1,
              adam_kernel.TILE, adam_kernel.TILE + 1]
ADAM_OFFSETS = [(0, 0, 0, 0), (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1)]
DGC_SWEEP = [((100,), 0.1), ((123, 45), 0.01), ((4096,), 0.001)]
FLASH_ATOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
RMS_ATOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
GRAD_ATOL = {torch.float32: 5e-3, torch.bfloat16: 5e-2}
# plus this share of |reference|: two bf16 gradients rounded from f32 sums
# that differ in the last bits can differ by one bf16 ulp (<= 2^-7 |x|),
# which passes the atol where a gradient sums thousands of rows (dv, dk of
# early keys at S = 4096; RMSNorm's dw)
GRAD_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
ADAM_KW = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, c1=0.2, c2=0.1)
ADAM_ATOL = (1e-5, 1e-6, 1e-6)                       # p, m, v
PROMPT_LENS = [128, 256, 384, 512]
NEW_TOKENS = 32
TRAIN_BATCH, TRAIN_SEQ = 2, 4096     # the repo's train_4k shape, micro-batch 2
TRAIN_STEPS = 4                      # one warm-up step, then 3 timed
WHATIF_ITERS = 5                     # timed steps per measure_wallclock call
FIDELITY_TOL, PREDICT_TOL = 0.10, 0.16   # simulated vs measured; paper's band
DGC_RATIO = 0.01
ARCH = "tinyllama-1.1b"
PT_TRACE = "step.pt.trace.json.gz"   # a capture as torch.profiler exports it
ROUNDTRIP_TOL = 1e-6                 # tests/golden/trace_roundtrip.json's bound
# launch phase: the calibration sizes (the reference's CPU defaults, then a
# size that fills the card), the data sheet each reading is held under, the
# cheap operators timed with and without torch.profiler, the per-device
# train_4k step of the reference's 256-chip data-parallel cell, and the CLIs
CAL_SIZES = [(1024, "float32"), (8192, "float32"), (8192, "bfloat16")]
PEAK_F32_FLOPS = 67e12               # H100 SXM dense f32, CUDA cores (data sheet)
PEAK_TF32_FLOPS = 494.7e12           # the same with TF32 tensor cores
SHEET_TOL = 1.05                     # a reading above this x the sheet is impossible
PROFILER_OPS, PROFILER_ROUNDS = 2000, 5
LAUNCH_SHAPE, LAUNCH_CHIPS = "train_4k", 256
LAUNCH_RUNS = 3                      # measure_wallclock calls of WHATIF_ITERS steps
CLI_TIMEOUT_S = 400
# faults phase: one synchronous save after CKPT_STEPS steps at full depth;
# drills of DRILL_STEPS steps of DRILL_BATCH x TRAIN_SEQ tokens at
# DRILL_LAYERS layers (a 2.63 GB checkpoint each time, where full depth
# writes 13.2 GB), a save every DRILL_EVERY steps, one failure injected
# before step DRILL_FAIL, restarted at once (no backoff); the what-if saves
# every WHATIF_EVERY steps; the median of DRILL_ROUNDS rounds is gated.
# The checkpoint cost is fitted before the drills to SAMPLE_WINDOWS samples
# of their operations.  The mount's pace moves from one drill to the next by
# ~7% and a sample does not foresee it (ROADMAP C10): checkpoints were ~82%
# of a drill's wall time at 4 layers and steps of 2 sequences, ~60% at 4
# and 6; 2 layers and steps of 8 keep that share and take back ~70 s of the
# phase for the ssm phase
CKPT_STEPS = 3
DRILL_KEEP = 3                       # the drills' manager keeps CheckpointManager's default
DRILL_LAYERS, DRILL_STEPS, DRILL_EVERY, DRILL_FAIL = 2, 16, 4, 10
DRILL_BATCH = 8
SAMPLE_WINDOWS = 2
WHATIF_EVERY = 2
DRILL_BACKOFF_S = 0.0
DRILL_ROUNDS = 3
DRILL_HORIZON_S = 3600.0             # simulated wall clock, far past the drill
# serving phase: the cost model fitted at the serve shape (4 x 512 prompt
# tokens, the serve phase's batch without its padding) for ARCH and for the
# registry's other dense arch that fits the card; the fidelity workload, at
# another shape than the fit's, and the what-if's
FIT_ONLY_ARCH = "llama3.2-1b"
FIT_BATCH, FIT_PROMPT, FIT_MAX_SEQ = 4, 512, 576
FIDELITY_PROMPT, FIDELITY_NEW = 256, 64
WHATIF_NEW = 64                      # new tokens per request
WHATIF_REQUESTS, WHATIF_SLOTS = 8, 8 # one static batch of 8 against two of 4
# The engine is host-bound, and the host's pace on the card's machine drifts
# by 10-20% over seconds (PERF.md, serving): each round's fit predicts the
# runs next to it, and the gates read the median of the rounds' errors (11
# rounds until the deepseek phase needed the time)
SERVING_ROUNDS = 5
# moe phase: moonshot-v1-16b-a3b served at full width and depth, and trained
# at MOE_TRAIN_LAYERS layers (20 B per parameter for the fused step: 2 layers
# are 36.9 GB, 4 would be 59.8 GB before activations), one sequence of
# TRAIN_SEQ per step.  The 2-layer float32 model on the same weights is run
# through the kernels and through their plain versions: the share of equal
# expert indices must be at least MOE_ROUTE_SHARE and the prefill logits
# within MOE_LOGITS_RTOL of their largest magnitude.  Decode against a fresh
# prefill is held to the reference's MoE tolerance (tests/test_models.py:
# top-1 agreement >= 0.5, relative max error < 0.15)
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH = 2, 1
MOE_ROUTE_SHARE, MOE_LOGITS_RTOL = 0.999, 1e-3
MOE_TOP1, MOE_REL = 0.5, 0.15
MOE_HELD_GB = 2.0                    # device memory allowed to outlive the phases before
# deepseek phase: deepseek-v2-236b (MLA + MoE) at full width, served at
# DEEPSEEK_SERVE_LAYERS of its 60 layers (7.944 GB of bf16 a layer; 8 layers
# and the embeddings are 65.65 GB) and run forward and backward at
# DEEPSEEK_TRAIN_LAYERS layers; the free device memory must exceed the
# served weights by DEEPSEEK_MARGIN_GB.  The 2-layer float32 paths take the
# moe phase's gates
DEEPSEEK_ARCH = "deepseek-v2-236b"
DEEPSEEK_SERVE_LAYERS, DEEPSEEK_TRAIN_LAYERS = 8, 2
DEEPSEEK_MARGIN_GB = 6.0
# ssm phase: mamba2-2.7b (attention-free; 5.66 GB of bf16) served at full
# width and depth, one request at each of SSM_CONTEXTS (the decode cache's
# bytes gated equal), the float32 paths at SSM_PATH_LAYERS layers (decode
# against a fresh prefill within SSM_DECODE_RTOL: tests/test_torch_ssm.py's
# tolerance), and trained at SSM_TRAIN_LAYERS layers, the largest multiple
# of 8 whose fused step peaks under SSM_PEAK_GB, one sequence of TRAIN_SEQ
SSM_ARCH = "mamba2-2.7b"
SSM_TRAIN_LAYERS, SSM_PATH_LAYERS = 32, 2
SSM_WHATIF_LAYERS = 16               # Daydream's traced step: a cut for the script's time
SSM_PEAK_GB = 70.0
SSM_CONTEXTS = (512, 8192)
SSM_CONTEXT_NEW = 8
SSM_DECODE_RTOL = 1e-4
# hybrid phase: recurrentgemma-9b (12 groups of two RG-LRU sub-blocks and a
# local-attention one, window 2048, and 2 recurrent tail layers; 20.9 GB of
# bf16) served at full width and depth; one request of HYBRID_PAST prompt
# tokens, past the window, at each max_seq of HYBRID_CACHE_SEQS (the
# engine's cache bytes and tokens gated equal); the float32 paths at
# HYBRID_PATH_LAYERS layers (a group and a tail layer; decode
# against a fresh prefill past the window within HYBRID_DECODE_RTOL: f32
# sums in another order through 4 layers); trained at HYBRID_TRAIN_LAYERS
# layers (one group), HYBRID_TRAIN_STEPS fused-AdamW steps on one batch of
# 1 x TRAIN_SEQ; the phase's budget HYBRID_BUDGET_S (printed)
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_PAST, HYBRID_CACHE_SEQS = 2560, (4096, 8192)
HYBRID_PATH_LAYERS, HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_STEPS = 4, 3, 4
HYBRID_DECODE_RTOL = 1e-3
HYBRID_BUDGET_S = 90.0
# the local window on both kernels (B, H, KH, S, D, window[, Dv]), f32 and
# bf16, causal and not: the smoke config's 16 at window 8, head dims 64 to
# 256 with windows of one key, inside S and past it; at head dim 256 (the
# tensor-core kernel's 64-key tiles) windows whose edge falls inside a tile
# (1, 63, 65, 300), windows of S and more, S not a multiple of 64 or 128,
# KH 1 and 2, q/k 256 with v 128; the gradients through FlashAttentionFn
# (the windowed plain backward) at FLASH_WINDOW_GRAD
FLASH_WINDOW = [(2, 4, 1, 37, 16, 8), (1, 16, 1, 300, 256, 64), (1, 4, 2, 130, 64, 1),
                (1, 8, 1, 200, 128, 256), (1, 16, 1, 1024, 256, 300),
                (1, 4, 1, 333, 256, 1), (1, 4, 2, 333, 256, 63), (1, 4, 1, 333, 256, 65),
                (1, 4, 2, 700, 256, 300), (1, 4, 1, 200, 256, 200), (1, 4, 2, 200, 256, 500),
                (1, 4, 1, 333, 256, 65, 128), (1, 4, 2, 257, 192, 63, 128)]
FLASH_WINDOW_GRAD = [(2, 4, 1, 37, 16, 8), (1, 4, 1, 256, 256, 64)]
# device timing: a torch.profiler session with no device record is run again,
# up to PROFILE_TRIES sessions; a kernel row's profiler time must lie within
# PROFILE_TOL of its CUDA-event time on the same calls, less PROFILE_GAP_MS
# per device operation for the device's gaps between back-to-back kernels,
# which the events include; a session outside that band is printed and run
# again, and the row fails if none of PROFILE_TRIES sessions is inside it
PROFILE_TRIES = 3
PROFILE_TOL, PROFILE_GAP_MS = 0.05, 0.003


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync() -> None:
    torch.cuda.synchronize()


def call_ms(fn, iters: int = 50) -> float:
    """Mean time per call of ``fn`` over back-to-back calls (CUDA events).
    Where the host launches slower than the device runs, this is host time."""
    for _ in range(3):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def prime_profiler() -> None:
    """One throwaway torch.profiler session before the measured ones: the
    first CUPTI session of a process once came back with no device record
    at all (one run in about fifteen on the H100)."""
    x = torch.ones(1 << 20, device=DEV)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        for _ in range(10):
            x.mul_(1.0)
        sync()


class Profile(NamedTuple):
    ms: float            # device ms per call
    ops: int             # device operations per call
    host_ms: float       # host ms per call, the profiler's own cost included
    top: list            # the 8 largest (device ms per call, op name)
    records: int         # device records in the session
    unscaled_ms: float   # the records' device time over the calls made
    span_ms: float       # first record's start to last record's end, over the calls
    session: int = 1     # which of profiled_event_ms's sessions this is


def _device_records(prof) -> list:
    """The device operations of a torch.profiler session: the model's
    record_function scopes also show as spans on the device timeline
    (gpu_user_annotation), and they are no device work."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def _scaled(ops_: list, iters: int, host_ms: float) -> Profile:
    """Each op name's time per call from ``iters`` calls' records: its
    recorded mean times its records over ``iters``, rounded up (see
    ``device_profile``)."""
    us = sum(e.time_range.elapsed_us() for e in ops_)
    by_name = {}
    for e in ops_:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    per_call = {name: math.ceil(n / iters) for name, (n, _) in by_name.items()}
    us_call = {name: t / n * per_call[name] for name, (n, t) in by_name.items()}
    n_ops = sum(per_call.values())
    if n_ops * iters != len(ops_):
        print(f"device_profile: {len(ops_)} device records over {iters} calls, not "
              f"{n_ops} per call: each op's time per call is its recorded mean x its "
              f"calls")
    top = sorted(((t / 1e3, n[:70]) for n, t in us_call.items()), reverse=True)[:8]
    span = max(e.time_range.end for e in ops_) - min(e.time_range.start for e in ops_)
    return Profile(sum(us_call.values()) / 1e3, max(1, n_ops), host_ms, top,
                   len(ops_), us / iters / 1e3, span / iters / 1e3)


def device_profile(fn, iters: int = 20, warmup: int = 3) -> Profile:
    """The CUDA kernels and copies that torch.profiler records over ``iters``
    calls of ``fn``, after ``warmup`` calls, and the host clock over them
    (ending in a sync).  Every call launches the same operations, but CUPTI
    drops records (19 of 20 single-kernel calls, session after session, and
    once about half of them, for a cause not known: ROADMAP C19) and was never
    seen to add one, so each op name's time per call is its recorded mean
    times its records over ``iters``, rounded up: exact while fewer than
    ``iters`` of its records are lost.
    ``timings`` holds this against CUDA events.  A session with no device
    record at all (seen after sessions of tens of thousands of records) is
    run again, up to PROFILE_TRIES sessions."""
    for _ in range(warmup):
        fn()
    sync()
    for attempt in range(1, PROFILE_TRIES + 1):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            sync()
            host = time.perf_counter() - t0
        ops_ = _device_records(prof)
        if sum(e.time_range.elapsed_us() for e in ops_) > 0:
            return _scaled(ops_, iters, host / iters * 1e3)
        print(f"device_profile: session {attempt} of {PROFILE_TRIES} recorded no device time")
    fail("torch.profiler recorded no device time")


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms() -> float:
    """The rate of ``torch.cuda._sleep``'s cycles, by CUDA events."""
    cycles = 1 << 24
    torch.cuda._sleep(cycles)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def _host_queue_ms(fn, iters: int) -> tuple[float, float]:
    """Host ms to queue ``iters`` calls of ``fn``, and to queue them and
    sync, after 3 calls."""
    for _ in range(3):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queued = time.perf_counter() - t0
    sync()
    return queued * 1e3, (time.perf_counter() - t0) * 1e3


def event_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn`` by CUDA events, with the host's launch
    cost hidden: a sleep kernel queued first holds the device until the host
    has queued all ``iters`` calls, which then run back to back (the device's
    gaps between kernels included).  The sleep is twice the host time of
    ``iters`` calls ending in a sync, and four times longer again if the
    host was still queueing when it ended."""
    sleep_ms = 2 * _host_queue_ms(fn, iters)[1] + 1.0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(PROFILE_TRIES):
        torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms()))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if queued_ms < sleep_ms:
            return start.elapsed_time(end) / iters
        sleep_ms *= 4
    fail(f"event_ms: the host took {queued_ms:.3f} ms to queue {iters} calls, "
         f"longer than the device's sleep")


@functools.lru_cache(maxsize=None)
def _sleep_names() -> frozenset:
    """The names torch.profiler gives ``torch.cuda._sleep``'s kernel: ATen's
    ``spin_kernel`` and whatever a session of three sleeps records."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            torch.cuda._sleep(1000)
        sync()
    return frozenset(e.name for e in _device_records(prof)) | {"spin_kernel"}


def profiled_event_ms(fn, iters: int = 20) -> tuple[Profile, float]:
    """``device_profile`` and ``event_ms`` of the same ``iters`` calls: one
    torch.profiler session holds an event, the sleep kernel, the start event,
    the calls and the end event, so the two clocks time the same executions.
    Timed apart, they also timed the kernel's own drift from one window to
    the next (flash attention at the MLA train shape on an H100: 1.99 ms in
    one window, 1.88 ms in the next).  The sleep kernel's record
    (``_sleep_names``) is left out of the profile.  Its host time is the time
    to queue the calls.  The calls ran back to back only if the host had
    queued them all, from the first event on, within the sleep as the events
    time it: the profiler slows the host's launches (an RMSNorm launch,
    through Triton then, to ~90 us beside an H100), and a sleep sized from
    the host's pace without it once ended first.  So the sleep is 8 times
    that pace plus 4 ms, and a session that fails this, or that has no
    device record, is run again (the sleep four times longer), up to
    PROFILE_TRIES sessions.  So is a session whose profiler time lies
    outside ``profile_band`` of its events (CUPTI once read the MLA serve
    row 6.7% short of its events on an H100, ROADMAP C19): it is
    printed, and the last session is returned, inside the band or not, for
    ``timings`` to hold."""
    sleep_ms = 8 * _host_queue_ms(fn, iters)[0] + 4.0
    cycles_per_ms = _sleep_cycles_per_ms()
    _sleep_names()
    first, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    for attempt in range(1, PROFILE_TRIES + 1):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            first.record()
            torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            queued_ms = (time.perf_counter() - t0) * 1e3
            end.synchronize()
        slept_ms = first.elapsed_time(start)
        ops_ = [e for e in _device_records(prof)
                if not any(n in e.name for n in _sleep_names())]
        if queued_ms >= slept_ms:
            print(f"profiled_event_ms: session {attempt} of {PROFILE_TRIES}: the host took "
                  f"{queued_ms:.3f} ms to queue {iters} calls, the device slept "
                  f"{slept_ms:.3f} ms")
            sleep_ms = 4 * max(sleep_ms, queued_ms)
        elif sum(e.time_range.elapsed_us() for e in ops_) <= 0:
            print(f"profiled_event_ms: session {attempt} of {PROFILE_TRIES} recorded no "
                  f"device time")
        else:
            prof_ = _scaled(ops_, iters, queued_ms / iters)._replace(session=attempt)
            ev = start.elapsed_time(end) / iters
            lo, hi = profile_band(prof_, ev)
            if lo <= prof_.ms <= hi or attempt == PROFILE_TRIES:
                return prof_, ev
            print(f"profiled_event_ms: session {attempt} of {PROFILE_TRIES}: torch.profiler "
                  f"{prof_.ms:.5f} ms per call ({prof_.records} records, "
                  f"{prof_.unscaled_ms:.5f} ms unscaled, spanning {prof_.span_ms:.5f} ms a "
                  f"call), CUDA events on the same calls {ev:.5f} ms (need {lo:.5f} to "
                  f"{hi:.5f})")
    fail(f"profiled_event_ms: no session of {PROFILE_TRIES} recorded the calls behind "
         f"the sleep")


def profile_band(prof: Profile, ev: float) -> tuple[float, float]:
    """The profiler times per call that agree with CUDA events' ``ev`` on the
    same calls: within PROFILE_TOL, less PROFILE_GAP_MS per device operation
    below (the events hold the device's gaps between kernels)."""
    return ev * (1 - PROFILE_TOL) - PROFILE_GAP_MS * prof.ops, ev * (1 + PROFILE_TOL)


def device_ms(fn, iters: int = 20) -> float:
    return device_profile(fn, iters).ms


def timings(name: str, kernel, plain, library, iters: int = 20) -> dict:
    """The kernel's, its plain version's and the library call's device ms
    (torch.profiler) and ms per back-to-back call; the kernel's profiler
    time held against CUDA events on the same calls (``profiled_event_ms``)
    within ``profile_band``, in one of PROFILE_TRIES sessions.  CUDA
    events on other calls with no profiler on (``event_ms``) are printed and
    kept beside them as ``event_ms_apart``."""
    prof, ev = profiled_event_ms(kernel, iters)
    apart = event_ms(kernel, iters)
    lo, hi = profile_band(prof, ev)
    print(f"kernels: {name}: torch.profiler {prof.ms:.5f} ms per call ({prof.records} "
          f"device records over {iters} calls of {prof.ops} ops, {prof.unscaled_ms:.5f} ms "
          f"unscaled, session {prof.session}), CUDA events on the same calls {ev:.5f} ms "
          f"(need {lo:.5f} to {hi:.5f}), apart with no profiler {apart:.5f} ms")
    if not lo <= prof.ms <= hi:
        fail(f"{name}: torch.profiler's {prof.ms:.5f} ms per call disagrees with CUDA "
             f"events' {ev:.5f} ms on the same calls")
    return {"ms": prof.ms, "event_ms": ev, "event_ms_apart": apart,
            "profiler": {"records": prof.records, "calls": iters, "ops_per_call": prof.ops,
                         "unscaled_ms": prof.unscaled_ms, "span_ms": prof.span_ms,
                         "session": prof.session},
            "plain_ms": device_ms(plain, 5),
            "library_ms": device_ms(library, iters),
            "call_ms": {"kernel": call_ms(kernel, iters), "plain": call_ms(plain, 5),
                        "library": call_ms(library, iters)}}


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def _autograd(fn, inputs, dout):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, dout)


# --------------------------------------------------------------- phases
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def device_phase() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(card())
    return name


def build_phase() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: nvcc {time.perf_counter() - t0:.2f}s for the {len(libs)} sources "
          f"{sorted(libs)}, one nvcc each, all at once")
    demangle = shutil.which("cu++filt") or shutil.which("c++filt")
    for path in libs.values():
        log = path.with_suffix(".log").read_text()
        for line in log.splitlines():
            if any(w in line for w in ("Performance", "setmaxnreg")):
                print(f"  ptxas {path.stem.split('-')[0]}:", line.strip()[:160])
        kernels = _ptxas_report(log, demangle)
        spilled = [k for k, (_, spill) in kernels.items() if spill]
        print(f"  ptxas {path.stem.split('-')[0]}: {len(kernels)} kernels, registers "
              f"{min(r for r, _ in kernels.values())}-{max(r for r, _ in kernels.values())}"
              f", {len(spilled)} with spills" + "".join(
                  f"\n    {k}: {r} registers, {sp} B spilled" for k, (r, sp) in kernels.items()
                  if sp or any(w in k for w in ("256", "rmsnorm_rows<__nv_bfloat16, __"))))


def _ptxas_report(log: str, demangle) -> dict:
    """nvcc's ``-Xptxas -v`` report: kernel -> (registers, spill bytes
    stored and loaded), the names demangled where a demangler is found."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            cur = m.group(1)
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                     line)):
            out[cur] = (out.get(cur, (0, 0))[0], int(m[1]) + int(m[2]))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            out[cur] = (int(m[1]), out.get(cur, (0, 0))[1])
    if demangle and out:
        names = subprocess.run([demangle, "-p"], input="\n".join(out), text=True,
                               capture_output=True, timeout=60).stdout.split("\n")
        if len(names) >= len(out):
            out = {n.replace("(anonymous namespace)::", ""): v
                   for n, v in zip(names, out.values())}
    return out


def _sdpa_backends(q, k, v) -> dict:
    """Which of SDPA's backends take q, k, v (causal): backend -> "ran" or
    "refused"."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([be]):
                F.scaled_dot_product_attention(q, k, v, is_causal=True)
            out[be.name] = "ran"
        except RuntimeError:
            out[be.name] = "refused"
    sync()
    return out


def _flash_entry(gen, cfg, batch: int, seq: int) -> dict:
    """Flash attention at a main-path shape, as the model passes it: bf16
    (B, S, H, hd) views, causal, q/k and v of the config's head dims
    (``perf_report.flash_head_dims``: MLA's 192 and 128); checked (the
    CUDA-core kernel too, called directly), then both kernels, the plain
    version and SDPA timed (where v has its own head dim, which of SDPA's
    backends take it is printed)."""
    H, KH = cfg.n_heads, cfg.n_kv_heads
    D, Dv = perf_report.flash_head_dims(cfg)
    bf = torch.bfloat16
    q = randn(gen, batch, seq, H, D, dtype=bf).transpose(1, 2)
    k = randn(gen, batch, seq, KH, D, dtype=bf).transpose(1, 2)
    v = randn(gen, batch, seq, KH, Dv, dtype=bf).transpose(1, 2)
    # the rows of a single head dim keep the call they were first timed with
    gqa = {"enable_gqa": True} if Dv == D else {}
    want = ref.flash_attention_ref(q, k, v)
    err = max_err(ops.flash_attention(q, k, v), want)
    scalar_err = max_err(flash_kernel.flash_attention_scalar(q, k, v), want)
    variant = flash_kernel._variant(q, k, v)
    if not (err <= FLASH_ATOL[bf] and scalar_err <= FLASH_ATOL[bf] and variant == "wgmma"):
        fail(f"flash at {tuple(q.shape)}: {err} ({variant}), CUDA-core kernel {scalar_err}")
    del want
    entry = {"max_abs_err": err,
             **timings(f"flash_attention q {tuple(q.shape)}",
                       lambda: ops.flash_attention(q, k, v),
                       lambda: ref.flash_attention_ref(q, k, v),
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, is_causal=True, **gqa)),
             "scalar_ms": device_ms(lambda: flash_kernel.flash_attention_scalar(q, k, v), 5),
             "scalar_max_abs_err": scalar_err,
             **bound(*kernel_cost.flash_attention(batch, H, KH, seq, D, D_v=Dv,
                                                  causal=True, itemsize=2)),
             "shape": (f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal" if Dv == D
                       else f"q/k {tuple(q.shape)} v {tuple(v.shape)} bf16 causal")}
    entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
    entry["ratio_to_library"] = entry["ms"] / entry["library_ms"]
    if Dv != D:
        entry["sdpa_backends"] = _sdpa_backends(q, k, v)
        print(f"kernels: SDPA's backends at {entry['shape']}: {entry['sdpa_backends']} "
              f"(the library row is SDPA's own choice)")
    print(f"kernels: flash at {entry['shape']}: tensor-core kernel {entry['ms']:.5f} ms "
          f"device ({entry['share_of_bound']:.1%} of its {entry['bound_ms']:.5f} ms bound, "
          f"by {entry['bound_by']}), CUDA-core kernel {entry['scalar_ms']:.5f} ms, SDPA "
          f"{entry['library_ms']:.5f} ms (ratio {entry['ratio_to_library']:.3f}), plain "
          f"{entry['plain_ms']:.4f} ms")
    return entry


def _flash_d256_entry(gen) -> dict:
    """Flash attention at recurrentgemma-9b's serve prefill (RG_SERVE: 4 x
    512 tokens, 16 query heads and one KV head of 256) as bf16 (B, S, H, D)
    views, causal: it must launch the tensor-core kernel (its (256, 256)
    bucket); checked (the CUDA-core kernel too, called directly), then timed
    beside the CUDA-core kernel, its plain version and SDPA and bounded."""
    B, H, KH, S, D = RG_SERVE
    bf = torch.bfloat16
    q, k, v = (randn(gen, B, S, h, D, dtype=bf).transpose(1, 2) for h in (H, KH, KH))
    want = ref.flash_attention_ref(q, k, v)
    out, variant = _counted_variant(lambda: ops.flash_attention(q, k, v))
    err = max_err(out, want)
    scalar_err = max_err(flash_kernel.flash_attention_scalar(q, k, v), want)
    if not (err <= FLASH_ATOL[bf] and scalar_err <= FLASH_ATOL[bf] and variant == "wgmma"):
        fail(f"flash at {tuple(q.shape)}: {err} on {variant} (want wgmma), CUDA-core "
             f"kernel {scalar_err}")
    del want
    entry = {"max_abs_err": err, "variant": variant,
             **timings(f"flash_attention q {tuple(q.shape)} (head dim 256)",
                       lambda: ops.flash_attention(q, k, v),
                       lambda: ref.flash_attention_ref(q, k, v),
                       lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              enable_gqa=True)),
             "scalar_ms": device_ms(lambda: flash_kernel.flash_attention_scalar(q, k, v), 5),
             "scalar_max_abs_err": scalar_err,
             **bound(*kernel_cost.flash_attention(B, H, KH, S, D, causal=True, itemsize=2)),
             "shape": f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal"}
    entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
    entry["ratio_to_library"] = entry["ms"] / entry["library_ms"]
    print(f"kernels: flash at {entry['shape']}: tensor-core kernel {entry['ms']:.5f} ms "
          f"device ({entry['share_of_bound']:.1%} of its {entry['bound_ms']:.5f} ms bound, "
          f"by {entry['bound_by']}), CUDA-core kernel {entry['scalar_ms']:.5f} ms, SDPA "
          f"{entry['library_ms']:.5f} ms (ratio {entry['ratio_to_library']:.3f}), plain "
          f"{entry['plain_ms']:.4f} ms")
    return entry


def _flash_inputs(gen, B, H, KH, S, D, dt, layout: str, pad: int = 0, Dv=None):
    """q, k as (B, H|KH, S, D) and v as (B, KH, S, Dv) (Dv defaults to D):
    contiguous ("bhsd"), (B, S, H, D) tensors viewed ("bshd"), or rows of
    D + pad elements cut to D ("padded")."""
    dims = ((H, D), (KH, D), (KH, D if Dv is None else Dv))
    if layout == "bshd":
        return tuple(randn(gen, B, S, h, d, dtype=dt).transpose(1, 2) for h, d in dims)
    return tuple(randn(gen, B, h, S, d + pad, dtype=dt)[..., :d] for h, d in dims)


def _want_variant(dt, D: int, Dv: int, pad: int = 0) -> str:
    """The flash kernel an input must take, with or without a window:
    ``wgmma`` for bf16 with both head dims multiples of 8 within its buckets
    (up to 256) and aligned rows, ``scalar`` for the rest."""
    return ("wgmma" if dt == torch.bfloat16 and D % 8 == 0 and Dv % 8 == 0
            and pad % 8 == 0 and D <= flash_kernel.WGMMA_MAX_D
            and Dv <= flash_kernel.WGMMA_MAX_D_V else "scalar")


def _counted_variant(call) -> tuple:
    """``call()``'s result and the flash kernel it launched, read from the
    launch counts per kernel (``launches_by_variant``); None unless exactly
    one launch was counted."""
    before = dict(flash_kernel.launches_by_variant)
    out = call()
    rose = {v: n - before[v] for v, n in flash_kernel.launches_by_variant.items()
            if n != before[v]}
    return out, (next(iter(rose)) if list(rose.values()) == [1] else None)


def flash_sweep(gen, shapes) -> float:
    """Flash attention against its plain version over ``shapes`` ((B, H, KH,
    S, D) or (B, H, KH, S, D, Dv)) in f32 and bf16, causal and not,
    contiguous and as (B, S, H, D) views, and over the bf16 inputs that the
    CUDA-core kernel takes; prints the kernel each case launched (by the
    launch counts per kernel) and fails unless f32 and those bf16 inputs
    launched "scalar" and every other bf16 input "wgmma", which the
    CUDA-core kernel, called directly, must then match too.  Returns the
    largest error."""
    cases = [(s, dt, c, layout, 0) for dt in (torch.float32, torch.bfloat16)
             for c in (True, False) for s in shapes for layout in ("bhsd", "bshd")]
    cases += [(s, torch.bfloat16, c, "padded", pad) for s, pad in FLASH_SCALAR_BF16
              for c in (True, False)]
    worst, bad, took = 0.0, [], {}
    for (B, H, KH, S, D, *rest), dt, causal, layout, pad in cases:
        Dv = rest[0] if rest else D
        q, k, v = _flash_inputs(gen, B, H, KH, S, D, dt, layout, pad, Dv)
        want = _want_variant(dt, D, Dv, pad)
        out, variant = _counted_variant(lambda: ops.flash_attention(q, k, v, causal=causal))
        plain = ref.flash_attention_ref(q, k, v, causal=causal)
        err = max_err(out, plain)
        if variant == "wgmma":
            err = max(err, max_err(flash_kernel.flash_attention_scalar(q, k, v, causal=causal),
                                   plain))
        worst = max(worst, err)
        name = f"{(B, H, KH, S, D, *rest)} {str(dt)[6:]} causal={causal} {layout}"
        took.setdefault(str(variant), []).append(name)
        if not (err <= FLASH_ATOL[dt] and variant == want):
            bad.append(f"flash {name}: {err} on {variant} (want {want})")
    sync()
    for variant, names in sorted(took.items()):
        print(f"kernels: flash took {variant!r} for {len(names)} cases: " + "; ".join(names))
    if bad:
        fail("flash kernel disagrees with its plain version or took the wrong kernel: "
             + "; ".join(bad))
    return worst


def _rms_entry(gen, cfg, rows: int, cols: int = 0, width: int = 0) -> dict:
    """RMSNorm at a main-path shape, bf16, over ``cols`` columns (default
    d_model) of rows ``width`` apart (default ``cols``; MLA's kv_norm reads
    512 of 576): checked against its plain version (failing past RMS_ATOL),
    then the kernel, the plain version and ``F.rms_norm`` timed."""
    cols = cols or cfg.d_model
    x = randn(gen, rows, width or cols, dtype=torch.bfloat16)[:, :cols]
    w = randn(gen, cols, dtype=torch.bfloat16)
    err = max_err(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w))
    if not err <= RMS_ATOL[torch.bfloat16]:
        fail(f"rmsnorm at {tuple(x.shape)} bf16: max abs err {err} "
             f"(atol {RMS_ATOL[torch.bfloat16]})")
    return {"max_abs_err": err,
            **timings(f"rmsnorm x {tuple(x.shape)}",
                      lambda: ops.rmsnorm(x, w), lambda: ref.rmsnorm_ref(x, w),
                      lambda: F.rms_norm(x, (cols,), w, 1e-6)),
            **bound(*kernel_cost.rmsnorm(rows, cols, itemsize=2)),
            "shape": f"x {tuple(x.shape)} bf16" + (f", rows {width} apart" if width else ""),
            "plan": rmsnorm_kernel._plan(x, w)._asdict()}


def kernel_phase(cfg, batch: int, seq: int) -> list:
    """Flash attention and RMSNorm (forward and gradients) over the sweeps
    and at the serve and train shapes."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim or cfg.d_model // cfg.n_heads
    train_flash = (TRAIN_BATCH, H, KH, TRAIN_SEQ, D)
    bad = []
    worst = {"flash_attention": flash_sweep(
        gen, FLASH_SWEEP + FLASH_EDGES + [(batch, H, KH, seq, D), train_flash])}
    small = flash_sweep(gen, FLASH_SMALL)
    print(f"kernels: flash over bf16 and f32 D 16/32/96 x S 1/7/64: largest abs "
          f"error {small} (atol 2e-3 f32 / 3e-2 bf16)")
    mla = flash_sweep(gen, FLASH_MLA)
    print(f"kernels: flash with v's own head dim (q/k 24/136/192, v 16/128): "
          f"largest abs error {mla} (atol 2e-3 f32 / 3e-2 bf16)")
    d256 = flash_sweep(gen, FLASH_D256)
    print(f"kernels: flash at head dim 256 (q/k 256, v 256/128; S 1 to 1024): "
          f"largest abs error {d256} (atol 2e-3 f32 / 3e-2 bf16)")
    worst["flash_attention"] = max(worst["flash_attention"], small, mla, d256)
    plans, calls, before = set(), 0, rmsnorm_kernel.launches
    for dt in (torch.float32, torch.bfloat16):
        for shape, offset in [(s, 0) for s in RMS_SWEEP + RMS_WIDE + [
                (batch * seq, cfg.d_model), (batch, 1, cfg.d_model),
                (TRAIN_BATCH * TRAIN_SEQ, cfg.d_model)]] + [(s, 1) for s in RMS_WIDE]:
            n = math.prod(shape)
            x = randn(gen, n + offset, dtype=dt)[offset:].view(shape)
            w = randn(gen, shape[-1])
            plans.add(rmsnorm_kernel._plan(x, w))
            err = max_err(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w))
            calls += 1
            worst["rmsnorm"] = max(worst.get("rmsnorm", 0), err)
            if not err <= RMS_ATOL[dt]:
                bad.append(f"rmsnorm {shape} {dt} offset {offset}: {err}")
    if rmsnorm_kernel.launches - before != calls:
        bad.append(f"rmsnorm: {rmsnorm_kernel.launches - before} launches for {calls} calls")
    print("kernels: rmsnorm's launch plans over the sweep (vec, loads a thread, warps a "
          "row, rows a block, grid): " + "; ".join(
              f"{p.vec}/{p.nv}/{p.warps_per_row}/{p.rows_per_block}/{p.grid}"
              for p in sorted(plans)))
    # MLA's q_norm and kv_norm as deepseek's prefill runs them: q_lora
    # columns, and kv_lora columns sliced from rows of kv_lora + qk_rope
    ds = get_config(DEEPSEEK_ARCH)
    g2 = torch.Generator(device=DEV).manual_seed(4)
    for dt in (torch.float32, torch.bfloat16):
        for cols, row in ((ds.q_lora, ds.q_lora), (ds.kv_lora, ds.kv_lora + ds.qk_rope)):
            x = randn(g2, batch * seq, row, dtype=dt)[:, :cols]
            w = randn(g2, cols, dtype=dt)
            err = max_err(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w))
            worst["rmsnorm"] = max(worst.get("rmsnorm", 0), err)
            if not err <= RMS_ATOL[dt]:
                bad.append(f"rmsnorm MLA {cols} of {row} columns {dt}: {err}")
    sync()
    print(f"kernels: largest abs error over the sweeps (RMSNorm also at MLA's "
          f"q_norm and kv_norm) {worst} "
          f"(atol flash 2e-3 f32 / 3e-2 bf16, rmsnorm 1e-5 f32 / 5e-2 bf16)")
    if bad:
        fail("kernel disagrees with its plain version: " + "; ".join(bad))
    grad_phase(gen, train_flash, (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model))

    flash = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
             "scalar_source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:31",
             **_flash_entry(gen, cfg, batch, seq),
             "train_shape": _flash_entry(gen, cfg, TRAIN_BATCH, TRAIN_SEQ)}
    flash["head_dim_256"] = _flash_d256_entry(gen)
    rms = {"name": "rmsnorm", "route": "cuda",
           "source": "src/repro_torch/csrc/rmsnorm.cu",
           "replaces": "src/repro/kernels/rmsnorm.py:24",
           **_rms_entry(gen, cfg, batch * seq),
           "train_shape": _rms_entry(gen, cfg, TRAIN_BATCH * TRAIN_SEQ)}
    xd = randn(gen, batch, 1, cfg.d_model, dtype=torch.bfloat16)
    w = randn(gen, cfg.d_model, dtype=torch.bfloat16)
    print(f"kernels: rmsnorm at the decode shape {tuple(xd.shape)}: device "
          f"{device_ms(lambda: ops.rmsnorm(xd, w)):.4f} ms, per call "
          f"{call_ms(lambda: ops.rmsnorm(xd, w)):.4f} ms through ops (RMSNormFn), "
          f"{call_ms(lambda: rmsnorm_kernel.rmsnorm(xd, w)):.4f} ms the wrapper alone")
    return [flash, rms]


def grad_phase(gen, train_flash, train_x) -> None:
    """Gradients through FlashAttentionFn and RMSNormFn (kernel forward,
    plain backward) against autograd of the plain versions, over the sweeps
    and at the train shapes (bf16, causal), within atol 5e-3 f32 / 5e-2 bf16
    plus one bf16 ulp of the reference (GRAD_RTOL); each forward must launch
    the flash kernel ``_want_variant`` names."""
    bf = torch.bfloat16
    cases = [(s, dt, c) for s in FLASH_SWEEP + FLASH_MLA_GRAD + FLASH_D256_GRAD
             for dt in (torch.float32, bf) for c in (True, False)] + [(train_flash, bf, True)]
    worst, bad = {}, []
    for (B, H, KH, S, D, *rest), dt, causal in cases:
        Dv = rest[0] if rest else D
        q, k, v, do = (randn(gen, *s, dtype=dt) for s in
                       ((B, H, S, D), (B, KH, S, D), (B, KH, S, Dv), (B, H, S, Dv)))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, variant = _counted_variant(lambda: ops.flash_attention(*leaves, causal=causal))
        if variant != _want_variant(dt, D, Dv):
            bad.append(f"flash forward {(B, H, KH, S, D, Dv)} {dt} launched {variant}, "
                       f"not {_want_variant(dt, D, Dv)}")
        got = torch.autograd.grad(out, leaves, do)
        want = _autograd(lambda *a: ref.flash_attention_ref(*a, causal=causal),
                         (q, k, v), do)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err = max_err(a, b)
            worst["flash_attention"] = max(worst.get("flash_attention", 0), err)
            if not (_grad_close(a, b, dt) and a.dtype == b.dtype):
                bad.append(f"flash {name} {(B, H, KH, S, D, Dv)} {dt} causal={causal}: {err}")
        del q, k, v, do, leaves, out, got, want
    for shape, dt in [(s, dt) for s in RMS_SWEEP for dt in (torch.float32, bf)] + \
            [(train_x, bf)]:
        x, dy, w = randn(gen, *shape, dtype=dt), randn(gen, *shape, dtype=dt), \
            randn(gen, shape[-1], dtype=dt)
        leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
        got = torch.autograd.grad(ops.rmsnorm(*leaves), leaves, dy)
        want = _autograd(ref.rmsnorm_ref, (x, w), dy)
        for name, a, b in zip(("dx", "dw"), got, want):
            err = max_err(a, b)
            worst["rmsnorm"] = max(worst.get("rmsnorm", 0), err)
            if not (_grad_close(a, b, dt) and a.dtype == b.dtype):
                bad.append(f"rmsnorm {name} {shape} {dt}: {err}")
    sync()
    print(f"kernels: gradients through the Functions, largest abs error {worst} "
          f"(atol 5e-3 f32 / 5e-2 bf16, plus 2^-7 |reference| in bf16)")
    if bad:
        fail("gradient disagrees with autograd of the plain version: " + "; ".join(bad))


def _grad_close(a, b, dt) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= GRAD_ATOL[dt] + GRAD_RTOL[dt] * b.abs()).all())


def adam_dgc_phase(n_params: int) -> list:
    """fused_adam over the sweep and at the main-path N; dgc_mask over the
    sweep.  Returns the fused_adam entry (the dgc entry is made on the train
    step's gradient in train_phase)."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    bad = []
    worst = 0.0
    per_sm = adam_kernel.blocks_per_sm()
    blocks = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    sweep = ADAM_SWEEP + [adam_kernel.STAGES * adam_kernel.TILE * blocks + 3]
    for n in sweep:
        for offsets in ADAM_OFFSETS:
            why, err = _adam_case(gen, n, offsets)
            bad += why
            worst = max(worst, err)
    sync()
    adam = {"name": "fused_adam", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_adam.cu",
            "replaces": "src/repro/kernels/fused_adam.py:26",
            **_adam_entry(gen, n_params)}
    worst = max(worst, adam["max_abs_err"])

    dworst = 0
    for shape, ratio in DGC_SWEEP:
        for dt in (torch.float32, torch.bfloat16):
            err, why = _dgc_check(randn(gen, *shape, dtype=dt), ratio)
            dworst = max(dworst, err)
            bad += [f"dgc {shape} {dt}: {why}"] if why else []
    sync()
    print(f"kernels: fused_adam ({per_sm} blocks an SM, {blocks} in all, tiles of "
          f"{adam_kernel.TILE} entries, {adam_kernel.STAGES} stages) largest abs error "
          f"{worst:.3g} over n={sweep}, each aligned and with p, g, m or v an entry "
          f"off (nothing written past a vector), and {n_params} (atol p 1e-5, m/v "
          f"1e-6); dgc_mask largest abs error "
          f"{dworst} over {DGC_SWEEP} in f32 and bf16 (exact)")
    if bad:
        fail("kernel disagrees with its plain version: " + "; ".join(bad))
    return [adam]


def _adam_inputs(gen, n):
    p, g = randn(gen, n), randn(gen, n)
    return p, g, randn(gen, n) * 0.1, randn(gen, n).abs() * 0.01


def _adam_case(gen, n: int, offsets) -> tuple:
    """fused_adam on ``n`` entries, each vector ``offsets[i]`` entries past a
    16-byte-aligned base inside a buffer with 8 guard entries either side,
    against the plain version: (what failed, the largest error)."""
    pad, bad = 8, []
    bufs, vecs = [], []
    for x, off in zip(_adam_inputs(gen, n), offsets):
        buf = torch.full((n + 2 * pad,), 7.0, device=DEV)
        buf[pad + off:pad + off + n] = x
        bufs.append(buf)
        vecs.append(buf[pad + off:pad + off + n])
    want = ref.fused_adam_ref(*(x.clone() for x in vecs), **ADAM_KW)
    got = ops.fused_adam(*vecs, **ADAM_KW)
    worst = 0.0
    for name, a, b, atol in zip("pmv", got, want, ADAM_ATOL):
        err = max_err(a, b) if n else 0.0
        worst = max(worst, err)
        if not err <= atol:
            bad.append(f"fused_adam {name} n={n} offsets {offsets}: {err}")
    for name, buf, off in zip("pgmv", bufs, offsets):
        if not bool((buf[:pad + off] == 7.0).all() and (buf[pad + off + n:] == 7.0).all()):
            bad.append(f"fused_adam n={n} offsets {offsets}: wrote past {name}")
    return bad, worst


def _adam_entry(gen, n: int) -> dict:
    """fused_adam at a main-path N: checked against the plain version in
    chunks of 2^26 (the update is elementwise; the kernel runs over all N
    at once), failing past ADAM_ATOL; then the kernel, the plain version
    and torch's own fused AdamW (decoupled weight decay, which is the same
    update) timed, each in place on the same buffers."""
    p, g, m, v = _adam_inputs(gen, n)
    got = ops.fused_adam(p.clone(), g, m.clone(), v.clone(), **ADAM_KW)
    errs = [0.0, 0.0, 0.0]
    for s0 in range(0, n, 1 << 26):
        sl = slice(s0, s0 + (1 << 26))
        want = ref.fused_adam_ref(p[sl], g[sl], m[sl], v[sl], **ADAM_KW)
        errs = [max(e, max_err(a[sl], b)) for e, a, b in zip(errs, got, want)]
    del got, want
    if any(e > atol for e, atol in zip(errs, ADAM_ATOL)):
        fail(f"fused_adam at n={n}: max abs err p/m/v {errs} (atol {ADAM_ATOL})")
    lr, c1, c2 = (torch.full((1,), ADAM_KW[k], device=DEV) for k in ("lr", "c1", "c2"))
    kw = {k: ADAM_KW[k] for k in ("b1", "b2", "eps")}
    step = torch.ones((), device=DEV)
    return {"max_abs_err": errs[0],
            **timings(f"fused_adam n={n}",
                      lambda: ops.fused_adam(p, g, m, v, lr=lr, c1=c1, c2=c2,
                                             wd=0.1, **kw),
                      lambda: ref.fused_adam_ref(p, g, m, v, lr=lr, c1=c1, c2=c2,
                                                 wd=0.1, **kw),
                      lambda: torch._fused_adamw_(
                          [p], [g], [m], [v], [], [step], lr=ADAM_KW["lr"],
                          beta1=0.9, beta2=0.95, weight_decay=0.1, eps=1e-8,
                          amsgrad=False, maximize=False), iters=10),
            **bound(*kernel_cost.fused_adam(n), PEAK_F32_FLOPS),
            "shape": f"p/g/m/v ({n},) f32"}


def _dgc_check(g, ratio: float):
    """dgc_mask against the exact top-k oracle and the plain version: equal,
    count >= k and equal to the plain count.  Returns (max abs error, what
    failed or "")."""
    want, k, thr = ref.dgc_topk_ref(g, ratio)
    got, count = ops.dgc_mask(g, thr)
    plain, plain_count = ref.dgc_mask_ref(g, thr)
    err = max_err(got, want)
    ok = (torch.equal(got, want) and torch.equal(got, plain) and got.dtype == g.dtype
          and int(count) >= k and int(count) == int(plain_count))
    return err, "" if ok else (f"count {int(count)} (plain {int(plain_count)}, "
                               f"k {k}), max err {err}")


def serve_phase(cfg, kernels: list) -> int:
    """Returns the model's parameter count."""
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=DEV)
    sync()
    n_params = sum(t.numel() for t in _named(params).values())
    print(f"serve: {cfg.name} full width, {n_params / 1e9:.3f}e9 params in "
          f"{cfg.dtype}, initialised in {time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab, n)],
                    max_new_tokens=NEW_TOKENS) for n in PROMPT_LENS]
    plen = max(PROMPT_LENS)
    engine = ServeEngine(cfg, params, max_seq=plen + NEW_TOKENS, device=DEV)
    # set-up, not counted: the first call of each GEMM shape and kernel loads it
    engine.generate([Request(r.prompt, 2) for r in reqs])

    ops.reset_launch_counts()
    results = engine.generate(reqs)
    counts = ops.launch_counts()
    by_variant = dict(flash_kernel.launches_by_variant)

    st = engine.stats
    steps = st["decode_steps"]
    total = sum(len(r.tokens) for r in results)
    print(f"serve: {len(reqs)} requests, prompts {PROMPT_LENS} (left-padded to "
          f"{plen}), {total} tokens; prefill {st['prefill_s'] * 1e3:.2f} ms, "
          f"decode {st['decode_s'] / steps * 1e3:.3f} ms/token over {steps} "
          f"steps, {total / (st['prefill_s'] + st['decode_s']):.1f} tokens/s")
    per_fwd = 2 * cfg.n_layers + 1
    want = {"flash_attention": cfg.n_layers, "rmsnorm": per_fwd * (1 + steps),
            "fused_adam": 0, "dgc_mask": 0}
    want_variant = {"wgmma": cfg.n_layers, "scalar": 0}
    print(f"serve: launches {counts}, flash by kernel {by_variant}; expected {want}, "
          f"{want_variant} ({cfg.n_layers} flash per prefill, all on the tensor-core "
          f"kernel, {per_fwd} rmsnorm per forward)")
    if counts != want or by_variant != want_variant:
        fail(f"launch counts {counts} {by_variant} != {want} {want_variant}")
    for kern in kernels:
        kern.setdefault("launches_by_path", {})["serve"] = counts[kern["name"]]
    for r in results:
        if len(r.tokens) != NEW_TOKENS or not all(0 <= t < cfg.vocab for t in r.tokens):
            fail(f"bad generation {r.tokens}")

    # where the time goes: device time of one prefill and one decode step at
    # the served shapes, against the host clock's time for them above
    model = build_model(cfg)
    with torch.inference_mode():
        toks = torch.ones(len(reqs), plen, dtype=torch.long, device=DEV)
        pre_ms, pre_n, *_ = device_profile(lambda: model.prefill(params, {"tokens": toks}), 3)
        cache = init_cache(cfg, len(reqs), plen + 1, DEV)
        dec_ms, dec_n, *_ = device_profile(
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
    seq = torch.tensor(rng.integers(1, cfg.vocab, (len(reqs), plen + 1)), device=DEV)
    print("serve: reference init, bf16 (printed, not checked): "
          + _consistency(cfg, params, reqs, results, seq)[0])
    cfg32, params32 = cfg.with_(dtype="float32"), _tree_map(torch.Tensor.float, params)
    res32 = ServeEngine(cfg32, params32, max_seq=plen + NEW_TOKENS,
                        device=DEV).generate(reqs)
    print("serve: reference init, f32 (printed, not checked): "
          + _consistency(cfg32, params32, reqs, res32, seq)[0])
    del params32
    _rescale_attention(cfg, params)
    res = engine.generate(reqs)
    text, ok = _consistency(cfg, params, reqs, res, seq)
    print("serve: attention rescaled to the usual fan-in: " + text)
    if not ok:
        fail("served tokens or decode logits disagree with prefill")
    return n_params


def serving_phase() -> dict:
    """The serving simulator against the port's engine at full width.

    llama3.2-1b: ``measure_serving_costs`` at 4 x 512 (fit only).
    tinyllama-1.1b, in each of ``SERVING_ROUNDS`` rounds: a ``generate`` of
    4 x (256, 64) on the phase's engine, ``measure_serving_costs`` at 4 x 512
    (on its own engine), a ``generate`` of 8 x (512, 64) (the what-if,
    ``static_slots:slots=8``), the ``generate`` of 4 x (256, 64) again, and
    in every third round two back-to-back ``generate``s of 4 x (512, 64)
    (the baseline, two static batches).  The engine is host-bound and the
    host's pace drifts over seconds, so each round's fit predicts the runs
    next to it, and the gates read the median of the rounds' errors.
    Gates: every constant finite and > 0; fidelity, the static drain of
    4 x (256, 64) against the mean of the round's two runs, within 10%; the
    what-if against the round's ``generate`` of 8 within 16%, both speedups
    > 1; launch counts exact over every prefill and decode step of every
    engine the phase builds (per prefill one flash per layer, all on the
    tensor-core kernel, and per forward two RMSNorm per layer and the final
    one).  Printed: the median constants and their ratio to the committed
    ``SERVING_COSTS``, TTFT, the error without C8's extra decode step, the
    baseline's error, and the serve phase's mixed prompts.  Returns the
    ``serving`` JSON object."""
    t0 = time.perf_counter()
    # forward passes of every engine the phase builds, by config
    calls = {}

    def counted(kind, make):
        def make_counted(cfg):
            step, n = make(cfg), calls.setdefault(cfg.name, {"prefill": 0, "decode": 0})

            def run(*args):
                n[kind] += 1
                return step(*args)
            return run
        return make_counted

    made = serve_engine.make_prefill_step, serve_engine.make_serve_step
    serve_engine.make_prefill_step = counted("prefill", made[0])
    serve_engine.make_serve_step = counted("decode", made[1])
    ops.reset_launch_counts()
    try:
        out = _serving_rounds()
    finally:
        serve_engine.make_prefill_step, serve_engine.make_serve_step = made
    counts = ops.launch_counts()
    by_variant = dict(flash_kernel.launches_by_variant)
    want = {"flash_attention": 0, "rmsnorm": 0, "fused_adam": 0, "dgc_mask": 0}
    for arch in (FIT_ONLY_ARCH, ARCH):
        layers, n = get_config(arch).n_layers, calls[get_config(arch).name]
        want["flash_attention"] += layers * n["prefill"]
        want["rmsnorm"] += (2 * layers + 1) * (n["prefill"] + n["decode"])
    want_variant = {"wgmma": want["flash_attention"], "scalar": 0}
    print(f"serving: launches over the phase's forward passes {calls}: {counts}, "
          f"flash by kernel {by_variant}; expected {want}, {want_variant} (one "
          f"flash per layer per prefill, all on the tensor-core kernel, two "
          f"rmsnorm per layer and the final one per forward)")
    if counts != want or by_variant != want_variant:
        fail(f"serving launch counts {counts} {by_variant} != {want} {want_variant}")
    out.update(forward_passes=calls, launches=counts, launches_by_variant=by_variant,
               phase_s=time.perf_counter() - t0)
    return out


def _serving_fit(arch: str) -> dict:
    """The constants ``measure_serving_costs`` fits for ``arch`` at the fit
    shape (gated finite and > 0) and the step times they imply."""
    model, consts = measure_serving_costs(arch, prompt_tokens=FIT_PROMPT,
                                          batch=FIT_BATCH, max_seq=FIT_MAX_SEQ,
                                          device=DEV)
    if not all(math.isfinite(v) and v > 0 for v in consts.values()):
        fail(f"serving constants of {arch} not finite and > 0: {consts}")
    return {"constants": consts,
            "prefill_ms": FIT_BATCH * model.prefill_time(FIT_PROMPT) * 1e3,
            "decode_ms": model.decode_step_time(FIT_BATCH, FIT_BATCH * FIT_PROMPT) * 1e3}


def _print_fit(arch: str, fit: dict, how: str) -> None:
    committed = SERVING_COSTS.get(arch, {})
    fit["ratio_to_committed"] = {k: fit["constants"][k] / committed[k]
                                 for k in committed} or None
    c = ", ".join(f"{k!r}: {v:.6g}" for k, v in fit["constants"].items())
    print(f"serving: {arch} fitted at batch {FIT_BATCH} x {FIT_PROMPT} prompt tokens "
          f"({how}): prefill {fit['prefill_ms']:.3f} ms, decode step "
          f"{fit['decode_ms']:.3f} ms; reuse with .with_constants({{{c}}}); ratio to "
          f"SERVING_COSTS " + (", ".join(f"{k} {v:.4f}" for k, v in
                                         (fit["ratio_to_committed"] or {}).items())
                               or "(none committed)"))


def _serving_predictions(consts: dict) -> dict:
    """What the tinyllama model with ``consts`` predicts for the phase's
    workloads, in seconds."""
    model = serving_cost(ARCH, fitted=False).with_constants(consts)

    def static(specs, slots):
        return ServingScenario(workload=explicit_workload(specs),
                               policy=ServingPolicy(mode="static", slots=slots),
                               serving_cost=model)

    fid = static([(0.0, FIDELITY_PROMPT, FIDELITY_NEW)] * FIT_BATCH, FIT_BATCH)
    what = static([(0.0, FIT_PROMPT, WHATIF_NEW)] * WHATIF_REQUESTS, FIT_BATCH)
    pred = what.predict(f"static_slots:slots={WHATIF_SLOTS}")
    return {"fidelity": fid.baseline().makespan,
            # the decode step the engine does not run (C8)
            "c8_step": model.decode_step_time(
                FIT_BATCH, FIT_BATCH * (FIDELITY_PROMPT + FIDELITY_NEW)),
            "ttft": fid.predict("noop").ttft_p50,
            "baseline": what.baseline().makespan, "whatif": pred.predicted,
            "speedup": pred.speedup,
            "mixed": static([(0.0, n, NEW_TOKENS) for n in PROMPT_LENS],
                            len(PROMPT_LENS)).baseline().makespan}


def _serving_rounds() -> dict:
    """The fits, the fidelity and what-if runs and their predictions, for
    ``serving_phase``."""
    fits = {FIT_ONLY_ARCH: _serving_fit(FIT_ONLY_ARCH)}
    _print_fit(FIT_ONLY_ARCH, fits[FIT_ONLY_ARCH], "measure_serving_costs, once")

    cfg = get_config(ARCH)
    engine = ServeEngine(cfg, init_params(cfg, seed=0, device=DEV),
                         max_seq=FIT_MAX_SEQ, device=DEV)
    rng = np.random.default_rng(1)

    def requests(lens, new):
        return [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab, n)],
                        max_new_tokens=new) for n in lens]

    fid_reqs = requests([FIDELITY_PROMPT] * FIT_BATCH, FIDELITY_NEW)
    what_reqs = requests([FIT_PROMPT] * WHATIF_REQUESTS, WHATIF_NEW)
    mixed_reqs = requests(PROMPT_LENS, NEW_TOKENS)
    # set-up: the first call of each batch shape loads its GEMMs
    for batch in (fid_reqs, what_reqs[:FIT_BATCH], what_reqs):
        engine.generate([Request(r.prompt, 2) for r in batch])

    def served(batch) -> dict:
        engine.generate(batch)
        return engine.stats

    # each round: fidelity, the fit, the what-if, fidelity again (the fit
    # next to the runs whose predictions it is held to), and in every third
    # round the baseline (its speedup over the what-if is far from 1)
    rounds = []
    half = WHATIF_REQUESTS // 2
    total = lambda st: st["prefill_s"] + st["decode_s"]     # noqa: E731
    for i in range(SERVING_ROUNDS):
        fid = [served(fid_reqs)]
        r = _serving_fit(ARCH)
        r["whatif_s"] = total(served(what_reqs))
        fid.append(served(fid_reqs))
        if i % 3 == 0:
            r["baseline_s"] = sum(total(served(b))
                                  for b in (what_reqs[:half], what_reqs[half:]))
        r.update(fidelity_s=float(np.mean([total(st) for st in fid])),
                 fidelity_prefill_s=float(np.mean([st["prefill_s"] for st in fid])),
                 predicted=_serving_predictions(r["constants"]))
        rounds.append(r)
    mixed = served(mixed_reqs)

    med = lambda xs: float(np.median(xs))          # noqa: E731
    consts = {k: med([r["constants"][k] for r in rounds]) for k in rounds[0]["constants"]}
    model = serving_cost(ARCH, fitted=False).with_constants(consts)
    fits[ARCH] = {"constants": consts,
                  "prefill_ms": FIT_BATCH * model.prefill_time(FIT_PROMPT) * 1e3,
                  "decode_ms": model.decode_step_time(FIT_BATCH, FIT_BATCH * FIT_PROMPT) * 1e3}
    _print_fit(ARCH, fits[ARCH], f"measure_serving_costs in each of {SERVING_ROUNDS} "
               f"rounds, the median of each constant; per round prefill/decode "
               + ", ".join(f"{r['prefill_ms']:.2f}/{r['decode_ms']:.2f}" for r in rounds)
               + " ms")

    def errors(pred, meas):
        return [r["predicted"][pred] / r[meas] - 1 for r in rounds if meas in r]

    fid_errs = errors("fidelity", "fidelity_s")
    fid_err = med(fid_errs)
    fid_err_c8 = med([(r["predicted"]["fidelity"] - r["predicted"]["c8_step"])
                      / r["fidelity_s"] - 1 for r in rounds])
    ttft_pred = med([r["predicted"]["ttft"] for r in rounds])
    ttft_meas = med([r["fidelity_prefill_s"] for r in rounds])
    print(f"serving: fidelity, {FIT_BATCH} x ({FIDELITY_PROMPT}, {FIDELITY_NEW}) static, "
          f"each round's fit against the mean of the generates before and after it "
          f"(prefill_s + decode_s): predicted/measured ms "
          + ", ".join(f"{r['predicted']['fidelity'] * 1e3:.1f}/{r['fidelity_s'] * 1e3:.1f}"
                      for r in rounds)
          + f"; median error {fid_err:+.2%} (limit {FIDELITY_TOL:.0%}); without the "
          f"decode step the engine does not run (C8) {fid_err_c8:+.2%}; TTFT predicted "
          f"{ttft_pred * 1e3:.3f} ms (the prefills and one decode step) against the "
          f"measured prefill {ttft_meas * 1e3:.3f} ms (medians)")
    if not abs(fid_err) <= FIDELITY_TOL:
        fail(f"serving fidelity {fid_err:+.2%} outside {FIDELITY_TOL:.0%}")

    spec = f"static_slots:slots={WHATIF_SLOTS}"
    err, base_err = med(errors("whatif", "whatif_s")), med(errors("baseline", "baseline_s"))
    pred_speedup = med([r["predicted"]["speedup"] for r in rounds])
    based = [r for r in rounds if "baseline_s" in r]
    meas_speedup = med([r["baseline_s"] for r in based]) / med([r["whatif_s"] for r in rounds])
    print(f"serving: what-if {spec} on {WHATIF_REQUESTS} x ({FIT_PROMPT}, {WHATIF_NEW}), "
          f"each round's fit against its runs: baseline (two static batches of "
          f"{FIT_BATCH}) predicted/measured ms "
          + ", ".join(f"{r['predicted']['baseline'] * 1e3:.1f}/{r['baseline_s'] * 1e3:.1f}"
                      for r in based)
          + f", median error {base_err:+.2%}; what-if (one generate of "
          f"{WHATIF_REQUESTS}) "
          + ", ".join(f"{r['predicted']['whatif'] * 1e3:.1f}/{r['whatif_s'] * 1e3:.1f}"
                      for r in rounds)
          + f"; speedup predicted {pred_speedup:.4f}x, measured {meas_speedup:.4f}x "
          f"(medians); median prediction error {err:+.2%} (limit {PREDICT_TOL:.0%})")
    if not (pred_speedup > 1 and meas_speedup > 1 and abs(err) <= PREDICT_TOL):
        fail(f"{spec} what-if: speedups {pred_speedup} / {meas_speedup}, "
             f"error {err:+.2%} (limit {PREDICT_TOL:.0%})")

    mixed_s = total(mixed)
    mix_pred = _serving_predictions(consts)["mixed"]
    mix_err = mix_pred / mixed_s - 1
    print(f"serving: the serve phase's prompts {PROMPT_LENS} x {NEW_TOKENS} tokens "
          f"(printed, not gated): predicted {mix_pred * 1e3:.3f} ms with the median "
          f"constants, each prompt priced at its length; measured {mixed_s * 1e3:.3f} "
          f"ms, the engine pads to {max(PROMPT_LENS)}: {mix_err:+.2%}")
    ms = lambda xs: [x * 1e3 for x in xs]     # noqa: E731
    return {"fits": fits,
            "fidelity": {"shape": [FIT_BATCH, FIDELITY_PROMPT, FIDELITY_NEW],
                         "error": fid_err, "error_without_c8_step": fid_err_c8,
                         "errors": fid_errs,
                         "predicted_ms": ms(r["predicted"]["fidelity"] for r in rounds),
                         "measured_ms": ms(r["fidelity_s"] for r in rounds),
                         "ttft_predicted_ms": ttft_pred * 1e3,
                         "prefill_measured_ms": ttft_meas * 1e3},
            "whatif": {"spec": spec, "error": err, "baseline_error": base_err,
                       "speedup_predicted": pred_speedup,
                       "speedup_measured": meas_speedup,
                       "baseline_predicted_ms": ms(r["predicted"]["baseline"] for r in based),
                       "baseline_measured_ms": ms(r["baseline_s"] for r in based),
                       "predicted_ms": ms(r["predicted"]["whatif"] for r in rounds),
                       "measured_ms": ms(r["whatif_s"] for r in rounds)},
            "mixed": {"prompts": PROMPT_LENS, "predicted_ms": mix_pred * 1e3,
                      "measured_ms": mixed_s * 1e3, "error": mix_err},
            "rounds": [{k: r[k] for k in ("constants", "prefill_ms", "decode_ms")}
                       for r in rounds]}


def _batches(cfg, seq: int, batch: int, start: int = 0):
    step = start
    while True:
        yield make_batch(cfg, seq_len=seq, batch=batch, step=step)
        step += 1


def _device_batch(cfg, step: int, batch: int = TRAIN_BATCH) -> dict:
    return {k: torch.from_numpy(v).to(DEV) for k, v in
            make_batch(cfg, seq_len=TRAIN_SEQ, batch=batch, step=step).items()}


def train_phase(cfg, kernels: list, n_params: int) -> None:
    B, S, L = TRAIN_BATCH, TRAIN_SEQ, cfg.n_layers
    H, D = cfg.n_heads, cfg.head_dim or cfg.d_model // cfg.n_heads
    per_step = {"flash_attention": L, "rmsnorm": 2 * L + 1, "fused_adam": 1,
                "dgc_mask": 0}
    per_step_variant = {"wgmma": L, "scalar": 0}
    trainer = Trainer(cfg, TrainerConfig(steps=TRAIN_STEPS, log_every=0, seed=0),
                      optimizer=AdamW(fused=True), device=DEV)
    step_counts, step_variants = [], []

    def hook(i, metrics):          # the counts of step i, then zero for i + 1
        step_counts.append(ops.launch_counts())
        step_variants.append(dict(flash_kernel.launches_by_variant))
        ops.reset_launch_counts()

    torch.cuda.reset_peak_memory_stats()
    batches = Prefetcher(_batches(cfg, S, B))
    ops.reset_launch_counts()
    state = trainer.fit(batches, hooks=hook)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    run_counts = {k: sum(c[k] for c in step_counts) for k in per_step}
    log = trainer.metrics_log
    step_s = float(np.mean([m["step_time_s"] for m in log[1:]]))
    tokens = B * S
    pairs = B * H * S * (S + 1) // 2
    attn_flops = 3 * 4 * D * pairs * L          # forward + backward (2x)
    flops = 6 * n_params * tokens + attn_flops
    print(f"train: {cfg.name} full width and depth, {n_params / 1e9:.3f}e9 params "
          f"in {cfg.dtype}, seq {S}, micro-batch {B} ({tokens} tokens/step), "
          f"AdamW(fused=True); peak device memory {peak_gb:.2f} GB")
    for m in log:
        print(f"train: step {m['step']} loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f} host {m['step_time_s'] * 1e3:.1f} ms"
              + (" (warm-up, not counted)" if m["step"] == 0 else ""))
    print(f"train: step {step_s * 1e3:.1f} ms (mean of steps 1-{len(log) - 1}, host "
          f"clock ending in a sync), {tokens / step_s:.1f} tokens/s, mfu "
          f"{flops / step_s / PEAK_BF16_FLOPS:.4f} ((6 N tokens + causal attention "
          f"{attn_flops:.3g}) / step time / 989e12)")
    print(f"train: launches per step {step_counts}, flash by kernel {step_variants}; "
          f"expected {per_step}, {per_step_variant} each")
    if (any(c != per_step for c in step_counts) or len(step_counts) != TRAIN_STEPS
            or any(c != per_step_variant for c in step_variants)):
        fail(f"train launch counts per step {step_counts} {step_variants} != "
             f"{per_step} {per_step_variant}")
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in log):
        fail("non-finite loss or grad norm in training")

    # device busy share of one step
    batch = _device_batch(cfg, TRAIN_STEPS)
    holder = {"state": state}

    def one_step():
        holder["state"], _ = trainer.step_fn(holder["state"], batch)

    dev_ms, dev_n, host_ms, top, *_ = device_profile(one_step, iters=1, warmup=0)
    print(f"train: one step under torch.profiler: device {dev_ms:.1f} ms over "
          f"{dev_n:.0f} device ops, host {host_ms:.1f} ms (busy {dev_ms / host_ms:.1%}); "
          f"largest device ms by op: " + "; ".join(f"{n} {t:.1f}" for t, n in top))
    state = holder.pop("state")

    # every param leaf gets a finite, nonzero gradient, and the backward
    # launches no kernel (forward launches only)
    params = state["params"]
    ops.reset_launch_counts()
    loss, grads = loss_and_grads(cfg, params, batch)
    sync()
    counts = ops.launch_counts()
    fwd = {**per_step, "fused_adam": 0}
    dead = [name for name, g in _named(grads).items()
            if not (torch.isfinite(g).all() and (g != 0).any())]
    print(f"train: loss {loss.item():.4f}; {len(_named(grads))} gradient leaves, "
          f"{len(dead)} not finite or all zero; launches of one forward and "
          f"backward {counts} (expected {fwd})")
    if dead:
        fail(f"gradient missing (non-finite or all zero) for {dead}")
    if counts != fwd:
        fail(f"forward+backward launch counts {counts} != {fwd}")

    update_phase(grads, state, params)
    kernels.append(dgc_entry(grads["unembed"]["table"]))
    for kern in kernels:
        kern.setdefault("launches_by_path", {})["train"] = run_counts[kern["name"]]
        kern["launches_per_train_step"] = per_step[kern["name"]]
    flash = next(kern for kern in kernels if kern["name"] == "flash_attention")
    flash["launches_by_variant"] = {v: sum(c[v] for c in step_variants)
                                    for v in per_step_variant}
    del grads, state, params, holder
    loss_falls_phase(cfg, trainer)


def update_phase(grads, state, params) -> None:
    """The per-leaf and the fused update on the same gradients and cloned
    state (paper §6.3 on the H100): device ms and ops of each, and the two
    results held against each other."""
    opt = state["opt"]

    def clone():
        return opt_state(opt["m"], opt["v"], int(opt["count"]))

    unfused, fused = AdamW(fused=False), AdamW(fused=True)
    pu, su = unfused.apply(grads, clone(), params)
    pf, sf = fused.apply(grads, clone(), params)
    sync()
    # Params in bf16 ulps at the scale of the operands, max(|p|, |p'|): the
    # two paths round p - lr * step in a different order (the kernel fuses
    # multiply-adds), an f32 difference at the operands' scale; where p' nearly
    # cancels to 0, that is many ulps of p' itself (printed, not checked).
    worst_ulps, worst_own, n_diff, n_all = 0.0, 0.0, 0, 0
    p0 = _named(params)
    for name, a in _named(pu).items():
        a, b, p = a.float(), _named(pf)[name].float(), p0[name].float()
        diff = (a - b).abs()
        worst_ulps = max(worst_ulps, (diff / _bf16_ulp(torch.maximum(
            p.abs(), torch.maximum(a.abs(), b.abs())))).max().item())
        worst_own = max(worst_own, (diff / _bf16_ulp(torch.maximum(
            a.abs(), b.abs()))).max().item())
        n_diff += int((diff > 0).sum())
        n_all += a.numel()
    worst_rel = 0.0
    # m and v relative to each leaf's largest entry: an entry of m where
    # b1 m + (1 - b1) g cancels carries the clip scale's last-bit difference
    # (flat against per-leaf grad norm) at no relative precision
    for tree in ("m", "v"):
        for name, a in _named(su[tree]).items():
            b = _named(sf[tree])[name]
            rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            worst_rel = max(worst_rel, rel)
    gu, gf = float(su["gnorm"]), float(sf["gnorm"])
    print(f"update: fused against per-leaf on the same gradients and state: params "
          f"within {worst_ulps:.2f} bf16 ulp of max(|p|, |p'|) (need <= 1; "
          f"{n_diff} of {n_all} differ at all, at most {worst_own:.0f} ulp of "
          f"|p'| itself), m/v within {worst_rel:.3g} of each leaf's largest "
          f"entry (need <= 1e-5), grad norm {gu:.6f} / {gf:.6f}")
    if not (worst_ulps <= 1 and worst_rel <= 1e-5):
        fail("fused and per-leaf AdamW disagree")
    del pu, su, pf, sf
    res = {}
    for label, o in (("per-leaf", unfused), ("fused", fused)):
        s = clone()
        res[label] = device_profile(lambda: o.apply(grads, s, params), iters=5)
        del s
    (um, un, uh, *_), (fm, fn, fh, *_) = res["per-leaf"], res["fused"]
    print(f"update: AdamW.apply per-leaf {um:.3f} ms device over {un:.0f} device ops "
          f"({uh:.3f} ms host per call); apply_fused {fm:.3f} ms device over "
          f"{fn:.0f} device ops ({fh:.3f} ms host per call); device ratio "
          f"{um / fm:.2f}x, host ratio {uh / fh:.2f}x")


def whatif_phase(cfg, name: str, kernels: list, traces: Path) -> dict:
    """Predict -> implement -> measure for FusedAdam at the train shape; the
    kept capture of the per-leaf step is written under ``traces/perleaf``.
    Returns the ``whatif`` JSON object."""
    (traces / "perleaf").mkdir(parents=True)
    out = fused_whatif(cfg, name, kernels, _device_batch(cfg, 0), "whatif",
                       save_to=str(traces / "perleaf" / PT_TRACE))
    out.pop("by_layer_ms")
    return out


def fused_whatif(cfg, name: str, kernels: list, batch: dict, tag: str,
                 save_to=None, calibrate: bool = False) -> dict:
    """Daydream's FusedAdam case (paper §6.3) on the card for ``cfg``'s
    train step on ``batch``: the per-leaf AdamW step traced
    (``trace_measured``, its capture saved to ``save_to``), the graph
    checked (acyclic, fwd/bwd/update present, >= 90% of device time mapped
    to a layer, every kernel launched by a host task), simulated and held
    within FIDELITY_TOL of the kept capture's own span (the simulation
    replays its input) and of the step measured without the profiler (CUDA
    events); ``fused_optimizer`` predicted and held within PREDICT_TOL of
    the fused step measured interleaved per-leaf / fused / per-leaf, both
    speedups above 1; launch counts exact over every step of the phase
    (``launches_by_path[tag]``).

    With ``calibrate`` (a step whose host paces the card, which the
    profiler slows: ROADMAP C5) the trace also times PACE_CALLS calls
    without the profiler, the graph's host lane is scaled by their median
    over its total (``kineto.scale_host_lane``) before ``fused_optimizer``
    is predicted on it, and the baseline against the measured step is
    printed, not gated, for both graphs: unscaled it reads the profiler's
    slowing of the host, scaled it reproduces the unprofiled call by
    construction.  Lines are printed as ``tag:``.  Returns the JSON object,
    with the traced and predicted device ms by layer and phase
    (``by_layer_ms``)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L = cfg.n_layers
    trainer = Trainer(cfg, TrainerConfig(steps=1, log_every=0, seed=0),
                      optimizer=AdamW(), device=DEV)
    holder = {"state": trainer.init_state()}
    step_fns = {"per-leaf": trainer.step_fn,
                "fused": make_train_step(cfg, AdamW(fused=True))}
    calls = dict.fromkeys(step_fns, 0)

    def stepper(variant):
        def step():
            holder["state"], _ = step_fns[variant](holder["state"], batch)
            calls[variant] += 1
        return step

    perleaf, fused = stepper("per-leaf"), stepper("fused")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    bundle = trace_measured(perleaf, device=DEV, save_to=save_to,
                            pace_calls=PACE_CALLS if calibrate else 0)
    trace_s = time.perf_counter() - t0
    g = bundle.graph
    g.toposort()                                   # raises on a cycle
    tasks = g.tasks()
    dev = [t for t in tasks if t.thread == DEVICE_STREAM]
    n_edges = sum(len(g.children(t)) for t in tasks)
    dev_s = sum(t.duration for t in dev)
    by_phase, by_layer = {}, {}
    for t in dev:
        by_phase[t.phase] = by_phase.get(t.phase, 0.0) + t.duration
        by_layer[str(t.layer)] = by_layer.get(str(t.layer), 0.0) + t.duration
    mapped = 1 - by_layer.get("None", 0.0) / dev_s
    unlaunched = sum(not any(p.thread == HOST_THREAD for p in g.parents(t)) for t in dev)
    n_update = sum(t.phase == "update" for t in dev)
    agg = bundle.aggregates
    unprofiled = (f", {agg['unprofiled_issue_s'] * 1e3:.3f} ms without it (median of "
                  f"{PACE_CALLS}): host scale {agg['host_scale']:.4f}" if calibrate else "")
    print(f"{tag}: per-leaf AdamW step traced in {trace_s:.1f}s (the fastest of "
          f"3 captures: host span {agg['span_s'] * 1e3:.3f} ms, slowest "
          f"{agg['slowest_span_s'] * 1e3:.3f} ms; issued in {agg['issue_s'] * 1e3:.3f} ms "
          f"under the profiler{unprofiled}): {len(dev)} device "
          f"tasks, {len(tasks) - len(dev)} host tasks, {n_edges} edges; device "
          f"{dev_s * 1e3:.3f} ms by phase "
          + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in sorted(by_phase.items()))
          + "; by layer " + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in
                                      sorted(by_layer.items(), key=lambda kv: -kv[1]))
          + f"; {mapped:.2%} of device time has a layer (need >= 90%); "
          f"{n_update} update-phase device ops; {unlaunched} kernels without a "
          f"launch (need 0)")
    if not ({"fwd", "bwd", "update"} <= set(by_phase) and mapped >= 0.9
            and unlaunched == 0):
        fail("the traced step graph lacks a phase, a layer map or a launch edge")

    sim_ms = bundle.simulate().makespan * 1e3
    host_ms = sum(t.duration + t.gap for t in g.lane_tasks(HOST_THREAD)) * 1e3
    captured_ms = agg["span_s"] * 1e3
    replay = sim_ms / captured_ms - 1
    print(f"{tag}: simulated per-leaf step {sim_ms:.3f} ms (host lane {host_ms:.3f} ms) "
          f"against its capture's span {captured_ms:.3f} ms: {replay:+.2%} (need within "
          f"{FIDELITY_TOL:.0%})")
    if abs(replay) > FIDELITY_TOL:
        fail(f"the simulation does not replay its capture: {replay:+.2%}")
    base_graph_ms = sim_ms
    if calibrate:
        scale_host_lane(g, agg["host_scale"])
        sim_ms = bundle.simulate().makespan * 1e3
    scen = Scenario(graph=g, cost=bundle.cost)
    pred, tf, _ = scen.evaluate("fused_optimizer")
    fused_task = next(t for t in tf.graph.tasks() if t.name == "fused_optimizer_kernel")
    pred_ms = pred.predicted * 1e3
    on = (f"the calibrated per-leaf step {sim_ms:.3f} ms (host lane scaled by "
          f"{agg['host_scale']:.4f})" if calibrate else f"the per-leaf step {sim_ms:.3f} ms")
    print(f"{tag}: on {on}, fused_optimizer "
          f"predicts {pred_ms:.3f} ms ({pred.speedup:.4f}x), its fused update "
          f"task {fused_task.duration * 1e3:.3f} ms for {fused_task.bytes_accessed / 1e9:.3f} "
          f"GB (a third of the update's {3 * fused_task.bytes_accessed / 1e9:.3f} GB)")
    by_layer_ms = {"traced": _ms_by_layer_phase(g), "predicted": _ms_by_layer_phase(tf.graph)}
    graph = {"device_tasks": len(dev), "host_tasks": len(tasks) - len(dev),
             "host_ms": host_ms, "host_share": host_ms / base_graph_ms,
             "issue_ms": agg["issue_s"] * 1e3,
             "edges": n_edges, "update_device_tasks": n_update,
             "captured_span_ms": agg["span_s"] * 1e3,
             "slowest_captured_span_ms": agg["slowest_span_s"] * 1e3,
             "device_ms": dev_s * 1e3, "layer_mapped_share": mapped,
             "device_ms_by_phase": {k: v * 1e3 for k, v in by_phase.items()}}
    fused_task_ms = fused_task.duration * 1e3
    # the traces' objects freed before the steps are timed, as the pace
    # calls and the captures ran without them
    del bundle, g, tasks, dev, scen, pred, tf, fused_task
    gc.collect()

    meas = {}
    for variant, fn in (("per-leaf", perleaf), ("fused", fused), ("per-leaf 2", perleaf)):
        meas[variant] = measure_wallclock(fn, device=DEV, iters=WHATIF_ITERS,
                                          warmup=1) * 1e3
    sync()
    counts = ops.launch_counts()
    per_step = {"flash_attention": _flashes(cfg), "rmsnorm": _norms(cfg)}
    n_steps = sum(calls.values())
    want = {**{k: v * n_steps for k, v in per_step.items()},
            "fused_adam": calls["fused"], "dgc_mask": 0}
    print(f"{tag}: launches over the phase's {calls['per-leaf']} per-leaf and "
          f"{calls['fused']} fused steps {counts} (expected {want}); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if counts != want:
        fail(f"{tag} launch counts {counts} != {want}")
    for kern in kernels:
        kern.setdefault("launches_by_path", {})[tag] = counts[kern["name"]]
    del holder, trainer

    base_ms = (meas["per-leaf"] + meas["per-leaf 2"]) / 2
    fused_ms = meas["fused"]
    fidelity, err = base_graph_ms / base_ms - 1, pred_ms / fused_ms - 1
    speedups = (sim_ms / pred_ms, base_ms / fused_ms)
    if calibrate:
        baseline = (f"baseline simulated {base_graph_ms:.3f} ms vs measured {base_ms:.3f} "
                    f"ms: {fidelity:+.2%}, the profiler's slowing of the host (C5); "
                    f"calibrated {sim_ms:.3f} ms ({agg['unprofiled_issue_s'] * 1e3:.3f} ms "
                    f"of unprofiled issue and the device's tail, by construction): "
                    f"{sim_ms / base_ms - 1:+.2%} (both printed, not gated)")
    else:
        baseline = (f"baseline simulated {sim_ms:.3f} ms vs measured {base_ms:.3f} ms: "
                    f"error {fidelity:+.2%} (need within {FIDELITY_TOL:.0%})")
    print(f"{tag}: measured (CUDA events, median of {WHATIF_ITERS}) per-leaf "
          f"{meas['per-leaf']:.3f} ms, fused {fused_ms:.3f} ms, per-leaf "
          f"{meas['per-leaf 2']:.3f} ms; {baseline}; fused predicted {pred_ms:.3f} ms vs "
          f"measured {fused_ms:.3f} ms: error {err:+.2%} (need within {PREDICT_TOL:.0%}); "
          f"speedup predicted {speedups[0]:.4f}x, measured {speedups[1]:.4f}x "
          f"(need both > 1)")
    if not calibrate and abs(fidelity) > FIDELITY_TOL:
        fail(f"simulated baseline {sim_ms:.3f} ms is {fidelity:+.2%} off the "
             f"measured {base_ms:.3f} ms")
    if abs(err) > PREDICT_TOL or min(speedups) <= 1:
        fail(f"FusedAdam prediction {pred_ms:.3f} ms ({speedups[0]:.4f}x) against "
             f"the measured {fused_ms:.3f} ms ({speedups[1]:.4f}x)")
    B = batch["tokens"].shape[0]
    return {"device": name, "shape": f"train_4k, micro-batch {B}, {cfg.dtype}",
            "graph": graph,
            "replay": {"simulated_ms": base_graph_ms, "captured_ms": captured_ms,
                       "error": replay},
            "baseline": {"simulated_ms": base_graph_ms, "measured_ms": base_ms,
                         "measured_runs_ms": [meas["per-leaf"], meas["per-leaf 2"]],
                         "error": fidelity, "gated": not calibrate},
            **({"calibrated": {"host_scale": agg["host_scale"],
                               "unprofiled_issue_ms": agg["unprofiled_issue_s"] * 1e3,
                               "simulated_ms": sim_ms, "error": sim_ms / base_ms - 1}}
               if calibrate else {}),
            "fused_optimizer": {"predicted_ms": pred_ms, "measured_ms": fused_ms,
                                "error": err, "predicted_speedup": speedups[0],
                                "measured_speedup": speedups[1],
                                "predicted_fused_task_ms": fused_task_ms},
            "by_layer_ms": by_layer_ms}


def _ms_by_layer_phase(graph) -> dict:
    """Device ms of a step graph by "layer phase" (layer None: unmapped)."""
    out = {}
    for t in graph.lane_tasks(DEVICE_STREAM):
        key = f"{t.layer} {t.phase}"
        out[key] = out.get(key, 0.0) + t.duration * 1e3
    return out


AMP_ROWS = [("attn fwd", lambda t: t.layer == "attn" and t.phase == "fwd"),
            ("attn bwd", lambda t: t.layer == "attn" and t.phase != "fwd"),
            ("mlp", lambda t: t.layer == "mlp"), ("norm", lambda t: t.layer == "norm"),
            ("loss", lambda t: t.layer == "loss"), ("embed", lambda t: t.layer == "embed"),
            ("update", lambda t: t.layer == "update"),
            ("unmapped", lambda t: t.layer is None)]


def _ms_by_row(graph) -> dict:
    """Device ms of a step graph by the rows of AMP_ROWS."""
    dev = graph.lane_tasks(DEVICE_STREAM)
    return {row: sum(t.duration for t in dev if pick(t)) * 1e3 for row, pick in AMP_ROWS}


# The fused update's operations (optim/adamw.py, AdamW.apply_fused) in the
# order they run, each with the bytes an entry it moves with bf16 params and
# gradients (an estimate from the code: a bf16 read and write for each cat,
# a bf16 read and an f32 write for each .float(), g read for the square,
# the square written and read by the sum, g read and written by mul_, the
# kernel's 28, an f32 read and a bf16 write back); "scalars" are the 0-dim
# steps between them (clip scale, lr, bias corrections)
UPDATE_OPS = [("cat p, g", 8), (".float() p, g", 12), ("norm: square, sum, sqrt", 12),
              ("clip: mul_", 8), ("kernel", 28), ("slice, cast to bf16", 6),
              ("scalars", 0)]


def _update_by_op(graph) -> dict:
    """Device ms, tasks and bytes an entry of each of UPDATE_OPS in a
    captured fused step, from its update-phase device tasks: by the launching
    operator before the kernel (a 0-dim operator of the same name, such as
    the step count's ``.float()``, counts with its row: a few microseconds),
    the kernel by its name, and every task after it as the cast back."""
    out = {row: {"ms": 0.0, "tasks": 0, "bytes_per_entry": b} for row, b in UPDATE_OPS}
    after = False
    for t in graph.lane_tasks(DEVICE_STREAM):
        if t.phase != "update":
            continue
        op = t.attrs.get("op") or ""
        if "fused_adam" in t.name:
            row, after = "kernel", True
        elif after:
            row = "slice, cast to bf16"
        elif op == "aten::cat":
            row = "cat p, g"
        elif op in ("aten::copy_", "aten::_to_copy", "aten::to"):
            row = ".float() p, g"
        elif op in ("aten::pow", "aten::square", "aten::sum", "aten::sqrt"):
            row = "norm: square, sum, sqrt"
        elif op == "aten::mul_":
            row = "clip: mul_"
        else:
            row = "scalars"
        out[row]["ms"] += t.duration * 1e3
        out[row]["tasks"] += 1
    return out


def _amp_except(graph, keep) -> float:
    """Simulated ms of ``graph`` after paper Algorithm 3 (matrix products
    3x, every other device task 2x, as the ``amp`` what-if classes them) on
    every device task but those ``keep`` selects, from GraphTransform's
    primitives."""
    def dot(t):
        return (t.attrs.get("opcode") in ("dot", "convolution")
                or (t.kind == TaskKind.COMPUTE and t.flops > t.bytes_accessed))

    tf = GraphTransform(graph)
    changed = all_of(on_device, lambda t: not keep(t))
    tf.scale(all_of(changed, dot), 1 / 3)
    tf.scale(all_of(changed, lambda t: not dot(t)), 1 / 2)
    return tf.simulate().makespan * 1e3


def _launch_queue(events) -> tuple:
    """(the most device operations launched and not yet finished when a
    launch returns, the median ms from a launch's end to its kernel's start)
    of a CUDA capture: how far the host ran ahead of the card."""
    xs = [e for e in events if e.get("ph") == "X"]
    launch = {e["args"].get("correlation"): e for e in xs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    pairs = sorted(((launch[e["args"]["correlation"]], e) for e in xs
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                    and e["args"].get("correlation") in launch),
                   key=lambda p: p[0]["ts"])
    if not pairs:
        return 0, 0.0
    ends = sorted(k["ts"] + k["dur"] for _, k in pairs)
    pending = [i + 1 - bisect.bisect_right(ends, l["ts"] + l["dur"])
               for i, (l, _) in enumerate(pairs)]
    lead = sorted(k["ts"] - l["ts"] - l["dur"] for l, k in pairs)
    return max(pending), lead[len(lead) // 2] / 1e3


def _issue_and_wait(step, n: int = 3) -> tuple:
    """Median host ms to issue one step, and the ms then waited for the card
    (host clock, no profiler)."""
    issue, wait = [], []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        sync()
        issue.append((t1 - t0) * 1e3)
        wait.append((time.perf_counter() - t1) * 1e3)
    return sorted(issue)[n // 2], sorted(wait)[n // 2]


def _meta_trace(cfg):
    """``trace_compiled`` of the full-width fused train step on meta
    tensors: (bundle, seconds)."""
    params = init_params(cfg, device="meta")
    opt = AdamW(fused=True)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    batch = {k: torch.from_numpy(v).to("meta") for k, v in
             make_batch(cfg, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, step=0).items()}
    t0 = time.perf_counter()
    bundle = trace_compiled(make_train_step(cfg, opt), state, batch)
    return bundle, time.perf_counter() - t0


def amp_phase(cfg, name: str, kernels: list, traces: Path, handoff: dict) -> dict:
    """Predict -> implement -> measure for AMP (paper Algorithm 3) at the
    train shape with ``AdamW(fused=True)``: the baseline is the float32
    config, the implementation the bfloat16 one (the reference's precision
    pair is a dtype switch too), same init seed and batch.  Then the
    analytical route on the same step.  The bfloat16 step's kept capture is
    written under ``traces/fused``; its bundle (``fused``), measured ms
    (``fused_ms``) and meta-tensor trace (``meta16``) go into ``handoff``.
    Returns the ``amp`` JSON object."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L = cfg.n_layers
    tf32 = torch.backends.cuda.matmul.allow_tf32
    cfgs = {"fp32": cfg.with_(dtype="float32"), "bf16": cfg}
    states, step_fns = {}, {}
    for label, c in cfgs.items():
        trainer = Trainer(c, TrainerConfig(steps=1, log_every=0, seed=0),
                          optimizer=AdamW(fused=True), device=DEV)
        states[label] = trainer.init_state()
        # the reference init is chaotic at this width (see serve_phase);
        # timing does not care, but keep the losses finite
        _rescale_attention(c, states[label]["params"])
        step_fns[label] = trainer.step_fn
    batch = _device_batch(cfg, 0)
    calls = dict.fromkeys(cfgs, 0)
    losses = {}

    def stepper(label):
        def step():
            states[label], m = step_fns[label](states[label], batch)
            losses[label] = m["loss"]
            calls[label] += 1
        return step

    fp32, bf16 = stepper("fp32"), stepper("bf16")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    b32 = trace_measured(fp32, device=DEV)
    trace_s = time.perf_counter() - t0
    g32 = b32.graph
    g32.toposort()
    sim_ms = b32.simulate().makespan * 1e3
    scen = Scenario(graph=g32, cost=b32.cost)
    pred, tf_amp, _ = scen.evaluate("amp")
    fused_pred = scen.evaluate("fused_optimizer")[0]
    pred_ms, fused_pred_ms = pred.predicted * 1e3, fused_pred.predicted * 1e3
    diag_ms = _amp_except(g32, lambda t: (t.layer == "attn" and t.phase == "bwd")
                          or t.phase == "update")
    # the host lane's records and untraced time, the launch-queue waits moved
    # to device -> host edges (kineto: each released launch keeps only the
    # time it took after its release)
    host_ms = sum(t.duration + t.gap for t in g32.lane_tasks(HOST_THREAD)) * 1e3
    waits = sum(e.get("cat") == WAIT_CAT and e.get("name") == WAIT_NAME
                for e in b32.module)
    released = sum(t.kind == TaskKind.HOST and any(
        p.thread == DEVICE_STREAM for p in g32.parents(t))
        for t in g32.lane_tasks(HOST_THREAD))
    print(f"amp: torch.backends.cuda.matmul.allow_tf32 = {tf32} (left as it is); "
          f"float32 step traced in {trace_s:.1f}s: {len(g32.lane_tasks(DEVICE_STREAM))} "
          f"device and {len(g32.lane_tasks(HOST_THREAD))} host tasks ({host_ms:.3f} ms "
          f"of host time after {waits} command-buffer waits released {released} host "
          f"tasks), simulated {sim_ms:.3f} ms; amp predicts {pred_ms:.3f} ms ({pred.speedup:.4f}x), "
          f"with the attention backward and the update left alone {diag_ms:.3f} ms "
          f"({sim_ms / diag_ms:.4f}x); fused_optimizer on the same graph "
          f"{fused_pred_ms:.3f} ms ({fused_pred.speedup:.4f}x)")

    meas = {}
    for label, fn in (("fp32", fp32), ("bf16", bf16), ("fp32 2", fp32)):
        meas[label] = measure_wallclock(fn, device=DEV, iters=WHATIF_ITERS,
                                        warmup=1) * 1e3
    (traces / "fused").mkdir(parents=True)
    b16 = trace_measured(bf16, device=DEV, save_to=str(traces / "fused" / PT_TRACE))
    queue = {"fp32": _launch_queue(b32.module), "bf16": _launch_queue(b16.module)}
    issue = {"fp32": _issue_and_wait(fp32), "bf16": _issue_and_wait(bf16)}
    print("amp: how far the host runs ahead: " + "; ".join(
        f"{k} capture up to {queue[k][0]} device operations in flight after a launch, "
        f"a kernel starting a median {queue[k][1]:.3f} ms after its launch, a step "
        f"issued in {issue[k][0]:.1f} ms and then {issue[k][1]:.1f} ms waited for "
        f"the card (median of 3, no profiler)" for k in queue))
    sync()
    counts, by_variant = ops.launch_counts(), dict(flash_kernel.launches_by_variant)
    n = sum(calls.values())
    want = {"flash_attention": L * n, "rmsnorm": (2 * L + 1) * n, "fused_adam": n,
            "dgc_mask": 0}
    want_variant = {"wgmma": L * calls["bf16"], "scalar": L * calls["fp32"]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"amp: launches over the phase's {calls['fp32']} float32 and {calls['bf16']} "
          f"bfloat16 steps {counts}, flash by kernel {by_variant} (expected {want}, "
          f"{want_variant}: per step 22 flash, all 'scalar' in float32 and 'wgmma' in "
          f"bfloat16, 45 rmsnorm, 1 fused_adam); last losses "
          + ", ".join(f"{k} {float(v):.4f}" for k, v in losses.items())
          + f"; peak device memory {peak_gb:.2f} GB")
    if counts != want or by_variant != want_variant:
        fail(f"amp launch counts {counts} {by_variant} != {want} {want_variant}")
    for kern in kernels:
        kern.setdefault("launches_by_path", {})["amp"] = counts[kern["name"]]

    update = _update_by_op(b16.graph)
    total = sum(r["ms"] for r in update.values())
    print(f"amp: the bfloat16 fused step's update, {total:.3f} device ms by operation "
          f"(the same capture; bytes an entry estimated from optim/adamw.py): " + "; ".join(
              f"{row} {r['ms']:.3f} ms over {r['tasks']} tasks ({r['bytes_per_entry']} B)"
              for row, r in update.items()))
    rows32, rows_pred, rows16 = (_ms_by_row(g) for g in (g32, tf_amp.graph, b16.graph))
    print("amp: device ms per step by layer: float32 measured / AMP-predicted / "
          "bfloat16 measured")
    for row, _ in AMP_ROWS:
        print(f"amp:   {row:<9} {rows32[row]:10.3f} {rows_pred[row]:10.3f} "
              f"{rows16[row]:10.3f}")
    print(f"amp:   {'total':<9} {sum(rows32.values()):10.3f} "
          f"{sum(rows_pred.values()):10.3f} {sum(rows16.values()):10.3f}")
    base_ms = (meas["fp32"] + meas["fp32 2"]) / 2
    fidelity = sim_ms / base_ms - 1
    err, diag_err = pred_ms / meas["bf16"] - 1, diag_ms / meas["bf16"] - 1
    speedups = (sim_ms / pred_ms, base_ms / meas["bf16"])
    print(f"amp: measured (CUDA events, median of {WHATIF_ITERS}) float32 "
          f"{meas['fp32']:.3f} ms, bfloat16 {meas['bf16']:.3f} ms, float32 "
          f"{meas['fp32 2']:.3f} ms; baseline simulated {sim_ms:.3f} ms vs measured "
          f"{base_ms:.3f} ms: error {fidelity:+.2%} (need within {FIDELITY_TOL:.0%}); "
          f"amp predicted {pred_ms:.3f} ms vs measured {meas['bf16']:.3f} ms: error "
          f"{err:+.2%}, with the attention backward and the update left alone "
          f"{diag_err:+.2%} (printed, not gated: the paper's band is "
          f"{PREDICT_TOL:.0%}, but the port's bfloat16 step keeps the attention "
          f"backward in float32, and Algorithm 3 divides device tasks only, not "
          f"the host's own time above); speedup "
          f"predicted {speedups[0]:.4f}x, measured {speedups[1]:.4f}x (need both > 1)")
    if abs(fidelity) > FIDELITY_TOL:
        fail(f"simulated float32 step {sim_ms:.3f} ms is {fidelity:+.2%} off the "
             f"measured {base_ms:.3f} ms")
    if min(speedups) <= 1:
        fail(f"AMP speedups predicted {speedups[0]:.4f}x, measured {speedups[1]:.4f}x")
    handoff.update(fused=b16, fused_ms=meas["bf16"])
    del states, step_fns, b32, b16, g32, scen, pred, tf_amp, fused_pred
    torch.cuda.empty_cache()

    # the analytical route on the card's own step, on meta tensors
    before = torch.cuda.memory_allocated()
    m16, meta16_s = _meta_trace(cfg)
    m32, meta32_s = _meta_trace(cfgs["fp32"])
    handoff["meta16"] = m16
    after = torch.cuda.memory_allocated()
    dev = m16.graph.lane_tasks(DEVICE_STREAM)
    tasks = {k: sum(t.attrs.get("kernel") == k for t in dev)
             for k in ("flash_attention", "rmsnorm", "fused_adam", "dgc_mask")}
    no_phase = sum(t.phase is None for t in dev)
    meta16_ms = m16.simulate().makespan * 1e3
    meta32_ms = m32.simulate().makespan * 1e3
    meta_pred = Scenario(graph=m32.graph, cost=m32.cost).evaluate("amp")[0]
    print(f"amp: trace_compiled on meta tensors: bfloat16 step {meta16_s:.1f}s, "
          f"{len(dev)} device tasks, kernel tasks {tasks} (need 22/45/1/0), {no_phase} "
          f"without a phase (need 0), simulated {meta16_ms:.3f} ms = "
          f"{meta16_ms / meas['bf16']:.4f} of the measured {meas['bf16']:.3f} ms (the "
          f"roofline at the data sheet's peaks, printed); float32 step {meta32_s:.1f}s, "
          f"simulated {meta32_ms:.3f} ms, amp predicts {meta_pred.speedup:.4f}x against "
          f"{speedups[1]:.4f}x measured; device memory allocated {before} -> {after} "
          f"bytes (need unchanged)")
    if tasks != {"flash_attention": L, "rmsnorm": 2 * L + 1, "fused_adam": 1,
                 "dgc_mask": 0} or no_phase:
        fail(f"analytical graph: kernel tasks {tasks}, {no_phase} without a phase")
    if after != before:
        fail(f"trace_compiled changed the allocated device memory: {before} -> {after}")
    return {"device": name, "shape": f"train_4k, micro-batch {TRAIN_BATCH}, "
            "AdamW(fused=True), float32 -> bfloat16", "allow_tf32": tf32,
            "fp32_ms": base_ms, "fp32_runs_ms": [meas["fp32"], meas["fp32 2"]],
            "bf16_ms": meas["bf16"], "simulated_fp32_ms": sim_ms, "fidelity": fidelity,
            "predicted_ms": pred_ms, "predicted_speedup": speedups[0],
            "measured_speedup": speedups[1], "error": err,
            "diagnostic_predicted_ms": diag_ms, "diagnostic_error": diag_err,
            "fused_optimizer_predicted_ms": fused_pred_ms, "fp32_host_lane_ms": host_ms,
            "fp32_command_buffer_waits": waits, "fp32_released_host_tasks": released,
            "in_flight_max": {k: v[0] for k, v in queue.items()},
            "launch_lead_ms": {k: v[1] for k, v in queue.items()},
            "issue_wait_ms": issue,
            "device_ms": {"fp32": sum(rows32.values()), "amp_predicted": sum(rows_pred.values()),
                          "bf16": sum(rows16.values())},
            "device_ms_by_layer": {"fp32": rows32, "amp_predicted": rows_pred,
                                   "bf16": rows16},
            "bf16_update_by_op": update,
            "peak_gb": peak_gb, "trace_s": trace_s,
            "analytical": {"bf16_simulated_ms": meta16_ms,
                           "ratio_to_measured_bf16": meta16_ms / meas["bf16"],
                           "fp32_simulated_ms": meta32_ms,
                           "amp_predicted_speedup": meta_pred.speedup,
                           "device_tasks": len(dev), "kernel_tasks": tasks,
                           "capture_s": [meta16_s, meta32_s]}}


def _priced(graph, cost):
    """A copy of a captured step graph with every device task priced by
    ``cost`` from its FLOPs and bytes, as the analytical route prices an
    operator (host tasks keep their captured times)."""
    tf = GraphTransform(graph)
    for t in tf.graph.lane_tasks(DEVICE_STREAM):
        t.duration = cost.compute_time(t.flops, t.bytes_accessed)
    return tf.graph


def traceio_phase(name: str, traces: Path, handoff: dict) -> dict:
    """The whatif and amp phases' captures through ``repro_torch.traceio``
    and ``repro_torch.analysis`` (paper §6's task-level check), profiling
    nothing again: the bfloat16 fused step (amp phase) written as
    torch.profiler exports it, read back with ``load_trace_dir`` and held to
    ``trace_measured``'s makespan, exported with ``TraceBundle.export_chrome``
    and re-imported (both within 1e-6); the per-leaf step (whatif phase)
    with ``fused_optimizer`` diffed against the fused capture task by task;
    the fused step's critical path and the registry's opportunity bounds;
    the capture calibrated against itself (a faithful replay: nothing to
    fit), then the cost model's constants fitted to the capture (each device
    task priced by ``CostModel(hw=H100_SXM)`` against its captured time) and
    the analytical bfloat16 step priced with them.  Returns the ``traceio``
    JSON object."""
    t0 = time.perf_counter()
    bundle, meta16 = handoff["fused"], handoff["meta16"]
    cost = CostModel(hw=H100_SXM)
    want = bundle.simulate().makespan
    fused = load_trace_dir(str(traces / "fused"))
    load_s = time.perf_counter() - t0
    got = simulate(fused.graphs[0]).makespan
    (traces / "export").mkdir()
    bundle.export_chrome(str(traces / "export" / "worker0.trace.json"))
    back = simulate(load_trace_dir(str(traces / "export")).graphs[0]).makespan
    rt = {"import": got / want - 1, "export_reimport": back / want - 1}
    print(f"traceio: the fused bfloat16 step's capture ({PT_TRACE}) read back by "
          f"load_trace_dir in {load_s:.1f}s: {len(fused.graphs[0])} tasks, simulated "
          f"{got * 1e3:.6f} ms against trace_measured's {want * 1e3:.6f} ms ({rt['import']:+.3g}); "
          f"export_chrome and re-import {back * 1e3:.6f} ms ({rt['export_reimport']:+.3g}) "
          f"(need both within {ROUNDTRIP_TOL:g})")
    if max(map(abs, rt.values())) > ROUNDTRIP_TOL:
        fail(f"trace round trip off the captured step's makespan: {rt}")

    t1 = time.perf_counter()
    perleaf = Scenario(trace_dir=str(traces / "perleaf"), cost=cost)
    diff = perleaf.diff_against(fused, "fused_optimizer")
    kinds = diff.per_kind()
    top = diff.top_mispredicted(5)
    print(f"traceio: per-leaf capture with fused_optimizer against the fused "
          f"capture ({time.perf_counter() - t1:.1f}s):")
    for line in diff.format(top=5).splitlines():
        print(f"traceio:   {line[:200]}")
    if not diff.tasks:
        fail("the diff matched no task")

    t1 = time.perf_counter()
    base = Scenario(traces=fused, cost=cost)
    cp = base.predict("noop").critical_path
    fractions = cp.fractions()
    opps = rank_opportunities(base)
    print(f"traceio: fused step's critical path ({len(cp.segments)} segments, "
          f"{cp.makespan * 1e3:.3f} ms): " + ", ".join(
              f"{k} {v:.4f}" for k, v in fractions.items())
          + "; opportunity bounds " + ", ".join(
              f"{o.optimization.name} {o.bound:.4f}x" for o in opps)
          + f" ({time.perf_counter() - t1:.1f}s)")
    if abs(sum(fractions.values()) - 1) > 1e-9 or abs(cp.makespan - got) > 1e-9 * got:
        fail(f"critical path {cp.makespan} s, fractions {fractions}, against {got} s")

    t1 = time.perf_counter()
    _, own = base.calibrate()
    priced = dataclasses.replace(fused, graphs=[_priced(fused.graphs[0], cost)])
    calibrated, rep = Scenario(traces=priced, cost=cost).calibrate()
    meta_ms = meta16.simulate().makespan * 1e3
    meta_cal_ms = ClusterGraph.from_worker_graphs(
        [meta16.graph], cost=calibrated.cost).simulate().makespan * 1e3
    fitted = {k: v[1] for k, v in rep.fitted.items()}
    print(f"traceio: calibrate on the fused capture itself: loss "
          f"{own.loss_before:.3g} -> {own.loss_after:.3g} in {own.sim_calls} "
          f"simulator call(s) (need a faithful replay, loss < 1e-9); the cost "
          f"model against the same capture ({time.perf_counter() - t1:.1f}s):")
    for line in rep.format().splitlines():
        print(f"traceio:   {line}")
    print(f"traceio: analytical bfloat16 step (trace_compiled) {meta_ms:.3f} ms = "
          f"{meta_ms / handoff['fused_ms']:.4f} of the measured "
          f"{handoff['fused_ms']:.3f} ms; with the fitted constants {meta_cal_ms:.3f} "
          f"ms = {meta_cal_ms / handoff['fused_ms']:.4f} (printed, not gated); phase "
          f"{time.perf_counter() - t0:.1f}s")
    if own.loss_before > 1e-9 or rep.loss_after > rep.loss_before:
        fail(f"calibration: own capture loss {own.loss_before}, cost model "
             f"{rep.loss_before} -> {rep.loss_after}")
    return {"device": name, "capture": f"bf16 fused train_4k step, {PT_TRACE}",
            "tasks": len(fused.graphs[0]), "roundtrip_rel_err": rt,
            "simulated_ms": got * 1e3,
            "diff": {"baseline": "per-leaf + fused_optimizer",
                     "captured": "fused", "matched": len(diff.tasks),
                     "unmatched_predicted": len(diff.unmatched_predicted),
                     "unmatched_captured": len(diff.unmatched_captured),
                     "makespan_rel_err": diff.makespan_rel_error,
                     "wape": {k: v.wape for k, v in kinds.items()},
                     "top": [{"thread": d.thread, "name": d.name[:80],
                              "occurrence": d.occurrence, "dur_error_ms": d.dur_error * 1e3,
                              "start_error_ms": d.start_error * 1e3} for d in top]},
            "critical_path": fractions,
            "opportunities": {o.optimization.name: o.bound if math.isfinite(o.bound)
                              else None for o in opps},    # None: unbounded
            "calibration": {"own_capture_loss": own.loss_before,
                            "fitted": fitted, "loss_before": rep.loss_before,
                            "loss_after": rep.loss_after,
                            "wape_before": {k: v.wape for k, v in rep.before.per_kind().items()},
                            "wape_after": {k: v.wape for k, v in rep.after.per_kind().items()},
                            "analytical_bf16_ms": meta_ms,
                            "analytical_bf16_calibrated_ms": meta_cal_ms,
                            "ratio_to_measured": [meta_ms / handoff["fused_ms"],
                                                  meta_cal_ms / handoff["fused_ms"]]},
            "phase_s": time.perf_counter() - t0}


def _sheet(dtype_str: str) -> float:
    """The data sheet's matrix-product peak for ``dtype_str`` on the H100
    SXM, as torch runs it (float32 on the CUDA cores unless TF32 is on)."""
    if dtype_str == "bfloat16":
        return PEAK_BF16_FLOPS
    return PEAK_TF32_FLOPS if torch.backends.cuda.matmul.allow_tf32 else PEAK_F32_FLOPS


def _profiler_cost() -> dict:
    """Host microseconds per cheap operator (an in-place add on 1024
    floats) issued in a chain of PROFILER_OPS, without and with
    torch.profiler active as ``trace_measured`` runs it (CPU and CUDA
    activities, shapes recorded); medians of PROFILER_ROUNDS interleaved
    rounds, each issue timed on the host clock before its sync."""
    x = torch.zeros(1024, device=DEV)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if DEV == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def chain() -> float:
        t0 = time.perf_counter()
        for _ in range(PROFILER_OPS):
            x.add_(1.0)
        dt = time.perf_counter() - t0
        sync()
        return dt

    chain()
    plain, prof = [], []
    for _ in range(PROFILER_ROUNDS):
        plain.append(chain())
        with torch.profiler.profile(activities=acts, record_shapes=True):
            prof.append(chain())
    us = {k: sorted(v)[len(v) // 2] / PROFILER_OPS * 1e6
          for k, v in (("plain", plain), ("profiled", prof))}
    return {**us, "added": us["profiled"] - us["plain"]}


def _run_clis(cmds: dict, cwd: Path) -> dict:
    """Run each ``python -m <argv>`` with ``PYTHONPATH=src``, all at once
    (they run on the host only), and wait for every one: name -> exit code,
    seconds, stdout, stderr."""
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}

    def one(argv):
        t0 = time.perf_counter()
        try:
            p = subprocess.run([sys.executable, "-m", *argv], cwd=cwd, env=env,
                               capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:     # run() has killed it
            return {"exit": None, "s": time.perf_counter() - t0, "stdout": str(e.stdout),
                    "stderr": f"timed out after {CLI_TIMEOUT_S}s"}
        return {"exit": p.returncode, "s": time.perf_counter() - t0,
                "stdout": p.stdout, "stderr": p.stderr}

    with ThreadPoolExecutor(len(cmds)) as pool:
        futures = {k: pool.submit(one, argv) for k, argv in cmds.items()}
        return {k: f.result() for k, f in futures.items()}


def launch_phase(cfg, name: str, kernels: list, traces: Path, handoff: dict,
                 amp: dict) -> dict:
    """Daydream's command-line tools and ``core/calibrate.py`` on the card:
    the device's rates measured against its data sheet; the profiler's host
    cost per operator; ``perf_report``'s compiled route (the per-device
    train_4k step of the reference's 256-chip cell, traced on meta tensors)
    priced by the data sheet and by the calibrated rates, against the same
    step measured; then the four CLIs as a user runs them, on the whatif and
    amp phases' captures.  Returns the ``launch`` JSON object."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    # 1. the device's rates, at the reference's defaults and filling the card
    rates = {}
    for size, dt in CAL_SIZES:
        m = measure_local_backend(size, dt, device=DEV)
        sheet = {"matmul_flops_per_s": _sheet(dt), "elementwise_bytes_per_s": PEAK_BYTES}
        share = {k: m[k] / v for k, v in sheet.items()}
        rates[f"{dt} {size}"] = {**m, "share_of_sheet": share}
        print(f"launch: measure_local_backend({size}, {dt!r}): matmul "
              f"{m['matmul_flops_per_s']:.4g} FLOP/s ({share['matmul_flops_per_s']:.2%} of "
              f"{sheet['matmul_flops_per_s']:.4g}), elementwise "
              f"{m['elementwise_bytes_per_s']:.4g} B/s ({share['elementwise_bytes_per_s']:.2%} "
              f"of {PEAK_BYTES:.4g}), no-op launch and sync {m['op_overhead_s'] * 1e6:.2f} us "
              f"(H100_SXM assumes op_overhead {H100_SXM.op_overhead * 1e6:.0f} us, "
              f"host_dispatch {H100_SXM.host_dispatch * 1e6:.0f} us)")
        if not (min(m.values()) > 0 and max(share.values()) <= SHEET_TOL):
            fail(f"calibration at {size} {dt}: {m} (need > 0 and <= {SHEET_TOL}x "
                 f"the data sheet)")
    size, dt = CAL_SIZES[-1]
    costs = {"H100_SXM": CostModel(hw=H100_SXM),
             "calibrated": calibrated_cost_model(device=DEV, size=size, dtype_str=dt),
             "calibrated_defaults": calibrated_cost_model(device=DEV)}
    for label in ("calibrated", "calibrated_defaults"):
        print(f"launch: {label} cost model: {costs[label].hw}")
    torch.cuda.empty_cache()

    # 2. the profiler's host cost per operator (ROADMAP C5)
    prof = _profiler_cost()
    n_ops = sum(e.get("cat") == "cpu_op" for e in handoff["fused"].module)
    issue_ms, lane_ms = amp["issue_wait_ms"]["fp32"][0], amp["fp32_host_lane_ms"]
    print(f"launch: host us per operator ({PROFILER_OPS} in-place adds, median of "
          f"{PROFILER_ROUNDS}): {prof['plain']:.3f} without torch.profiler, "
          f"{prof['profiled']:.3f} with it: {prof['added']:+.3f} us each; the bf16 "
          f"fused step's capture holds {n_ops} operator records, so profiling adds "
          f"~{prof['added'] * n_ops / 1e3:.1f} ms of host time to a step; the float32 "
          f"step issued in {issue_ms:.1f} ms unprofiled, its profiled host lane "
          f"{lane_ms:.1f} ms (amp phase)")

    # 3. perf_report's compiled route at full width and depth
    shape = SHAPES[LAUNCH_SHAPE]
    t1 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    bundle = perf_report.trace_cell(cfg, shape, LAUNCH_CHIPS)
    trace_s = time.perf_counter() - t1
    if torch.cuda.memory_allocated() != before:
        fail("perf_report.trace_cell allocated device memory")
    tot, fb, base, modeled = perf_report.flash_rooflines(bundle, cfg, shape, LAUNCH_CHIPS)
    cal_rows = perf_report.flash_rooflines(bundle, cfg, shape, LAUNCH_CHIPS,
                                           cost=costs["calibrated"])[2:]
    rows = {"compiled": base, "with flash": modeled, "compiled (calibrated)": cal_rows[0],
            "with flash (calibrated)": cal_rows[1]}
    for label, r in rows.items():
        print(f"launch: {label:<24}: {perf_report.format_row(ARCH, LAUNCH_SHAPE, 'single', r)}")
    print(f"launch: attention core {tot['attn_bytes'] / 1e9:.1f} GB of "
          f"{tot['bytes'] / 1e9:.1f} GB -> flash kernel {fb / 1e9:.2f} GB per device")
    bad_rows = [k for k, r in rows.items() if not (
        r["compute_s"] > 0 and r["memory_s"] > 0 and r["collective_s"] == 0
        and r["bound"] in ("compute", "memory") and 0 < r["useful_compute_ratio"] <= 1
        and 0 < r["roofline_fraction"] <= 1 and r["chips"] == LAUNCH_CHIPS)]
    if bad_rows or not (modeled["memory_s"] < base["memory_s"]
                        and 0 < fb < tot["attn_bytes"] < tot["bytes"]):
        fail(f"perf_report rows {bad_rows} out of range: {rows}, {tot}, {fb}")
    L = cfg.n_layers
    dev = bundle.graph.lane_tasks(DEVICE_STREAM)
    tasks = {k: sum(t.attrs.get("kernel") == k for t in dev)
             for k in ("flash_attention", "rmsnorm", "fused_adam", "dgc_mask")}
    want = {"flash_attention": L, "rmsnorm": 2 * L + 1, "fused_adam": 1, "dgc_mask": 0}
    if tasks != want:
        fail(f"the compiled route's kernel tasks {tasks} != {want}")
    sim = {"H100_SXM": bundle.simulate().makespan * 1e3}
    for label in ("calibrated", "calibrated_defaults"):
        g, _ = graph_from_meta_events(bundle.module, costs[label])
        sim[label] = simulate(g).makespan * 1e3
    n_dev = len(dev)
    del bundle, dev
    print(f"launch: trace_cell (meta tensors) in {trace_s:.1f}s: {n_dev} device tasks, "
          f"kernel tasks {tasks} (need {want}); simulated step " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in sim.items()))

    # the same per-device step on the card
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in make_batch(
        cfg, seq_len=shape.seq_len, batch=shape.global_batch // LAUNCH_CHIPS,
        step=0).items()}
    trainer = Trainer(cfg, TrainerConfig(steps=1, log_every=0, seed=0),
                      optimizer=AdamW(fused=True), device=DEV)
    holder = {"state": trainer.init_state(), "steps": 0}
    _rescale_attention(cfg, holder["state"]["params"])

    def step():
        holder["state"], holder["metrics"] = trainer.step_fn(holder["state"], batch)
        holder["steps"] += 1

    ops.reset_launch_counts()
    runs = [measure_wallclock(step, device=DEV, iters=WHATIF_ITERS, warmup=1) * 1e3
            for _ in range(LAUNCH_RUNS)]
    sync()
    counts, by_variant = ops.launch_counts(), dict(flash_kernel.launches_by_variant)
    n = holder["steps"]
    want_counts = {"flash_attention": L * n, "rmsnorm": (2 * L + 1) * n,
                   "fused_adam": n, "dgc_mask": 0}
    loss = float(holder["metrics"]["loss"])
    del holder, trainer, batch
    torch.cuda.empty_cache()
    measured = sorted(runs)[len(runs) // 2]
    ratios = {k: v / measured for k, v in sim.items()}
    print(f"launch: the per-device step on the card (batch {shape.global_batch // LAUNCH_CHIPS}"
          f" x {shape.seq_len}, AdamW(fused=True), CUDA events, medians of "
          f"{WHATIF_ITERS}): " + ", ".join(f"{r:.3f}" for r in runs)
          + f" ms, median {measured:.3f} ms, last loss {loss:.4f}; analytical / "
          f"measured " + ", ".join(f"{k} {v:.4f}" for k, v in ratios.items())
          + f" (printed, not gated); launches over its {n} steps {counts}, flash by "
          f"kernel {by_variant} (need {want_counts}, all 'wgmma')")
    if counts != want_counts or by_variant != {"wgmma": L * n, "scalar": 0}:
        fail(f"launch phase launch counts {counts} {by_variant} != {want_counts}")
    if not math.isfinite(loss):
        fail(f"non-finite loss {loss} in the launch phase's step")
    for kern in kernels:
        kern.setdefault("launches_by_path", {})["launch"] = counts[kern["name"]]

    # 4. the CLIs as a user runs them
    fused, perleaf, out = traces / "fused", traces / "perleaf", traces / "launch"
    out.mkdir()
    cmds = {
        "diagnose": ["repro_torch.launch.diagnose", "--trace-dir", str(fused),
                     "--calibrate", "--what-if", "fused_optimizer"],
        "calibrate": ["repro_torch.launch.calibrate", "--trace-dir", str(fused), "--diff"],
        "perf_report_trace": ["repro_torch.launch.perf_report", "--trace-dir", str(perleaf),
                              "--what-if", "fused_optimizer", "--critical-path",
                              "--timeline", "--export-trace", str(out / "export")],
        "perf_report_goodput": ["repro_torch.launch.perf_report", "--trace-dir",
                                str(perleaf), "--goodput"],
        "perf_report_serving": ["repro_torch.launch.perf_report", "--serving",
                                "--arch", ARCH],
        "perf_report_cluster": ["repro_torch.launch.perf_report", "--arch", ARCH,
                                "--shape", LAUNCH_SHAPE, "--cluster", "4", "--what-if",
                                "amp", "--out", str(out)],
        "hillclimb": ["repro_torch.launch.hillclimb", "--arch", ARCH, "--shape",
                      LAUNCH_SHAPE, "--tag", "smoke", "--search-whatif", "2",
                      "--out", str(out)],
    }
    keys = {"diagnose": ["wape before", "== critical path", "== opportunity ranking",
                         "== what-if fused_optimizer =="],
            "calibrate": ["wape before", "wape after", "makespan rel err"],
            "perf_report_trace": ["== what-if fused_optimizer on imported traces ==",
                                  "== critical path", "== timelines",
                                  "exported 1 per-worker Chrome traces"],
            "perf_report_goodput": ["== goodput: 1 worker(s)", "noop"],
            "perf_report_serving": [f"== serving {ARCH}:", "noop"],
            "perf_report_cluster": ["compiled    : ", "with flash  : ", "== what-if amp ==",
                                    "== cluster x4: 4 workers", "attention-loop bytes"],
            "hillclimb": ["== what-if search ordering", "round 1: ", "wrote "]}
    t1 = time.perf_counter()
    clis = _run_clis(cmds, out)
    clis_s = time.perf_counter() - t1
    for k, r in clis.items():
        missing = [key for key in keys[k] if key not in r["stdout"]]
        lines = r["stdout"].splitlines()
        print(f"launch: python -m {cmds[k][0]} {' '.join(cmds[k][1:])}: exit {r['exit']} "
              f"in {r['s']:.1f}s, {len(lines)} lines")
        for line in (lines if k in ("hillclimb", "perf_report_cluster") else lines[-6:]):
            print(f"launch:   {line[:160]}")
        if r["exit"] != 0 or missing:
            print(r["stderr"][-3000:], file=sys.stderr)
            fail(f"{cmds[k][0]} exited {r['exit']}, missing {missing}")
    predicted = float(clis["perf_report_trace"]["stdout"].split("predicted :")[1]
                      .split("ms")[0])
    back = simulate(load_trace_dir(str(out / "export")).graphs[0]).makespan * 1e3
    rec = json.loads((out / f"{ARCH}__{LAUNCH_SHAPE}__single__smoke.json").read_text())
    trail = [rec["baseline_ms"]] + [r["predicted_ms"] for r in rec["trail"]]
    print(f"launch: the export re-imported: {back:.6f} ms against the printed "
          f"{predicted:.3f} ms; hillclimb baseline and rounds {trail} ms (need each "
          f"no slower than the one before); the CLIs in {clis_s:.1f}s together, "
          f"phase {time.perf_counter() - t0:.1f}s")
    if abs(back - predicted) > 5e-4 + 1e-6 * predicted:
        fail(f"the exported prediction re-imports to {back} ms, printed {predicted} ms")
    if not rec["trail"] or any(b > a for a, b in zip(trail, trail[1:])):
        fail(f"hillclimb's trail {trail} is not descending")
    return {"device": name, "rates": rates,
            "calibrated_hw": {k: dataclasses.asdict(c.hw) for k, c in costs.items()},
            "profiler_us_per_op": prof, "fused_step_operator_records": n_ops,
            "compiled": {"shape": f"{LAUNCH_SHAPE}, {shape.global_batch // LAUNCH_CHIPS} x "
                         f"{shape.seq_len} per device of {LAUNCH_CHIPS}",
                         "trace_s": trace_s, "device_tasks": n_dev, "kernel_tasks": tasks,
                         "rows": rows, "attn_bytes": tot["attn_bytes"],
                         "flash_bytes": fb, "simulated_ms": sim},
            "measured": {"runs_ms": runs, "ms": measured, "steps": n, "launches": counts},
            "ratios": ratios,
            "clis": {k: {"exit": r["exit"], "s": r["s"]} for k, r in clis.items()},
            "clis_s": clis_s, "export_reimport_ms": back, "hillclimb_trail_ms": trail,
            "phase_s": time.perf_counter() - t0}


def _filesystem(path: Path) -> dict:
    """The filesystem ``path`` lies on: type and mount point from
    /proc/mounts (the longest mount point above it), and its free bytes."""
    real, best = os.path.realpath(path), ("?", "/")
    with open("/proc/mounts") as f:
        for line in f:
            fstype, mnt = line.split()[2], line.split()[1].replace("\\040", " ")
            if ((real == mnt or real.startswith(mnt.rstrip("/") + "/"))
                    and len(mnt) >= len(best[1])):
                best = (fstype, mnt)
    return {"path": str(path), "type": best[0], "mount": best[1],
            "free_bytes": shutil.disk_usage(real).free}


def _npy_bytes(step_dir: Path) -> int:
    """The payload bytes of a checkpoint's ``.npy`` files, from their
    headers."""
    readers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    total = 0
    for path in step_dir.glob("*.npy"):
        with open(path, "rb") as f:
            shape, _, dtype = readers[np.lib.format.read_magic(f)](f)
        total += math.prod(shape) * dtype.itemsize
    return total


def _state_diff(a, b) -> float:
    """The largest |a - b| over the leaves of two trainer states (or
    params trees): 0.0 when every leaf is ``torch.equal`` in the same dtype,
    inf when the trees or dtypes differ."""
    na, nb = _named(a), _named(b)
    if sorted(na) != sorted(nb):
        return math.inf
    worst = 0.0
    for k, x in na.items():
        y = nb[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            return math.inf
        if not torch.equal(x, y):
            d = (x.float() - y.float()).abs().max().item()
            worst = max(worst, d if d > 0 else math.inf)     # inf: NaNs
    return worst


def _clone_state(state) -> dict:
    """A copy of a trainer state that a step can update in place (the AdamW
    moments flat-backed again)."""
    opt = state["opt"]
    new = opt_state(opt["m"], opt["v"], int(opt["count"]))
    new["gnorm"].copy_(opt["gnorm"])
    return {"params": _tree_map(torch.clone, state["params"]), "opt": new,
            "step": state["step"].clone()}


def _fit_and_save(cfg, directory: Path) -> tuple:
    """``Trainer.fit`` of CKPT_STEPS fused steps with one synchronous save
    after the last: (trainer, state, the save's seconds)."""
    stamps = []
    trainer = Trainer(cfg, TrainerConfig(steps=CKPT_STEPS, log_every=0, seed=0,
                                         ckpt_every=CKPT_STEPS,
                                         ckpt_dir=str(directory),
                                         ckpt_async=False),
                      optimizer=AdamW(fused=True), device=DEV)
    state = trainer.fit(Prefetcher(_batches(cfg, TRAIN_SEQ, TRAIN_BATCH)),
                        hooks=lambda i, m: stamps.append(time.perf_counter()))
    sync()          # the hook ran after step CKPT_STEPS - 1 was read back
    return trainer, state, time.perf_counter() - stamps[-1]


def _restore(cfg, directory: Path) -> tuple:
    """A fresh trainer's ``restore_or_init`` (``like`` on meta tensors):
    (trainer, state, seconds)."""
    trainer = Trainer(cfg, TrainerConfig(ckpt_dir=str(directory), log_every=0),
                      optimizer=AdamW(fused=True), device=DEV)
    sync()
    t0 = time.perf_counter()
    state = trainer.restore_or_init()
    sync()
    return trainer, state, time.perf_counter() - t0


def _delete(directory: Path) -> float:
    """Seconds to delete a checkpoint directory: what
    ``CheckpointManager.save`` also pays, once it holds ``keep`` of them,
    to drop the oldest."""
    t0 = time.perf_counter()
    shutil.rmtree(directory)
    return time.perf_counter() - t0


def _check_checkpoint(cfg, state, restored, directory: Path, label: str) -> int:
    """The checkpoint's bytes on disk against ``checkpoint_bytes`` and
    12 B per parameter + 12 (bf16 params on an f32 carrier, f32 m and v,
    count, gnorm, step), and the restored state bit-equal to the saved one
    with flat-backed moments.  Returns the bytes."""
    n = count_params(cfg)
    est, on_disk = checkpoint_bytes(state), _npy_bytes(
        directory / f"step_{latest_step(str(directory)):08d}")
    diff = _state_diff(restored, state)
    for tree in ("m", "v"):
        _flat_buffer(tree_leaves(restored["opt"][tree]))     # raises if not
    print(f"faults: {label}: checkpoint_bytes {est} B, .npy payloads {on_disk} B, "
          f"12 x {n} + 12 = {12 * n + 12} B (need all equal); restored state "
          f"{'bit-equal' if diff == 0 else f'off by {diff:.3g}'} (need bit-equal), "
          f"moments flat-backed")
    if not est == on_disk == 12 * n + 12 or diff != 0:
        fail(f"{label} checkpoint: {est} / {on_disk} / {12 * n + 12} B, diff {diff}")
    return est


def _progress_reaches(scn, spec: str, n: int) -> tuple:
    """(the simulated wall time at which the committed-step timeline
    reaches ``n``, the prediction at that horizon).  The goodput engine
    samples its progress at fault events and at the horizon only, so the
    time is the shortest horizon whose timeline ends at ``n`` or more
    (bisected to 1e-7 of it: committed steps only grow with the horizon)."""
    def at(h):
        pred = dataclasses.replace(scn, horizon_s=h).predict(spec)
        return pred.progress_timeline.value_at(h), pred

    lo, hi = 0.0, scn.horizon_s
    done, pred = at(hi)
    if done < n:
        fail(f"the simulated drill commits {done} of {n} steps in {hi} s")
    while hi - lo > 1e-7 * hi:
        mid = (lo + hi) / 2
        done, got = at(mid)
        if done >= n:
            hi, pred = mid, got
        else:
            lo = mid
    return hi, pred


def _drill(cfg, trainer, directory: Path, every: int, fail_at) -> dict:
    """``FaultTolerantRunner`` over ``trainer``'s step on
    ``SyntheticLM.batch_at(i)`` for DRILL_STEPS steps, a synchronous save
    through ``CheckpointManager`` every ``every`` steps, restores onto the
    card, and one failure injected before step ``fail_at`` (None: none):
    the wall time (host clock, from ``run`` to its end, ending in a sync),
    each save's and restore's seconds (from a sync: the steps before them
    are not theirs), the launches, the steps executed and the final
    state."""
    mgr = CheckpointManager(str(directory), keep=DRILL_KEEP)
    # made before the run: the drill times steps, checkpoints and restarts,
    # not the host's Python loop that generates a batch
    data = SyntheticLM(cfg.vocab, TRAIN_SEQ, DRILL_BATCH)
    batches = [data.batch_at(i) for i in range(DRILL_STEPS)]
    like = state_to_reference(cfg, trainer.init_state("meta"))
    executed, fired, saves, restores = [], [], [], []

    def timed(fn, into):
        def call(*args):
            sync()
            t0 = time.perf_counter()
            out = fn(*args)
            sync()
            into.append(time.perf_counter() - t0)
            return out
        return call

    def step(state, i):
        executed.append(i)
        batch = {k: torch.from_numpy(v).to(DEV) for k, v in batches[i].items()}
        return trainer.step_fn(state, batch)[0]

    def restore():
        if mgr.latest_step() is None:
            return None
        tree, last = mgr.restore_latest(like, device=DEV)
        return state_from_reference(cfg, tree, DEV), last

    def inject(i):
        if i == fail_at and not fired:
            fired.append(i)
            raise RuntimeError(f"injected failure before step {i}")

    runner = FaultTolerantRunner(
        trainer.init_state, step,
        timed(lambda state, i: mgr.save(i, state_to_reference(cfg, state)), saves),
        timed(restore, restores), policy=RetryPolicy(backoff_s=DRILL_BACKOFF_S),
        save_every=every)
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    state = runner.run(DRILL_STEPS, inject_failure=inject)
    sync()
    wall = time.perf_counter() - t0
    out = {"wall_s": wall, "launches": ops.launch_counts(),
           "flash_by_variant": dict(flash_kernel.launches_by_variant),
           "executed_steps": len(executed), "restarts": runner.restarts,
           "failures": runner.failures, "saves_s": saves,
           # the probe before step 0 finds no checkpoint: not a restore
           "restores_s": restores[1:],
           "step_s": (wall - sum(saves) - sum(restores)) / len(executed),
           "state": state}
    shutil.rmtree(directory)
    return out


def _drill_ops(every: int, fails: bool = True) -> dict:
    """The checkpoint operations of a drill that saves every ``every`` steps:
    its manager keeps DRILL_KEEP checkpoints, so its first DRILL_KEEP saves
    only write and each later one also deletes the oldest; it restores once
    if it fails (the probe before step 0 finds nothing)."""
    saves = DRILL_STEPS // every
    return {"save": min(DRILL_KEEP, saves), "save + delete": max(0, saves - DRILL_KEEP),
            "restore": int(fails)}


def _ckpt_sample(cfg, trainer, directory: Path, like) -> dict:
    """The kinds of checkpoint operation the drills perform, performed as
    they perform them, apart from them: a fresh manager keeping DRILL_KEEP
    checkpoints, as a drill's, saves DRILL_KEEP times DRILL_EVERY steps
    apart (writes only) and DRILL_KEEP times WHATIF_EVERY steps apart
    (each also deletes the oldest), then restores its latest, each timed
    from a sync to a sync as ``_drill`` times them.  Returns the seconds by
    kind, the checkpoint's bytes, and the last saved and the restored
    state."""
    mgr = CheckpointManager(str(directory), keep=DRILL_KEEP)
    state = trainer.init_state()
    out = {"save": [], "save + delete": [], "restore": []}
    for j, every in enumerate([DRILL_EVERY] * DRILL_KEEP + [WHATIF_EVERY] * DRILL_KEEP):
        for i in range(every):
            state, _ = trainer.step_fn(state, _device_batch(cfg, i, DRILL_BATCH))
        sync()
        t0 = time.perf_counter()
        mgr.save(j, state_to_reference(cfg, state))
        sync()
        out["save" if j < DRILL_KEEP else "save + delete"].append(time.perf_counter() - t0)
    sync()
    t0 = time.perf_counter()
    tree, _ = mgr.restore_latest(like, device=DEV)
    restored = state_from_reference(cfg, tree, DEV)
    sync()
    out["restore"].append(time.perf_counter() - t0)
    return {"seconds": out, "bytes": _npy_bytes(directory / f"step_{latest_step(str(directory)):08d}"),
            "saved": state, "restored": restored}


def faults_phase(cfg, name: str, kernels: list, tmp: Path) -> dict:
    """Checkpoint/restart and the goodput-under-failures simulator on the
    card (paper §6's predict -> implement -> measure, for a fault drill):
    the full-depth round trip (one synchronous save in ``Trainer.fit``, one
    ``save_async``, a restore into a fresh trainer, bit-equal, and the next
    step from it); the checkpoint cost (``ckpt_bandwidth``,
    ``ckpt_latency_s``) fitted to the saves (write and deletion of the
    oldest) and restores at full depth and at DRILL_LAYERS layers; the
    drill predicted by ``FaultScenario`` from
    the traced step and the fitted cost, then run by
    ``FaultTolerantRunner`` and measured, for the baseline and for
    ``ckpt_interval:steps=2``, and once without a failure; last
    ``python -m repro_torch.launch.goodput`` on the drill step's capture.
    Checkpoints go under ``tmp``.  Returns the ``faults`` JSON object."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ck = tmp / "ckpt"
    fs = _filesystem(tmp)
    full_bytes = 12 * count_params(cfg) + 12
    print(f"faults: checkpoints under {fs['path']}: filesystem {fs['type']} "
          f"mounted at {fs['mount']}, {fs['free_bytes']} bytes free (the write "
          f"rate below is that filesystem's, not the card's)")
    if fs["free_bytes"] < 2.5 * full_bytes:
        fail(f"{fs['free_bytes']} bytes free for two {full_bytes}-byte checkpoints")

    # 1. the round trip at full width and depth
    trainer, state, save_s = _fit_and_save(cfg, ck / "full")
    mgr = CheckpointManager(str(ck / "async"))
    t1 = time.perf_counter()
    mgr.save_async(CKPT_STEPS - 1, state_to_reference(cfg, state))
    block_s = time.perf_counter() - t1
    mgr.wait()
    wait_s = time.perf_counter() - t1 - block_s
    delete_s = _delete(ck / "async")
    fresh, restored, restore_s = _restore(cfg, ck / "full")
    nbytes = _check_checkpoint(cfg, state, restored, ck / "full", "full depth")
    shutil.rmtree(ck / "full")
    batch = _device_batch(cfg, CKPT_STEPS)
    live = []
    for _ in range(2):
        after, m = trainer.step_fn(_clone_state(state), batch)
        live.append((float(m["loss"]), after["params"]))
        del after
    ops.reset_launch_counts()
    after, m = fresh.step_fn(restored, batch)
    loss_r = float(m["loss"])
    counts = ops.launch_counts()
    variants = dict(flash_kernel.launches_by_variant)
    L = cfg.n_layers
    per_step = {"flash_attention": L, "rmsnorm": 2 * L + 1, "fused_adam": 1,
                "dgc_mask": 0}
    spread = abs(live[0][0] - live[1][0])
    deterministic = spread == 0 and _state_diff(live[0][1], live[1][1]) == 0
    off = abs(loss_r - live[0][0])
    same = (_state_diff(after["params"], live[0][1]) == 0 and off == 0
            if deterministic else off <= spread)
    print(f"faults: full depth: save in Trainer.fit {save_s:.3f} s, save_async "
          f"blocking {block_s:.3f} s + wait {wait_s:.3f} s, a checkpoint deleted "
          f"in {delete_s:.3f} s, restore_or_init {restore_s:.3f} s "
          f"({nbytes / 1e9:.3f} GB); the next step: live "
          f"{live[0][0]!r} / {live[1][0]!r} (deterministic {deterministic}), "
          f"restored {loss_r!r} (need {'bit-equal' if deterministic else 'within the live spread'}); "
          f"launches {counts}, flash by kernel {variants} (need {per_step}, all wgmma)")
    if not same:
        fail(f"the restored state's next step {loss_r!r} against the live {live}")
    if counts != per_step or variants != {"wgmma": L, "scalar": 0}:
        fail(f"restored step's launches {counts} {variants}")
    round_trip = {"arch": cfg.name, "layers": L, "checkpoint_bytes": nbytes,
                  "save_s": save_s, "save_async_block_s": block_s,
                  "save_async_wait_s": wait_s, "delete_s": delete_s,
                  "restore_s": restore_s,
                  "next_loss": {"live": [x for x, _ in live], "restored": loss_r},
                  "deterministic_step": deterministic, "launches": counts}
    meta_full = fresh.init_state("meta")
    del trainer, state, fresh, restored, after, live, batch
    torch.cuda.empty_cache()

    # 2. the drill's step traced, and the scenario it predicts from
    cfg4 = cfg.with_(n_layers=DRILL_LAYERS)
    t4 = Trainer(cfg4, TrainerConfig(log_every=0, seed=0), optimizer=AdamW(fused=True),
                 device=DEV)
    like4 = state_to_reference(cfg4, t4.init_state("meta"))
    holder = {"state": t4.init_state()}
    batch4 = _device_batch(cfg4, 0, DRILL_BATCH)

    def step():
        holder["state"], _ = t4.step_fn(holder["state"], batch4)

    (tmp / "faults").mkdir()
    bundle = trace_measured(step, device=DEV, save_to=str(tmp / "faults" / PT_TRACE))
    del holder, batch4
    cost = CostModel(hw=H100_SXM)
    base = Scenario(graph=bundle.graph, cost=cost)
    default = RecoveryModel.from_scenario(base, params_tree=meta_full)
    rec0 = dataclasses.replace(
        RecoveryModel.from_scenario(base, params_tree=t4.init_state("meta")),
        detection_s=0.0, repair_s=0.0, restart_s=DRILL_BACKOFF_S)
    scn = FaultScenario(graph=bundle.graph, cost=cost, recovery=rec0,
                        horizon_s=DRILL_HORIZON_S, ckpt_interval_steps=DRILL_EVERY,
                        timeline=FaultTimeline((), DRILL_HORIZON_S))
    steady = scn.baseline().makespan
    if bundle.simulate().makespan != steady:
        fail("the fault scenario's steady step is not the traced step's makespan")

    # 3. the drills' checkpoint operations sampled before them, in
    # SAMPLE_WINDOWS windows, and the cost fitted for each drill: the one
    # constant of its RecoveryModel is the mean of its own operations (a
    # save that also deletes costs ~1 s more, and ckpt_interval deletes in 5
    # of its 9 operations, the baseline in 1 of 5; C10)
    sample = {"save": [], "save + delete": [], "restore": []}
    for w in range(SAMPLE_WINDOWS):
        got = _ckpt_sample(cfg4, t4, ck / "fit", like4)
        saved, restored = got.pop("saved"), got.pop("restored")
        if w == 0:
            bytes4 = _check_checkpoint(cfg4, saved, restored, ck / "fit",
                                       f"{DRILL_LAYERS} layers")
        del saved, restored
        shutil.rmtree(ck / "fit")
        for kind, ts in got["seconds"].items():
            sample[kind] += ts
    drills = {"baseline": (DRILL_EVERY, DRILL_FAIL),
              "ckpt_interval": (WHATIF_EVERY, DRILL_FAIL),
              "no_failure": (DRILL_EVERY, None)}
    shares = {}
    for label, (every, fail_at) in drills.items():
        n = _drill_ops(every, fails=fail_at is not None)
        shares[label] = {k: v / sum(n.values()) for k, v in n.items()}

    def fit(share) -> tuple:
        """The checkpoint cost fitted by weighted least squares to the full
        depth's save + delete and restore and to the sample at the drills'
        depth, each kind weighted by its ``share`` of a drill's operations
        (at two sizes the line passes through each size's weighted mean):
        (RecoveryModel, ckpt_bandwidth, ckpt_latency_s)."""
        pts = [(nbytes, save_s + delete_s, 1.0), (nbytes, restore_s, 1.0)]
        for kind, ts in sample.items():
            pts += [(bytes4, t, share[kind] / len(ts)) for t in ts if share[kind]]
        x, y, w = (np.array(c, dtype=np.float64) for c in zip(*pts))
        slope, lat = np.polyfit(x, y, 1, w=np.sqrt(w))
        if lat < 0 or slope <= 0:
            # the cost per byte grows with the size (or falls), which a
            # latency >= 0 and a bandwidth cannot hold at both sizes: held
            # at the drills' size, with no latency
            slope, lat = float(np.average(y[2:], weights=w[2:]) / bytes4), 0.0
        return dataclasses.replace(rec0, ckpt_bandwidth=1.0 / slope,
                                   ckpt_latency_s=float(lat)), 1.0 / slope, float(lat)

    def predict(label, rec) -> tuple:
        """The wall time at which the drill ``label``'s committed steps
        reach DRILL_STEPS under ``rec``, and the prediction.  The failure
        comes before step DRILL_FAIL: after DRILL_FAIL steps and the saves
        among them, on the simulated clock (1 us later, so that a save
        ending there commits)."""
        every, fail_at = drills[label]
        scenario = dataclasses.replace(scn, recovery=rec)
        if fail_at is not None:
            at = fail_at * steady + fail_at // every * rec.checkpoint_write_s
            scenario = dataclasses.replace(scenario, timeline=FaultTimeline(
                (FaultEvent(at + 1e-6, "fail"),), DRILL_HORIZON_S))
        spec = "noop" if every == DRILL_EVERY else f"ckpt_interval:steps={every}"
        t, pred = _progress_reaches(scenario, spec, DRILL_STEPS)
        if pred.steady_step_s != steady:
            fail("the fault scenario's steady step is not the traced step's makespan")
        return t, pred

    fits, times = {}, {}
    for label in drills:
        rec, bw, lat = fit(shares[label])
        times[label], pred = predict(label, rec)
        fits[label] = {"ckpt_bandwidth": bw, "ckpt_latency_s": lat,
                       "checkpoint_write_s": rec.checkpoint_write_s,
                       "full_write_s": nbytes / bw + lat,
                       "failures": pred.report.failures, "lost_steps": pred.report.lost_steps}
    print(f"faults: at {DRILL_LAYERS} layers ({bytes4 / 1e9:.3f} GB, step of {DRILL_BATCH} x "
          f"{TRAIN_SEQ}) the drills' checkpoint operations, apart from them in "
          f"{SAMPLE_WINDOWS} window(s): "
          + "; ".join(f"{k} " + ", ".join(f"{t:.3f}" for t in v) for k, v in sample.items())
          + f" s; fitted with the full depth's, each drill at its own shares: "
          + "; ".join(f"{k} ({', '.join(f'{kk} {vv:.3f}' for kk, vv in shares[k].items())}): "
                      f"{f['ckpt_bandwidth'] / 1e9:.4f} GB/s + {f['ckpt_latency_s']:.4f} s, "
                      f"write = restore {f['checkpoint_write_s']:.3f} s"
                      for k, f in fits.items())
          + f"; predicted ({DRILL_STEPS} steps, traced steady step {steady * 1e3:.3f} ms, "
          f"failure before step {DRILL_FAIL}): "
          + ", ".join(f"{k} {v:.3f} s ({fits[k]['failures']} failure(s), "
                      f"{fits[k]['lost_steps']} steps lost)" for k, v in times.items()))

    # 4. the drills with a failure in each of DRILL_ROUNDS rounds, the one
    # without once (twice where the step is not deterministic), measured
    per4 = {"flash_attention": DRILL_LAYERS, "rmsnorm": 2 * DRILL_LAYERS + 1,
            "fused_adam": 1, "dgc_mask": 0}
    total = dict.fromkeys(per4, 0)
    runs = {k: [] for k in drills}
    finals = {}
    for r in range(DRILL_ROUNDS):
        labels = ["baseline", "ckpt_interval"]
        if r == 0 or (r == 1 and not deterministic):
            labels.append("no_failure")
        for label in labels:
            every, fail_at = drills[label]
            d = _drill(cfg4, t4, ck / label, every, fail_at)
            # the steps after the last save before the failure run twice
            last = max((i for i in range(fail_at or 0) if (i + 1) % every == 0),
                       default=-1)
            want_steps = DRILL_STEPS + (fail_at - last - 1 if fail_at else 0)
            want = {k: v * want_steps for k, v in per4.items()}
            want_var = {"wgmma": DRILL_LAYERS * want_steps, "scalar": 0}
            print(f"faults: round {r} drill {label} (save every {every}, failure "
                  f"before step {fail_at}): {d['wall_s']:.3f} s measured, "
                  f"{times[label]:.3f} s predicted ({times[label] / d['wall_s'] - 1:+.2%}); "
                  f"{d['executed_steps']} steps run, {d['restarts']} restart(s); "
                  f"launches {d['launches']} (need {want}), flash by kernel "
                  f"{d['flash_by_variant']}")
            if (d["executed_steps"] != want_steps or d["launches"] != want
                    or d["flash_by_variant"] != want_var
                    or d["restarts"] != (1 if fail_at else 0)):
                fail(f"drill {label}: {d['executed_steps']} steps, launches "
                     f"{d['launches']} {d['flash_by_variant']}, {d['restarts']} restarts")
            for k in total:
                total[k] += d["launches"][k]
            runs[label].append({k: d[k] for k in d if k != "state"})
            finals[label if label not in finals else f"{label} {r}"] = d["state"]
    ref_state = finals["no_failure"]
    diffs = {k: _state_diff(finals[k], ref_state) for k in ("baseline", "ckpt_interval")}
    spread = 0.0 if deterministic else _state_diff(finals["no_failure 1"], ref_state)
    print(f"faults: final states against the drill without a failure: "
          + ", ".join(f"{k} {'bit-equal' if v == 0 else f'off by {v:.3g}'}"
                      for k, v in diffs.items())
          + (" (need bit-equal: the step is deterministic)" if deterministic else
             f" (need within {spread:.3g}, two drills without a failure apart)"))
    if max(diffs.values()) > spread:
        fail(f"the resumed drills' final states differ from the uninterrupted "
             f"one's: {diffs}, spread {spread}")
    del finals, ref_state
    each = {k: [times[k] / d["wall_s"] - 1 for d in v] for k, v in runs.items()}
    errors = {k: float(np.median(v)) for k, v in each.items()}
    measured = {k: float(np.median([d["wall_s"] for d in v])) for k, v in runs.items()}
    steps_s = [d["step_s"] for v in runs.values() for d in v]
    saves_s = [t for v in runs.values() for d in v for t in d["saves_s"]]
    restores_s = [t for v in runs.values() for d in v for t in d["restores_s"]]
    print(f"faults: in the drills: step {np.median(steps_s) * 1e3:.3f} ms (median; "
          f"{min(steps_s) * 1e3:.3f}-{max(steps_s) * 1e3:.3f}) against the traced "
          f"{steady * 1e3:.3f} ms; save {np.median(saves_s):.3f} s "
          f"({min(saves_s):.3f}-{max(saves_s):.3f}), restore "
          f"{np.median(restores_s):.3f} s ({min(restores_s):.3f}-"
          f"{max(restores_s):.3f}) against the fitted "
          + ", ".join(f"{k} {f['checkpoint_write_s']:.3f}" for k, f in fits.items()) + " s")
    print(f"faults: median of {DRILL_ROUNDS} round(s)' errors: " + ", ".join(
              f"{k} {errors[k]:+.2%} (" + ", ".join(f"{e:+.2%}" for e in each[k]) + ")"
              for k in each)
          + f" (need baseline within {FIDELITY_TOL:.0%}, ckpt_interval within "
          f"{PREDICT_TOL:.0%})")
    if abs(errors["baseline"]) > FIDELITY_TOL or abs(errors["ckpt_interval"]) > PREDICT_TOL:
        fail(f"fault drill predictions off: {errors}")
    fit_out = {"shares": shares, "sample_s": sample, "sample_windows": SAMPLE_WINDOWS,
               "drills": fits,
               "full_depth_points": [{"bytes": nbytes, "seconds": save_s + delete_s,
                                      "what": "save + delete"},
                                     {"bytes": nbytes, "seconds": restore_s, "what": "restore"}],
               "default_full_write_s": default.checkpoint_write_s,
               "default_ckpt_bandwidth": default.ckpt_bandwidth,
               "ratio_to_default": fits["baseline"]["full_write_s"]
               / default.checkpoint_write_s}
    print(f"faults: full-depth write by the drills' fits "
          + ", ".join(f"{k} {f['full_write_s']:.3f}" for k, f in fits.items())
          + f" s against H100_SXM's default {default.checkpoint_write_s:.3f} s "
          f"({nbytes / 1e9:.4f} GB / {default.ckpt_bandwidth / 1e9:.0f} GB/s + "
          f"{default.ckpt_latency_s} s): ratio {fit_out['ratio_to_default']:.3f} (baseline's)")

    # 5. the goodput CLI on the drill step's capture
    cmd = [sys.executable, "-m", "repro_torch.launch.goodput", "--trace-dir",
           str(tmp / "faults"), "--what-if", f"ckpt_interval:steps={WHATIF_EVERY}"]
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    cli = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    for line in (cli.stderr + cli.stdout).splitlines():
        print(f"faults:   {line[:160]}")
    if cli.returncode != 0 or "steps/h" not in cli.stdout:
        fail(f"python -m repro_torch.launch.goodput exited {cli.returncode}")
    for kern in kernels:
        kern.setdefault("launches_by_path", {})["faults"] = total[kern["name"]]
    del bundle, scn, t4
    torch.cuda.empty_cache()
    return {"device": name, "filesystem": fs, "round_trip": round_trip, "fit": fit_out,
            "drill": {"layers": DRILL_LAYERS, "checkpoint_bytes": bytes4,
                      "batch": DRILL_BATCH, "steps": DRILL_STEPS, "save_every": DRILL_EVERY,
                      "whatif_save_every": WHATIF_EVERY, "fail_before_step": DRILL_FAIL,
                      "steady_step_s": steady, "rounds": DRILL_ROUNDS,
                      "predicted_s": times, "measured_s": measured,
                      "errors": errors, "round_errors": each, "runs": runs,
                      "final_state_diff": diffs, "launches": total},
            "goodput_cli": {"exit": cli.returncode, "table": cli.stdout.splitlines()},
            "phase_s": time.perf_counter() - t0}


def moe_phase(name: str, kernels: list, rows: list) -> dict:
    """The moe family on the card (moonshot-v1-16b-a3b, random weights from
    seed 0): served at full width and depth in bf16, the 2-layer model
    through the kernels against their plain versions in float32, trained
    at MOE_TRAIN_LAYERS layers, and Daydream's FusedAdam case on that step.
    Every tinyllama tensor is freed first.  ``rows`` are the kernels timed
    at its shapes (``moe_kernel_phase``), given their launches here.
    Returns the ``moe`` JSON object."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(MOE_ARCH)
    n = count_params(cfg)
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * hd * 2
    print(f"moe: {cfg.name}: {n:,} parameters x 2 B = {2 * n / 1e9:.2f} GB of bf16 "
          f"weights (the routers float32: +{4 * cfg.n_layers * cfg.d_model * cfg.n_experts / 1e9:.3f} GB "
          f"more); KV cache {kv:,} B per token; device memory still allocated "
          f"before the phase {held:.3f} GB (need <= {MOE_HELD_GB})")
    if held > MOE_HELD_GB:
        fail(f"{held:.3f} GB of earlier phases' tensors still on the card")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab, n_)],
                    max_new_tokens=NEW_TOKENS) for n_ in PROMPT_LENS]
    seq = torch.tensor(rng.integers(1, cfg.vocab, (len(reqs), max(PROMPT_LENS) + 1)),
                       device=DEV)
    serve, serve_counts, params = _serve(cfg, reqs, "moe")
    del params
    torch.cuda.empty_cache()
    paths = _moe_paths(cfg.with_(n_layers=MOE_TRAIN_LAYERS, dtype="float32"),
                       _prompt_tokens(reqs), seq)
    tcfg = cfg.with_(n_layers=MOE_TRAIN_LAYERS)
    train, train_counts = _moe_train(tcfg)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in SyntheticLM(
        cfg.vocab, TRAIN_SEQ, MOE_TRAIN_BATCH, seed=1).batch_at(0).items()}
    daydream = fused_whatif(tcfg, name, kernels, batch, "moe_whatif")
    daydream["by_layer_ms"] = _layer_table(daydream["by_layer_ms"], MOE_ROWS, "moe",
                                           "moe (routed experts)")
    wall_ms = daydream["fused_optimizer"]["measured_ms"]
    L = tcfg.n_layers
    daydream["compiled"] = _compiled_cell(
        tcfg, "moe", {"flash_attention": L, "rmsnorm": 2 * L + 1, "fused_adam": 1,
                      "dgc_mask": 0}, "moe", wall_ms)
    daydream["compiled"]["moe_layer_ms"] = daydream["compiled"]["ms_by_layer"].get("moe", 0.0)
    train["measure_wallclock"] = {
        "step_ms": wall_ms, "mfu": train["flops_per_step"] / wall_ms / 1e-3 / PEAK_BF16_FLOPS}
    print(f"moe: train mfu {train['mfu']:.4f} in Trainer.fit through Prefetcher "
          f"({train['step_ms']:.1f} ms), {train['batches_made_before']['mfu']:.4f} on "
          f"batches made before the loop ({train['batches_made_before']['step_ms']:.1f} "
          f"ms), {train['measure_wallclock']['mfu']:.4f} for the fused step under "
          f"measure_wallclock ({wall_ms:.3f} ms)")
    for kern in kernels:        # the main path: the served and the trained run
        kern["launches_by_path"]["moe"] = (serve_counts[kern["name"]]
                                           + train_counts[kern["name"]])
    for row in rows:
        row["launches"] = serve_counts[row["name"]] + train_counts[row["name"]]
    phase_s = time.perf_counter() - t0
    print(f"moe: phase {phase_s:.1f}s")
    return {"device": name, "config": f"{cfg.name}, random weights from seed 0",
            "serve": serve, "paths": paths, "kernels": rows, "train": train,
            "daydream": daydream, "phase_s": phase_s}


def _prompt_tokens(reqs) -> torch.Tensor:
    """The requests' prompts left-padded with 0 to the longest, as the
    engine batches them."""
    plen = max(len(r.prompt) for r in reqs)
    toks = torch.zeros(len(reqs), plen, dtype=torch.long, device=DEV)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r.prompt):] = torch.tensor(r.prompt)
    return toks


def _norms(cfg) -> int:
    """RMSNorm launches per forward pass: ln1 and ln2 of each layer (and
    MLA's q_norm and kv_norm; an ssm layer's ln and gated norm) and the
    final norm."""
    return (4 if cfg.family == "mla_moe" else 2) * cfg.n_layers + 1


def _flashes(cfg) -> int:
    """Flash attention launches per forward pass: one a layer, one a group
    of three in the hybrid family, none in the attention-free ssm family."""
    if cfg.family == "hybrid":
        return cfg.n_layers // 3
    return 0 if cfg.family == "ssm" else cfg.n_layers


def _flash_kernel_of(cfg) -> str:
    """The flash kernel a forward of the config launches, local window or
    not: the tensor-core kernel in bf16, the CUDA-core kernel in float32."""
    return "scalar" if cfg.dtype == "float32" else "wgmma"


def _serve(cfg, reqs, tag: str) -> tuple:
    """``ServeEngine.generate`` at full width (and the config's depth):
    launches exact (``_flashes`` flash per prefill, all on the kernel
    ``_flash_kernel_of`` names; ``_norms``
    RMSNorm per forward), then the device time of one prefill and one
    decode step (torch.profiler, few calls: a profiled call of a deep model
    is thousands of records) against the decode step's read bound: every
    weight but the embedding table (the reference's moe decode runs every
    expert at capacity 1), and the cache of the step's position: a leaf
    with a sequence axis read once, a leaf of constant size (the ssm
    family's conv window and state, the hybrid family's conv window and
    RG-LRU state) read and written whole.  Lines are printed as ``tag:``.
    (JSON, launches, the params: the caller frees them)."""
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=DEV)
    sync()
    init_s = time.perf_counter() - t0
    plen = max(PROMPT_LENS)
    engine = ServeEngine(cfg, params, max_seq=plen + NEW_TOKENS, device=DEV)
    engine.generate([Request(r.prompt, 2) for r in reqs])     # set-up, not counted
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    results = engine.generate(reqs)
    counts = ops.launch_counts()
    by_variant = dict(flash_kernel.launches_by_variant)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = engine.stats
    steps = st["decode_steps"]
    total = sum(len(r.tokens) for r in results)
    want = {"flash_attention": _flashes(cfg), "rmsnorm": _norms(cfg) * (1 + steps),
            "fused_adam": 0, "dgc_mask": 0}
    want_variant = {"wgmma": 0, "scalar": 0, _flash_kernel_of(cfg): _flashes(cfg)}
    tok_s = total / (st["prefill_s"] + st["decode_s"])
    print(f"{tag}: serve {cfg.name}, {L} layers, full width, bf16 (initialised in "
          f"{init_s:.2f}s): {len(reqs)} requests, prompts {PROMPT_LENS} (left-padded "
          f"to {plen}), {total} tokens; prefill {st['prefill_s'] * 1e3:.2f} ms, decode "
          f"{st['decode_s'] / steps * 1e3:.3f} ms/token over {steps} steps, "
          f"{tok_s:.1f} tokens/s; peak device memory {peak_gb:.2f} GB; launches "
          f"{counts}, flash by kernel {by_variant} (need {want}, {want_variant})")
    if counts != want or by_variant != want_variant:
        fail(f"{tag} serve launch counts {counts} {by_variant} != {want} {want_variant}")
    if not all(len(r.tokens) == NEW_TOKENS and all(0 <= t < cfg.vocab for t in r.tokens)
               for r in results):
        fail(f"bad generation {[r.tokens for r in results]}")

    model = build_model(cfg)
    toks = _prompt_tokens(reqs)
    with torch.inference_mode():
        logits, _ = model.prefill(params, {"tokens": toks})
        cache = init_cache(cfg, len(reqs), plen + 1, DEV)
        dec_logits, _ = model.decode(params, cache, toks[:, :1], plen)
        finite = bool(torch.isfinite(logits).all() and torch.isfinite(dec_logits).all())
        pre = device_profile(lambda: model.prefill(params, {"tokens": toks}), 2, 2)
        dec = device_profile(lambda: model.decode(params, cache, toks[:, :1], plen), 3, 2)
    weight_b = sum(t.numel() * t.element_size() for k, t in _named(params).items()
                   if k != "embed.table")
    seq_b, const_b = _cache_split(cfg, cache)
    cache_b = seq_b + 2 * const_b
    bound_ms = (weight_b + cache_b) / PEAK_BYTES * 1e3
    host_pre, host_dec = st["prefill_s"] * 1e3, st["decode_s"] / steps * 1e3
    print(f"{tag}: serve device time per prefill {pre.ms:.3f} ms over {pre.ops} ops "
          f"(busy {pre.ms / host_pre:.1%} of {host_pre:.2f} ms); per decode step "
          f"{dec.ms:.3f} ms over {dec.ops} device ops, {_norms(cfg)} of them RMSNorm "
          f"launches (busy {dec.ms / host_dec:.1%} of {host_dec:.3f} ms; the host queues "
          f"{dec.host_ms:.3f} ms a step under the profiler); the decode step's read "
          f"bound {bound_ms:.3f} ms ({weight_b / 1e9:.4f} GB of weights but the embedding "
          f"table + {cache_b / 1e6:.3f} MB of cache: {seq_b / 1e6:.3f} MB of "
          f"{plen + 1} positions read, {const_b / 1e6:.3f} MB of constant size read "
          f"and written, at 3.35e12 B/s): device {dec.ms / bound_ms:.2f}x, host "
          f"{host_dec / bound_ms:.2f}x it; logits finite {finite} (need True)")
    print(f"{tag}: serve largest device ms per decode step by op: "
          + "; ".join(f"{nm} {t:.3f}" for t, nm in dec.top))
    if not finite:
        fail(f"{tag} serve logits are not finite")
    del engine, model, cache, logits, dec_logits
    torch.cuda.empty_cache()
    return ({"layers": L, "params": count_params(cfg), "prompts": PROMPT_LENS,
             "new_tokens": NEW_TOKENS, "init_s": init_s,
             "prefill_ms": host_pre, "decode_ms_per_token": host_dec,
             "tokens_per_s": tok_s, "peak_gb": peak_gb,
             "device_prefill_ms": pre.ms, "device_decode_ms": dec.ms,
             "device_ops": {"prefill": pre.ops, "decode": dec.ops},
             "rmsnorm_launches_per_decode_step": _norms(cfg),
             "decode_bound_ms": bound_ms, "weight_bytes": weight_b,
             "cache_bytes": cache_b, "launches": counts,
             "launches_by_variant": by_variant}, counts, params)


@contextlib.contextmanager
def _plain_kernels():
    """``ops.flash_attention`` and ``ops.rmsnorm`` replaced by their plain
    versions (``kernels/ref.py``) while the block runs: the model's plain
    path on CUDA tensors, which launches no kernel."""
    saved = ops.flash_attention, ops.rmsnorm
    ops.flash_attention = (lambda q, k, v, causal=True, window=None, **_:
                           ref.flash_attention_ref(q, k, v, causal=causal,
                                                   window=window or 0))
    ops.rmsnorm = ref.rmsnorm_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.rmsnorm = saved


@contextlib.contextmanager
def _recording_routes(store: list):
    """Each ``moe._route`` call's (expert indices, aux loss) appended to
    ``store`` while the block runs."""
    plain = moe_layer._route

    def spy(*args):
        gate, idx, aux = plain(*args)
        store.append((idx, aux))
        return gate, idx, aux

    moe_layer._route = spy
    try:
        yield
    finally:
        moe_layer._route = plain


def _moe_paths(cfg, toks, seq, tag: str = "moe") -> dict:
    """The float32 model at MOE_TRAIN_LAYERS layers (attention projections
    rescaled, as the serve phase does): its prefill through the kernels
    against the same through their plain versions, then decode against a
    fresh prefill at the config's capacity (printed: the last token arrives
    last in each expert and is dropped where one is full) and with no drop
    possible (capacity factor E / top_k: gated at the reference's MoE
    tolerance)."""
    params = init_params(cfg, seed=0, device=DEV)
    _rescale_attention(cfg, params)
    model = build_model(cfg)
    kernel_routes, plain_routes = [], []
    with torch.inference_mode():
        ops.reset_launch_counts()
        with _recording_routes(kernel_routes):
            got, _ = model.prefill(params, {"tokens": toks})
        sync()
        counts = ops.launch_counts()
        with _plain_kernels(), _recording_routes(plain_routes):
            want, _ = model.prefill(params, {"tokens": toks})
        sync()
    plain_counts = ops.launch_counts()
    same = sum(int((a == b).sum()) for (a, _), (b, _) in zip(kernel_routes, plain_routes))
    share = same / sum(a.numel() for a, _ in kernel_routes)
    err = max_err(got, want)
    rel = err / want.abs().max().item()
    L = cfg.n_layers
    need = {"flash_attention": L, "rmsnorm": _norms(cfg), "fused_adam": 0, "dgc_mask": 0}
    print(f"{tag}: {L} layers, float32, prefill of {tuple(toks.shape)}: kernel path "
          f"against plain path: {share:.6f} of {sum(a.numel() for a, _ in kernel_routes)} "
          f"expert indices equal (need >= {MOE_ROUTE_SHARE}), logits max abs err "
          f"{err:.3g}, {rel:.3g} of their largest magnitude (need <= {MOE_LOGITS_RTOL}); "
          f"launches {counts} then {plain_counts} (need {need}, then unchanged)")
    if share < MOE_ROUTE_SHARE or not rel <= MOE_LOGITS_RTOL:
        fail(f"the {tag} model's kernel path disagrees with its plain path")
    if counts != need or plain_counts != counts:
        fail(f"{tag} kernel-path launches {counts}, {plain_counts} != {need}")
    out = {"layers": L, "dtype": "float32", "equal_expert_share": share,
           "logits_max_abs_err": err, "logits_rel_err": rel}
    no_drop = cfg.n_experts / cfg.top_k
    for cf, gated in ((cfg.capacity_factor, False), (no_drop, True)):
        finite, top1, rel = _decode_vs_prefill(cfg.with_(capacity_factor=cf), params, seq)
        print(f"{tag}: {L} layers, float32, capacity factor {cf:.4g}: decode vs prefill at "
              f"S={seq.shape[1] - 1}: top-1 agreement {top1:.3f}, relative max error "
              f"{rel:.3g}, finite {finite} (need >= {MOE_TOP1}, < {MOE_REL}, True"
              + (")" if gated else "; printed, not gated)"))
        if gated and not (finite and top1 >= MOE_TOP1 and rel < MOE_REL):
            fail(f"{tag} decode disagrees with prefill where no slot can drop")
        out[f"decode_vs_prefill_cf_{cf:.4g}"] = {"top1": top1, "rel_err": rel,
                                                 "gated": gated}
    del params, model, got, want
    torch.cuda.empty_cache()
    return out


def moe_kernel_phase() -> list:
    """Flash attention and RMSNorm at the moe model's serve and train shapes,
    fused_adam over its 2-layer parameters: checked, timed, bounds.  Run
    early, beside the kernel phase: late in a run, torch.profiler sessions
    of a few short kernels came back with no device record at all."""
    cfg = get_config(MOE_ARCH).with_(n_layers=MOE_TRAIN_LAYERS)
    batch, seq = len(PROMPT_LENS), max(PROMPT_LENS)
    gen = torch.Generator(device=DEV).manual_seed(2)
    n2 = count_params(cfg)
    rows = [{"name": "flash_attention", "path": "serve prefill",
             **_flash_entry(gen, cfg, batch, seq)},
            {"name": "flash_attention", "path": "train",
             **_flash_entry(gen, cfg, MOE_TRAIN_BATCH, TRAIN_SEQ)},
            {"name": "rmsnorm", "path": "serve prefill", **_rms_entry(gen, cfg, batch * seq)},
            {"name": "rmsnorm", "path": "train",
             **_rms_entry(gen, cfg, MOE_TRAIN_BATCH * TRAIN_SEQ)},
            {"name": "fused_adam", "path": "train", **_adam_entry(gen, n2)}]
    for r in rows:
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        print(f"kernels: moe {r['name']} at {r['shape']} ({r['path']}): {r['ms']:.5f} ms "
              f"device, bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
              f"{r['share_of_bound']:.1%}), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.5f} ms, max abs err {r['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    return rows


def _moe_train(cfg) -> tuple:
    """``Trainer.fit(AdamW(fused=True))`` on ``SyntheticLM`` batches of one
    sequence of TRAIN_SEQ, through ``Prefetcher`` and then again on the same
    batches made before the loop: one warm-up and 3 timed steps each,
    launches exact per step; one step's loss split into cross-entropy and
    aux, every gradient finite, the router's and each expert's nonzero;
    ``moe_ffn`` forward and backward at the train shape with syncs made
    errors.  (JSON, launches)."""
    L, S, B = cfg.n_layers, TRAIN_SEQ, MOE_TRAIN_BATCH
    n2, active = count_params(cfg), active_params(cfg)
    n4 = count_params(cfg.with_(n_layers=4))
    print(f"moe: train {cfg.name} at {L} layers, full width: {n2:,} parameters, "
          f"{active:,} active per token; the fused step holds 2 B params + 2 B grads "
          f"+ 8 B m, v + 8 B flat p, g = 20 B x {n2:,} = {20 * n2 / 1e9:.1f} GB "
          f"before activations (4 layers: {20 * n4 / 1e9:.1f} GB), so depth "
          f"{L} is the cut")
    per_step = {"flash_attention": L, "rmsnorm": 2 * L + 1, "fused_adam": 1,
                "dgc_mask": 0}
    per_variant = {"wgmma": L, "scalar": 0}
    step_counts, step_variants = [], []
    H, D = cfg.n_heads, cfg.head_dim or cfg.d_model // cfg.n_heads
    attn_flops = 3 * 4 * D * (B * H * S * (S + 1) // 2) * L
    flops = 6 * active * B * S + attn_flops

    def hook(i, metrics):
        step_counts.append(ops.launch_counts())
        step_variants.append(dict(flash_kernel.launches_by_variant))
        ops.reset_launch_counts()

    def fit(batches, how: str) -> tuple:
        trainer = Trainer(cfg, TrainerConfig(steps=TRAIN_STEPS, log_every=0, seed=0),
                          optimizer=AdamW(fused=True), device=DEV)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = trainer.fit(batches, hooks=hook)
        log = trainer.metrics_log
        step_s = float(np.mean([m["step_time_s"] for m in log[1:]]))
        out = {"losses": [m["loss"] for m in log], "step_ms": step_s * 1e3,
               "tokens_per_s": B * S / step_s, "mfu": flops / step_s / PEAK_BF16_FLOPS,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"moe: train {how}: steps " + ", ".join(
            f"{m['step']}: loss {m['loss']:.4f} {m['step_time_s'] * 1e3:.1f} ms" for m in log)
              + f" (step 0 the warm-up); step {out['step_ms']:.1f} ms (mean of steps 1-"
              f"{len(log) - 1}, host clock ending in a sync), {out['tokens_per_s']:.1f} "
              f"tokens/s, mfu {out['mfu']:.4f} ((6 x active params x tokens + causal "
              f"attention {attn_flops:.3g}) / step / 989e12); peak device memory "
              f"{out['peak_gb']:.2f} GB")
        if not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in log):
            fail("non-finite loss or grad norm in moe training")
        return state, out

    # Prefetcher's thread makes the next batches while the step is issued,
    # both on one GIL; the second run, on batches made before the loop, shows
    # what that thread costs the step (ROADMAP C20)
    data = SyntheticLM(cfg.vocab, S, B, seed=0)
    ops.reset_launch_counts()
    state, prefetched = fit(Prefetcher(iter(data)), "through Prefetcher")
    del state
    state, made = fit(iter([data.batch_at(i) for i in range(TRAIN_STEPS)]),
                      "on batches made before the loop")
    print(f"moe: train launches per step {step_counts}, flash by kernel "
          f"{step_variants} (need {per_step}, {per_variant} each)")
    if (len(step_counts) != 2 * TRAIN_STEPS or any(c != per_step for c in step_counts)
            or any(v != per_variant for v in step_variants)):
        fail(f"moe train launch counts {step_counts} {step_variants}")
    run_counts = {k: sum(c[k] for c in step_counts) for k in per_step}

    params = state["params"]
    del state
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in data.batch_at(TRAIN_STEPS).items()}
    routes = []
    with _recording_routes(routes):
        loss, grads = loss_and_grads(cfg, params, batch)
    with torch.no_grad():
        ce = loss_fn(cfg.with_(aux_loss_coef=0.0), params, batch)
    aux = [float(a.detach()) for _, a in routes]
    term = float(loss) - float(ce)
    want_term = cfg.aux_loss_coef * sum(aux) / L
    named = _named(grads)
    dead = [k for k, g in named.items() if not (torch.isfinite(g).all() and (g != 0).any())]
    idle = [f"{k}[{e}]" for k, g in named.items() if k.split(".")[-1] in
            ("w_gate", "w_up", "w_down") for e in range(g.shape[0])
            if not (g[e] != 0).any()]
    routers = {k: str(g.dtype)[6:] for k, g in named.items() if k.endswith("router")}
    print(f"moe: train loss {float(loss):.4f} = cross-entropy {float(ce):.4f} + "
          f"{term:.6f}, the aux term {cfg.aux_loss_coef} x {sum(aux):.4f} / {L} = "
          f"{want_term:.6f} (aux per block {', '.join(f'{a:.4f}' for a in aux)}; 1.0 is "
          f"a balanced router); {len(named)} gradient leaves, {len(dead)} not finite "
          f"or all zero, {len(idle)} experts with an all-zero gradient (need 0, 0), "
          f"router gradients {routers}")
    if not (all(np.isfinite(aux)) and len(aux) == L and abs(term - want_term) <= 1e-4):
        fail(f"moe loss {float(loss)} does not carry its aux term {want_term}")
    if dead or idle:
        fail(f"moe gradients missing: {dead} {idle}")
    del grads, named, loss

    # moe_ffn forward and backward at the train shape: a device -> host
    # sync anywhere in them raises (the layer has no data-dependent shape)
    lp = params["blocks"][0]["moe"]
    x = randn(torch.Generator(device=DEV).manual_seed(3), B, S, cfg.d_model,
              dtype=torch.bfloat16).requires_grad_()
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, a = moe_layer.moe_ffn(lp, x, top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor)
        (out.float().square().mean() + a).backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    print(f"moe: moe_ffn forward and backward at {tuple(x.shape)} under "
          f"torch.cuda.set_sync_debug_mode('error'): no sync")
    del params, x, out, a, lp
    torch.cuda.empty_cache()
    return ({"layers": L, "params": n2, "active_params": active, "batch": B,
             "seq": S, **prefetched, "batches_made_before": made, "flops_per_step": flops,
             "launches_per_step": per_step,
             "loss": {"total": term + float(ce), "cross_entropy": float(ce),
                      "aux_per_block": aux}}, run_counts)


def deepseek_kernel_phase() -> list:
    """Flash attention at deepseek-v2-236b's MLA shapes (q/k head dim 192, v
    head dim 128, 128 heads with their own K): the serve prefill's and the
    train step's, checked, timed beside SDPA and bounded; RMSNorm at the
    serve prefill's q_norm (q_lora columns) and kv_norm (kv_lora columns of
    rows kv_lora + qk_rope wide, read in place), timed beside
    ``F.rms_norm``.  Run early, right after the kernel phase (before
    ``moe_kernel_phase``)."""
    cfg = get_config(DEEPSEEK_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(3)
    tokens = len(PROMPT_LENS) * max(PROMPT_LENS)
    rows = [{"name": "flash_attention", "path": "serve prefill",
             **_flash_entry(gen, cfg, len(PROMPT_LENS), max(PROMPT_LENS))},
            {"name": "flash_attention", "path": "train",
             **_flash_entry(gen, cfg, MOE_TRAIN_BATCH, TRAIN_SEQ)},
            {"name": "rmsnorm", "path": "serve prefill (q_norm)",
             **_rms_entry(gen, cfg, tokens, cfg.q_lora)},
            {"name": "rmsnorm", "path": "serve prefill (kv_norm)",
             **_rms_entry(gen, cfg, tokens, cfg.kv_lora, cfg.kv_lora + cfg.qk_rope)}]
    for r in rows:
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        scalar = (f"CUDA-core kernel {r['scalar_ms']:.4f} ms, " if "scalar_ms" in r else "")
        print(f"kernels: deepseek {r['name']} at {r['shape']} ({r['path']}): "
              f"{r['ms']:.5f} ms device, bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
              f"{r['share_of_bound']:.1%}), {scalar}plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.5f} ms, max abs err "
              f"{r['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    return rows


def deepseek_phase(name: str, kernels: list, rows: list) -> dict:
    """The mla_moe family on the card (deepseek-v2-236b, random weights from
    seed 0): served at full width and DEEPSEEK_SERVE_LAYERS of its 60 layers
    in bf16, the DEEPSEEK_TRAIN_LAYERS-layer model through the kernels
    against their plain versions in float32, forward and backward at full
    width and DEEPSEEK_TRAIN_LAYERS layers (1 x TRAIN_SEQ), Daydream's
    baseline on that step, and ``perf_report.trace_cell`` of the served
    depth's train_4k step on meta tensors.  Every earlier phase's tensor
    is freed first (gated), and the free device memory gated against the
    served weights.  ``rows`` are the flash rows timed at its shapes
    (``deepseek_kernel_phase``), given their launches here.  Returns the
    ``deepseek`` JSON object."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    full = get_config(DEEPSEEK_ARCH)
    cfg = full.with_(n_layers=DEEPSEEK_SERVE_LAYERS)
    n_full, n = count_params(full), count_params(cfg)
    per_layer = (n_full - n) // (full.n_layers - cfg.n_layers)
    kv = 2 * cfg.n_layers * (cfg.kv_lora + cfg.qk_rope)
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    need_gb = 2 * n / 1e9 + DEEPSEEK_MARGIN_GB
    print(f"deepseek: {full.name}: {n_full:,} parameters at 60 layers ({2 * n_full / 1e9:.1f} "
          f"GB of bf16), {per_layer:,} per layer ({2 * per_layer / 1e9:.3f} GB), so "
          f"{cfg.n_layers} layers are served: {n:,} parameters, {2 * n / 1e9:.2f} GB with "
          f"the embedding and unembedding; depth is the only cut.  MLA cache {kv:,} B per "
          f"token (c_kv {cfg.kv_lora} + k_rope {cfg.qk_rope} per layer); device memory "
          f"still allocated before the phase {held:.3f} GB (need <= {MOE_HELD_GB}), free "
          f"{free_gb:.2f} GB (need >= {need_gb:.2f})")
    if held > MOE_HELD_GB:
        fail(f"{held:.3f} GB of earlier phases' tensors still on the card")
    if free_gb < need_gb:
        fail(f"{free_gb:.2f} GB free on the card for {need_gb:.2f} GB")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab, n_)],
                    max_new_tokens=NEW_TOKENS) for n_ in PROMPT_LENS]
    seq = torch.tensor(rng.integers(1, cfg.vocab, (len(reqs), max(PROMPT_LENS) + 1)),
                       device=DEV)
    serve, serve_counts, params = _serve(cfg, reqs, "deepseek")
    del params
    torch.cuda.empty_cache()
    paths = _moe_paths(full.with_(n_layers=DEEPSEEK_TRAIN_LAYERS, dtype="float32"),
                       _prompt_tokens(reqs), seq, "deepseek")
    tcfg = full.with_(n_layers=DEEPSEEK_TRAIN_LAYERS)
    train, train_counts, daydream = _deepseek_train(tcfg, name)
    daydream["compiled"] = _compiled_cell(cfg, "deepseek")
    for kern in kernels:        # the main path: the served and the trained run
        kern["launches_by_path"]["deepseek"] = (serve_counts[kern["name"]]
                                                + train_counts[kern["name"]])
    for row in rows:
        row["launches"] = serve_counts[row["name"]] + train_counts[row["name"]]
    phase_s = time.perf_counter() - t0
    print(f"deepseek: phase {phase_s:.1f}s")
    return {"device": name, "config": f"{full.name} at {cfg.n_layers} of "
            f"{full.n_layers} layers (served) and {tcfg.n_layers} (trained), random "
            f"weights from seed 0", "serve": serve, "paths": paths, "kernels": rows,
            "train": train, "daydream": daydream, "phase_s": phase_s}


def _deepseek_train(cfg, name: str) -> tuple:
    """``loss_and_grads`` at full width and ``cfg.n_layers`` layers on
    ``SyntheticLM`` batches of one sequence of TRAIN_SEQ (no optimizer: its
    state does not fit the card): one warm-up and TRAIN_STEPS - 1 timed
    steps, launches exact per step; the last step's loss split into
    cross-entropy and the aux term, every gradient finite, the router's
    and every expert's nonzero.  Then Daydream's baseline: the step traced
    (``trace_measured``), simulated and held within FIDELITY_TOL of the step
    measured (``measure_wallclock``, before and after the trace).
    (JSON, launches, the Daydream JSON)."""
    L, S, B = cfg.n_layers, TRAIN_SEQ, MOE_TRAIN_BATCH
    n, active = count_params(cfg), active_params(cfg)
    print(f"deepseek: train {cfg.name} at {L} layers, full width: {n:,} parameters, "
          f"{active:,} active per token; bf16 params + grads 4 B x {n:,} = "
          f"{4 * n / 1e9:.1f} GB before activations (the fused AdamW step would hold "
          f"20 B a parameter, {20 * n / 1e9:.0f} GB), so forward and backward only")
    per_step = {"flash_attention": L, "rmsnorm": _norms(cfg), "fused_adam": 0,
                "dgc_mask": 0}
    per_variant = {"wgmma": L, "scalar": 0}
    H = cfg.n_heads
    D, Dv = perf_report.flash_head_dims(cfg)
    attn_flops = 3 * 2 * (D + Dv) * (B * H * S * (S + 1) // 2) * L
    flops = 6 * active * B * S + attn_flops
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=DEV)
    data = SyntheticLM(cfg.vocab, S, B, seed=0)
    batches = [{k: torch.from_numpy(v).to(DEV) for k, v in data.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    counts, variants, times, losses = [], [], [], []
    for i, batch in enumerate(batches):
        routes = []
        ops.reset_launch_counts()
        sync()
        t1 = time.perf_counter()
        with _recording_routes(routes):
            loss, grads = loss_and_grads(cfg, params, batch)
        sync()
        times.append(time.perf_counter() - t1)
        counts.append(ops.launch_counts())
        variants.append(dict(flash_kernel.launches_by_variant))
        losses.append(float(loss))
        if i < len(batches) - 1:
            del grads
    step_s = float(np.mean(times[1:]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    train = {"layers": L, "params": n, "active_params": active, "batch": B, "seq": S,
             "losses": losses, "step_ms": step_s * 1e3, "step_ms_each": [t * 1e3 for t in times],
             "tokens_per_s": B * S / step_s, "flops_per_step": flops,
             "mfu": flops / step_s / PEAK_BF16_FLOPS, "peak_gb": peak,
             "launches_per_step": per_step}
    print(f"deepseek: train forward+backward, steps " + ", ".join(
        f"{i}: loss {l:.4f} {t * 1e3:.1f} ms" for i, (l, t) in enumerate(zip(losses, times)))
        + f" (step 0 the warm-up); step {train['step_ms']:.1f} ms (host clock ending in a "
        f"sync), {train['tokens_per_s']:.1f} tokens/s, mfu {train['mfu']:.4f} ((6 x active "
        f"params x tokens + causal attention {attn_flops:.3g}) / step / 989e12); peak "
        f"device memory {peak:.2f} GB; launches per step {counts}, flash by kernel "
        f"{variants} (need {per_step}, {per_variant} each)")
    if any(c != per_step for c in counts) or any(v != per_variant for v in variants):
        fail(f"deepseek train launch counts {counts} {variants}")
    if not np.isfinite(losses).all():
        fail(f"non-finite deepseek loss {losses}")
    run_counts = {k: sum(c[k] for c in counts) for k in per_step}

    # the last step: CE + aux, and every gradient
    with torch.no_grad():
        ce = loss_fn(cfg.with_(aux_loss_coef=0.0), params, batches[-1])
    aux = [float(a.detach()) for _, a in routes]
    term = losses[-1] - float(ce)
    want_term = cfg.aux_loss_coef * sum(aux) / L
    named = _named(grads)
    dead = [k for k, g in named.items() if not torch.isfinite(g).all()
            or (not k.endswith("norm") and not (g != 0).any())]
    idle = [f"{k}[{e}]" for k, g in named.items() if k.split(".")[-1] in
            ("w_gate", "w_up", "w_down") for e in range(g.shape[0])
            if not (g[e] != 0).any()]
    attn = {k.split("attn.")[1]: float(g.float().norm()) for k, g in named.items()
            if ".attn." in k and k.startswith("blocks.0.")}
    print(f"deepseek: train loss {losses[-1]:.4f} = cross-entropy {float(ce):.4f} + "
          f"{term:.6f}, the aux term {cfg.aux_loss_coef} x {sum(aux):.4f} / {L} = "
          f"{want_term:.6f} (aux per block {', '.join(f'{a:.4f}' for a in aux)}); "
          f"{len(named)} gradient leaves, {len(dead)} not finite or all zero, {len(idle)} "
          f"experts with an all-zero gradient (need 0, 0); layer 0's attention gradient "
          f"norms " + ", ".join(f"{k} {v:.4g}" for k, v in attn.items()))
    if not (all(np.isfinite(aux)) and len(aux) == L and abs(term - want_term) <= 1e-3):
        fail(f"deepseek loss {losses[-1]} does not carry its aux term {want_term}")
    if dead or idle or not all(math.isfinite(v) and v > 0 for v in attn.values()):
        fail(f"deepseek gradients missing: {dead} {idle} {attn}")
    train["loss"] = {"total": losses[-1], "cross_entropy": float(ce), "aux_per_block": aux}
    del grads, named, loss

    # Daydream: the forward+backward step traced, simulated, measured
    batch = batches[0]

    def step():
        loss_and_grads(cfg, params, batch)

    ops.reset_launch_counts()
    before = measure_wallclock(step, device=DEV, iters=WHATIF_ITERS, warmup=1) * 1e3
    t1 = time.perf_counter()
    bundle = trace_measured(step, device=DEV)
    trace_s = time.perf_counter() - t1
    after = measure_wallclock(step, device=DEV, iters=WHATIF_ITERS, warmup=1) * 1e3
    sync()
    steps = 2 * (WHATIF_ITERS + 1) + int(bundle.aggregates["calls"])
    got = ops.launch_counts()
    want = {k: v * steps for k, v in per_step.items()}
    g = bundle.graph
    g.toposort()
    dev = g.lane_tasks(DEVICE_STREAM)
    dev_s = sum(t.duration for t in dev)
    by = {}
    for t in dev:
        by[str(t.layer)] = by.get(str(t.layer), 0.0) + t.duration * 1e3
    mapped = 1 - by.get("None", 0.0) / (dev_s * 1e3)
    phases = {t.phase for t in dev}
    unlaunched = sum(not any(p.thread == HOST_THREAD for p in g.parents(t)) for t in dev)
    sim_ms = bundle.simulate().makespan * 1e3
    meas_ms = (before + after) / 2
    fidelity = sim_ms / meas_ms - 1
    print(f"deepseek: forward+backward step traced in {trace_s:.1f}s: {len(dev)} device "
          f"tasks, device {dev_s * 1e3:.3f} ms by layer "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
          + f"; {mapped:.2%} of device time has a layer (need >= 90%), phases "
          f"{sorted(map(str, phases))}, {unlaunched} kernels without a launch (need 0); "
          f"simulated {sim_ms:.3f} ms against measured (CUDA events, median of "
          f"{WHATIF_ITERS}) {before:.3f} / {after:.3f} ms: error {fidelity:+.2%} (need "
          f"within {FIDELITY_TOL:.0%}); launches {got} (need {want})")
    if not ({"fwd", "bwd"} <= phases and mapped >= 0.9 and unlaunched == 0):
        fail("the traced deepseek step graph lacks a phase, a layer map or a launch edge")
    if abs(fidelity) > FIDELITY_TOL:
        fail(f"simulated deepseek step {sim_ms:.3f} ms is {fidelity:+.2%} off the "
             f"measured {meas_ms:.3f} ms")
    if got != want:
        fail(f"deepseek Daydream launch counts {got} != {want}")
    daydream = {"device": name, "trace_s": trace_s, "device_tasks": len(dev),
                "device_ms": dev_s * 1e3, "device_ms_by_layer": by,
                "layer_mapped_share": mapped,
                "baseline": {"simulated_ms": sim_ms, "measured_ms": meas_ms,
                             "measured_runs_ms": [before, after], "error": fidelity}}
    train["measure_wallclock"] = {"step_ms": meas_ms,
                                  "mfu": flops / meas_ms / 1e-3 / PEAK_BF16_FLOPS}
    del bundle, g, dev, params, batches, batch
    torch.cuda.empty_cache()
    return train, run_counts, daydream


def ssm_kernel_phase() -> list:
    """RMSNorm at mamba2-2.7b's train shapes, bf16: ln's (TRAIN_SEQ, d_model)
    and the gated norm's (TRAIN_SEQ, d_inner), checked, timed beside
    ``F.rms_norm`` and bounded.  Run early, beside the kernel phase, as
    ``moe_kernel_phase``."""
    cfg = get_config(SSM_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(4)
    rows = [{"name": "rmsnorm", "path": "train (ln)", **_rms_entry(gen, cfg, TRAIN_SEQ)},
            {"name": "rmsnorm", "path": "train (gated norm)",
             **_rms_entry(gen, cfg, TRAIN_SEQ, cfg.ssm_expand * cfg.d_model)}]
    for r in rows:
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        print(f"kernels: ssm {r['name']} at {r['shape']} ({r['path']}): {r['ms']:.5f} ms "
              f"device (CUDA events on the same calls {r['event_ms']:.5f}), bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}, {r['share_of_bound']:.1%}), plain "
              f"{r['plain_ms']:.4f} ms, F.rms_norm {r['library_ms']:.5f} ms, max abs err "
              f"{r['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    return rows


def ssm_phase(name: str, kernels: list, rows: list) -> dict:
    """The ssm family on the card (mamba2-2.7b, random weights from seed 0):
    served at full width and depth in bf16, its decode cache's bytes at two
    contexts, the SSM_PATH_LAYERS-layer model through the kernel against its
    plain version in float32, trained at SSM_TRAIN_LAYERS layers, Daydream's
    FusedAdam case on the step at SSM_WHATIF_LAYERS layers (its host lane
    calibrated, ``fused_whatif``), and ``perf_report.trace_cell`` of all 64
    layers and of the trained depth on meta tensors.  Every earlier phase's
    tensor is freed first (gated).  ``rows`` are the RMSNorm rows timed at its
    shapes (``ssm_kernel_phase``), given their launches here.  Returns the
    ``ssm`` JSON object."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(SSM_ARCH)
    n = count_params(cfg)
    print(f"ssm: {cfg.name}: {n:,} parameters ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_inner {cfg.ssm_expand * cfg.d_model}, "
          f"{cfg.ssm_expand * cfg.d_model // 64} SSD heads of 64, state {cfg.ssm_state}, "
          f"chunk {cfg.ssm_chunk}), {2 * n / 1e9:.2f} GB of bf16; no attention, a decode "
          f"cache of constant size; device memory still allocated before the phase "
          f"{held:.3f} GB (need <= {MOE_HELD_GB})")
    if held > MOE_HELD_GB:
        fail(f"{held:.3f} GB of earlier phases' tensors still on the card")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab, n_)],
                    max_new_tokens=NEW_TOKENS) for n_ in PROMPT_LENS]
    seq = torch.tensor(rng.integers(1, cfg.vocab, (len(reqs), max(PROMPT_LENS) + 1)),
                       device=DEV)
    parts = {}

    def part(label, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        parts[label] = time.perf_counter() - t1
        return out

    serve, serve_counts, params = part("serve", _serve, cfg, reqs, "ssm")
    serve["contexts"] = part("contexts", _ssm_contexts, cfg, params, rng)
    del params
    torch.cuda.empty_cache()
    paths = part("paths", _ssm_paths, cfg.with_(n_layers=SSM_PATH_LAYERS, dtype="float32"),
                 reqs, seq)
    tcfg = cfg.with_(n_layers=SSM_TRAIN_LAYERS)
    train, train_counts = part("train", _ssm_train, tcfg)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in SyntheticLM(
        cfg.vocab, TRAIN_SEQ, MOE_TRAIN_BATCH, seed=1).batch_at(0).items()}
    proj = part("projections", _ssm_projection_ab, tcfg, train["step_ms_one_batch"])
    wcfg = cfg.with_(n_layers=SSM_WHATIF_LAYERS)
    daydream = part("daydream", fused_whatif, wcfg, name, kernels, batch, "ssm_whatif",
                    None, True)
    daydream["by_layer_ms"] = _layer_table(daydream["by_layer_ms"], SSM_ROWS, "ssm", "ssm")
    host = daydream["graph"]
    print(f"ssm: the traced per-leaf step at {wcfg.n_layers} layers: host lane "
          f"{host['host_ms']:.3f} ms as captured, {host['host_share']:.1%} of its "
          f"{daydream['baseline']['simulated_ms']:.3f} ms simulated; device "
          f"{host['device_ms']:.3f} ms: "
          + ("host-bound" if host["host_ms"] > host["device_ms"] else "device-bound")
          + f" (host scale {daydream['calibrated']['host_scale']:.4f} to the unprofiled "
          f"pace, C5)")
    wall_ms = train["step_ms_one_batch"]
    L, Lw = cfg.n_layers, tcfg.n_layers
    daydream["compiled"] = {
        "full": part("compiled", _compiled_cell, cfg, "ssm", {
            "flash_attention": 0, "rmsnorm": 2 * L + 1, "fused_adam": 1, "dgc_mask": 0},
            "ssm"),
        "trained": part("compiled trained", _compiled_cell, tcfg, "ssm", {
            "flash_attention": 0, "rmsnorm": 2 * Lw + 1, "fused_adam": 1, "dgc_mask": 0},
            "ssm", wall_ms)}
    train["measure_wallclock"] = {
        "step_ms": wall_ms, "mfu": train["flops_per_step"] / wall_ms / 1e-3 / PEAK_BF16_FLOPS}
    train["projections"] = proj
    for kern in kernels:        # the main path: the served and the trained run
        kern["launches_by_path"]["ssm"] = (serve_counts[kern["name"]]
                                           + train_counts[kern["name"]])
    for row in rows:
        row["launches"] = serve_counts[row["name"]] + train_counts[row["name"]]
    phase_s = time.perf_counter() - t0
    print(f"ssm: phase {phase_s:.1f}s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return {"device": name, "config": f"{cfg.name} served at {cfg.n_layers} layers, "
            f"trained at {tcfg.n_layers}, Daydream at {wcfg.n_layers}, random weights "
            f"from seed 0", "serve": serve,
            "paths": paths, "kernels": rows, "train": train, "daydream": daydream,
            "phase_s": phase_s, "parts_s": parts}


def _cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for entry in cache
               for t in _named(entry).values())


def _cache_split(cfg, cache) -> tuple:
    """(bytes of the leaves with a sequence axis, bytes of the leaves of
    constant size) of a decode cache, by ``cache_axes``."""
    split = [0, 0]
    for entry, axes in zip(cache, cache_axes(cfg)):
        ax = _named(axes)
        for k, t in _named(entry).items():
            split[ax[k] is None] += t.numel() * t.element_size()
    return tuple(split)


def _ssm_contexts(cfg, params, rng) -> dict:
    """One request at each of SSM_CONTEXTS through ``ServeEngine.generate``
    (SSM_CONTEXT_NEW new tokens): the bytes of the cache the engine grows
    (gated equal at every context), the host ms per decode step, the device
    ms of one decode step on that cache (torch.profiler: a decode step's
    ~2000 launches overfill the launch queue that ``event_ms`` hides
    behind a sleep), and ``serving_cost``'s
    ``decode_step_time`` for one slot at that context (which prices a KV
    cache of 655,360 B per token the model does not keep: ROADMAP C22)."""
    model = build_model(cfg)
    cost = serving_cost(cfg.name)
    out = {}
    for ctx in SSM_CONTEXTS:
        engine = ServeEngine(cfg, params, max_seq=ctx + SSM_CONTEXT_NEW, device=DEV)
        grown = []
        plain = engine._grow_cache

        def spy(prefix, plen, plain=plain, grown=grown):
            grown.append(plain(prefix, plen))
            return grown[-1]

        engine._grow_cache = spy
        prompt = [int(t) for t in rng.integers(1, cfg.vocab, ctx)]
        res = engine.generate([Request(prompt, SSM_CONTEXT_NEW)])
        st = engine.stats
        cache = grown[-1]
        nxt = torch.tensor([[res[0].tokens[0]]], device=DEV)
        with torch.inference_mode():
            dec_ms = device_profile(lambda: model.decode(params, cache, nxt, ctx), 2, 2).ms
        priced = cost.decode_step_time(1, ctx) * 1e3
        out[ctx] = {"cache_bytes": _cache_bytes(cache),
                    "host_decode_ms": st["decode_s"] / st["decode_steps"] * 1e3,
                    "host_prefill_ms": st["prefill_s"] * 1e3,
                    "device_decode_ms": dec_ms, "serving_cost_decode_ms": priced,
                    "serving_cost_kv_bytes": ctx * cost.kv_bytes_per_token}
        print(f"ssm: context {ctx}: one request, prefill {st['prefill_s'] * 1e3:.2f} ms host, "
              f"decode {out[ctx]['host_decode_ms']:.3f} ms/token host, {dec_ms:.4f} ms device "
              f"per step; the engine's cache {out[ctx]['cache_bytes']:,} B; serving_cost "
              f"prices the step {priced:.4f} ms, reading {cost.weight_bytes / 1e9:.3f} GB of "
              f"weights + {out[ctx]['serving_cost_kv_bytes'] / 1e9:.3f} GB of KV at "
              f"{cost.kv_bytes_per_token:,.0f} B per token (printed, not gated)")
        del engine, grown, cache
    sizes = {ctx: o["cache_bytes"] for ctx, o in out.items()}
    print(f"ssm: cache bytes by context {sizes} (need all equal)")
    if len(set(sizes.values())) != 1:
        fail(f"the ssm decode cache grows with the context: {sizes}")
    return {str(k): v for k, v in out.items()}


def _ssm_paths(cfg, reqs, seq) -> dict:
    """The float32 model at SSM_PATH_LAYERS layers: its prefill and one
    decode step through the RMSNorm kernel against the same through its
    plain version (logits within MOE_LOGITS_RTOL of their largest
    magnitude), the engine's greedy tokens on both paths (equal), and decode
    step S against a fresh prefill of S + 1 tokens (within SSM_DECODE_RTOL:
    the same recurrence, tests/test_torch_ssm.py's tolerance)."""
    params = init_params(cfg, seed=0, device=DEV)
    model = build_model(cfg)
    toks = _prompt_tokens(reqs)
    plen = toks.shape[1]
    nxt = toks[:, -1:]
    with torch.inference_mode():
        ops.reset_launch_counts()
        got, cache = model.prefill(params, {"tokens": toks})
        got_dec, _ = model.decode(params, cache, nxt, plen)
        sync()
        counts = ops.launch_counts()
        with _plain_kernels():
            want, cache = model.prefill(params, {"tokens": toks})
            want_dec, _ = model.decode(params, cache, nxt, plen)
        sync()
    plain_counts = ops.launch_counts()
    rel = max_err(got, want) / want.abs().max().item()
    rel_dec = max_err(got_dec, want_dec) / want_dec.abs().max().item()
    engine = ServeEngine(cfg, params, max_seq=plen + NEW_TOKENS, device=DEV)
    kernel_toks = [r.tokens for r in engine.generate(reqs)]
    with _plain_kernels():
        plain_toks = [r.tokens for r in engine.generate(reqs)]
    same = sum(a == b for ka, pa in zip(kernel_toks, plain_toks) for a, b in zip(ka, pa))
    finite, top1, rel_s = _decode_vs_prefill(cfg, params, seq)
    L = cfg.n_layers
    need = {"flash_attention": 0, "rmsnorm": 2 * _norms(cfg), "fused_adam": 0,
            "dgc_mask": 0}
    print(f"ssm: {L} layers, float32, prefill of {tuple(toks.shape)} and one decode "
          f"step: kernel path against plain path, logits {rel:.3g} and {rel_dec:.3g} of "
          f"their largest magnitude (need <= {MOE_LOGITS_RTOL}); greedy tokens through the "
          f"engine {same} of {sum(map(len, kernel_toks))} equal (need all); launches "
          f"{counts} then {plain_counts} (need {need}, then unchanged); decode vs a fresh "
          f"prefill at S={seq.shape[1] - 1}: relative max error {rel_s:.3g}, top-1 "
          f"agreement {top1:.3f}, finite {finite} (need <= {SSM_DECODE_RTOL}, True)")
    if not (rel <= MOE_LOGITS_RTOL and rel_dec <= MOE_LOGITS_RTOL
            and kernel_toks == plain_toks):
        fail("the ssm model's kernel path disagrees with its plain path")
    if counts != need or plain_counts != counts:
        fail(f"ssm kernel-path launches {counts}, {plain_counts} != {need}")
    if not (finite and rel_s <= SSM_DECODE_RTOL):
        fail(f"ssm decode disagrees with a fresh prefill: {rel_s:.3g}")
    del params, model, engine, got, want, got_dec, want_dec, cache
    torch.cuda.empty_cache()
    return {"layers": L, "dtype": "float32", "prefill_logits_rel_err": rel,
            "decode_logits_rel_err": rel_dec, "greedy_tokens_equal": same,
            "decode_vs_prefill": {"rel_err": rel_s, "top1": top1}}


def _ssm_train(cfg) -> tuple:
    """``Trainer.fit(AdamW(fused=True))`` at full width and ``cfg.n_layers``
    layers on ``SyntheticLM`` batches of one sequence of TRAIN_SEQ (made
    before the loop): one warm-up and TRAIN_STEPS - 1 timed steps, launches
    exact per step, the peak under SSM_PEAK_GB; then 5 more steps on one
    batch (the loss finite and falling, as ``loss_falls_phase``), and every
    gradient of the trained params finite and nonzero (the reference's SSD
    form gives NaN at the config's chunk).  (JSON, launches)."""
    L, S, B = cfg.n_layers, TRAIN_SEQ, MOE_TRAIN_BATCH
    n = count_params(cfg)
    flops = 6 * n * B * S
    print(f"ssm: train {cfg.name} at {L} of 64 layers, full width: {n:,} parameters; "
          f"the fused step holds 20 B x {n:,} = {20 * n / 1e9:.1f} GB before "
          f"activations (64 layers: {20 * count_params(get_config(SSM_ARCH)) / 1e9:.1f} "
          f"GB); depth {L} is the cut (peak under {SSM_PEAK_GB} GB)")
    per_step = {"flash_attention": 0, "rmsnorm": _norms(cfg), "fused_adam": 1,
                "dgc_mask": 0}
    step_counts = []

    def hook(i, metrics):
        step_counts.append(ops.launch_counts())
        ops.reset_launch_counts()

    trainer = Trainer(cfg, TrainerConfig(steps=TRAIN_STEPS, log_every=0, seed=0),
                      optimizer=AdamW(fused=True), device=DEV)
    data = SyntheticLM(cfg.vocab, S, B, seed=0)
    batches = [data.batch_at(i) for i in range(TRAIN_STEPS)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state = trainer.fit(iter(batches), hooks=hook)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log = trainer.metrics_log
    step_s = float(np.mean([m["step_time_s"] for m in log[1:]]))
    out = {"layers": L, "params": n, "batch": B, "seq": S,
           "losses": [m["loss"] for m in log], "step_ms": step_s * 1e3,
           "tokens_per_s": B * S / step_s, "flops_per_step": flops,
           "mfu": flops / step_s / PEAK_BF16_FLOPS, "peak_gb": peak,
           "launches_per_step": per_step}
    print(f"ssm: train steps " + ", ".join(
        f"{m['step']}: loss {m['loss']:.4f} {m['step_time_s'] * 1e3:.1f} ms" for m in log)
        + f" (step 0 the warm-up); step {out['step_ms']:.1f} ms (host clock ending in a "
        f"sync), {out['tokens_per_s']:.1f} tokens/s, mfu {out['mfu']:.4f} (6 x params x "
        f"tokens / step / 989e12); peak device memory {peak:.2f} GB (need < "
        f"{SSM_PEAK_GB}); launches per step {step_counts} (need {per_step} each)")
    if len(step_counts) != TRAIN_STEPS or any(c != per_step for c in step_counts):
        fail(f"ssm train launch counts {step_counts}")
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in log):
        fail("non-finite loss or grad norm in ssm training")
    if peak >= SSM_PEAK_GB:
        fail(f"the ssm fused step at {L} layers peaked at {peak:.2f} GB")

    batch = {k: torch.from_numpy(v).to(DEV) for k, v in data.batch_at(TRAIN_STEPS).items()}
    holder, losses = {"state": state}, []
    del state                  # one state alive at a time: each is 30.9 GB

    def one_batch_step():
        holder["state"], m = trainer.step_fn(holder["state"], batch)
        losses.append(m["loss"])

    # each step timed by CUDA events (the fused step's time without the
    # profiler: mfu and the compiled route's ratio read it)
    step_ms = measure_wallclock(one_batch_step, device=DEV, iters=5, warmup=0) * 1e3
    state = holder.pop("state")
    losses = [float(x) for x in losses]
    counts = {k: v * (TRAIN_STEPS + 5) for k, v in per_step.items()}
    if ops.launch_counts() != {k: v * 5 for k, v in per_step.items()}:
        fail(f"ssm launches over 5 steps on one batch {ops.launch_counts()}")
    print(f"ssm: train 5 steps on one batch: losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f" (need finite, the last below the first); step {step_ms:.3f} ms (CUDA "
          f"events, median of 5), mfu {flops / step_ms / 1e-3 / PEAK_BF16_FLOPS:.4f}")
    out["step_ms_one_batch"] = step_ms
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"ssm loss did not fall over 5 steps on one batch: {losses}")
    out["losses_one_batch"] = losses

    params = state["params"]
    del state
    loss, grads = loss_and_grads(cfg, params, batch)
    named = _named(grads)
    dead = [k for k, g in named.items() if not (torch.isfinite(g).all() and (g != 0).any())]
    ssm_norms = {k.split(".", 2)[2]: float(g.float().norm()) for k, g in named.items()
                 if k.startswith("blocks.0.")}
    print(f"ssm: gradients after {TRAIN_STEPS + 5} steps (chunk {cfg.ssm_chunk}): "
          f"{len(named)} leaves, {len(dead)} not finite or all zero (need 0); layer 0's "
          f"norms " + ", ".join(f"{k} {v:.4g}" for k, v in ssm_norms.items()))
    if dead or not np.isfinite(float(loss)):
        fail(f"ssm gradients not finite or zero: {dead}")
    out["layer0_grad_norms"] = ssm_norms
    del params, grads, named, loss, trainer
    torch.cuda.empty_cache()
    return out, counts


def hybrid_kernel_phase() -> dict:
    """Flash attention with recurrentgemma-9b's local window at its training
    shape (1 x TRAIN_SEQ tokens, 16 query heads and one KV head of 256,
    window 2048) as bf16 (B, S, H, D) views, causal: it must launch the
    tensor-core kernel (its (256, 256) bucket); checked against
    ``flash_attention_ref(window=)`` (the CUDA-core kernel too, called
    directly), then timed beside the CUDA-core kernel, its plain version and
    SDPA with the same boolean mask (causal and windowed: the library call)
    and bounded by the pairs the window keeps.  Run early, beside the kernel
    phase, as ``ssm_kernel_phase``; the hybrid phase gives it its
    launches."""
    cfg = get_config(HYBRID_ARCH)
    B, S, H, KH, D, W = 1, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    bf = torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(5)
    _window_sweep(gen)
    q, k, v = (randn(gen, B, S, h, D, dtype=bf).transpose(1, 2) for h in (H, KH, KH))
    pos = torch.arange(S, device=DEV)
    mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
    out, variant = _counted_variant(lambda: ops.flash_attention(q, k, v, window=W))
    want = ref.flash_attention_ref(q, k, v, window=W)
    err = max_err(out, want)
    scalar_err = max_err(flash_kernel.flash_attention_scalar(q, k, v, window=W), want)
    lib_err = max_err(F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                     enable_gqa=True), want)
    unwindowed = max_err(out, ref.flash_attention_ref(q, k, v))
    print(f"kernels: hybrid flash at q {tuple(q.shape)} window {W}: max abs err "
          f"{err:.4g} against flash_attention_ref(window={W}) on {variant!r}, the "
          f"CUDA-core kernel's {scalar_err:.4g} (need <= {FLASH_ATOL[bf]}, 'wgmma'); SDPA "
          f"with the mask {lib_err:.4g}; the same output against attention with no window "
          f"{unwindowed:.4g} (need > {FLASH_ATOL[bf]}: the window masks)")
    if not (err <= FLASH_ATOL[bf] and scalar_err <= FLASH_ATOL[bf] and variant == "wgmma"
            and unwindowed > FLASH_ATOL[bf]):
        fail(f"windowed flash at {tuple(q.shape)}: {err} on {variant}, CUDA-core kernel "
             f"{scalar_err}, {unwindowed} from attention with no window")
    del out, want
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
           "scalar_source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:31",
           "max_abs_err": err, "variant": variant, "window": W,
           **timings(f"flash_attention q {tuple(q.shape)} window {W}",
                     lambda: ops.flash_attention(q, k, v, window=W),
                     lambda: ref.flash_attention_ref(q, k, v, window=W),
                     lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                            enable_gqa=True)),
           "scalar_ms": device_ms(lambda: flash_kernel.flash_attention_scalar(q, k, v,
                                                                              window=W), 5),
           "scalar_max_abs_err": scalar_err,
           **bound(*kernel_cost.flash_attention(B, H, KH, S, D, causal=True, window=W,
                                                itemsize=2)),
           "library_call": "F.scaled_dot_product_attention(q, k, v, attn_mask=causal "
                           "and window mask, enable_gqa=True)",
           "sdpa_max_abs_err": lib_err,
           "shape": f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal window {W}"}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["ratio_to_library"] = row["ms"] / row["library_ms"]
    print(f"kernels: hybrid flash at {row['shape']}: tensor-core kernel {row['ms']:.5f} ms "
          f"device ({row['share_of_bound']:.1%} of its {row['bound_ms']:.5f} ms bound, by "
          f"{row['bound_by']}, the window's pairs only), CUDA-core kernel "
          f"{row['scalar_ms']:.5f} ms, SDPA with the mask {row['library_ms']:.5f} ms (ratio "
          f"{row['ratio_to_library']:.3f}), plain {row['plain_ms']:.4f} ms")
    del q, k, v, mask
    torch.cuda.empty_cache()
    return row


def _window_sweep(gen) -> None:
    """Both flash kernels with a window against ``flash_attention_ref(window=)``
    over FLASH_WINDOW (f32 and bf16, causal and not, (B, S, H, D) views;
    each case must launch the kernel ``_want_variant`` names, and each bf16
    case, on the tensor-core kernel, is held through the CUDA-core kernel,
    called directly, too), and the gradients through FlashAttentionFn
    against autograd of the plain version over FLASH_WINDOW_GRAD (GRAD_ATOL
    plus GRAD_RTOL, as ``grad_phase``)."""
    worst, bad, took = {"forward": 0.0, "gradients": 0.0}, [], {}
    for (B, H, KH, S, D, W, *rest), dt, causal in [(c, dt, causal) for c in FLASH_WINDOW
                                                   for dt in (torch.float32, torch.bfloat16)
                                                   for causal in (True, False)]:
        Dv = rest[0] if rest else D
        q, k, v = _flash_inputs(gen, B, H, KH, S, D, dt, "bshd", Dv=Dv)
        want = _want_variant(dt, D, Dv)
        out, variant = _counted_variant(
            lambda: ops.flash_attention(q, k, v, causal=causal, window=W))
        plain = ref.flash_attention_ref(q, k, v, causal=causal, window=W)
        err = max_err(out, plain)
        if variant == "wgmma":
            err = max(err, max_err(flash_kernel.flash_attention_scalar(
                q, k, v, causal=causal, window=W), plain))
        worst["forward"] = max(worst["forward"], err)
        took[str(variant)] = took.get(str(variant), 0) + 1
        if not (err <= FLASH_ATOL[dt] and variant == want):
            bad.append(f"{(B, H, KH, S, D, Dv)} window {W} {dt} causal={causal}: {err} on "
                       f"{variant} (want {want})")
    for (B, H, KH, S, D, W), dt, causal in [(c, dt, causal) for c in FLASH_WINDOW_GRAD
                                            for dt in (torch.float32, torch.bfloat16)
                                            for causal in (True, False)]:
        q, k, v, do = (randn(gen, *s, dtype=dt) for s in
                       ((B, H, S, D), (B, KH, S, D), (B, KH, S, D), (B, H, S, D)))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(ops.flash_attention(*leaves, causal=causal, window=W),
                                  leaves, do)
        want = _autograd(lambda *a: ref.flash_attention_ref(*a, causal=causal, window=W),
                         (q, k, v), do)
        for nm, a, b in zip(("dq", "dk", "dv"), got, want):
            worst["gradients"] = max(worst["gradients"], max_err(a, b))
            if not (_grad_close(a, b, dt) and a.dtype == b.dtype):
                bad.append(f"{nm} {(B, H, KH, S, D)} window {W} {dt} causal={causal}: "
                           f"{max_err(a, b)}")
    sync()
    print(f"kernels: flash with a local window over {len(FLASH_WINDOW)} shapes x f32/bf16 "
          f"x causal or not, cases by kernel {took} (bf16 on 'wgmma', each also through "
          f"'scalar'), and its gradients over "
          f"{len(FLASH_WINDOW_GRAD)}: largest abs errors {worst} (atol 2e-3 f32 / 3e-2 "
          f"bf16; gradients 5e-3 / 5e-2 plus 2^-7 |reference| in bf16)")
    if bad:
        fail("windowed flash disagrees with its plain version: " + "; ".join(bad))


def hybrid_phase(name: str, kernels: list, row: dict) -> dict:
    """The hybrid family on the card (recurrentgemma-9b, random weights from
    seed 0): served at full width and depth in bf16 (flash one a group, all
    on the tensor-core kernel with the window), one request past the window at
    two max_seq (``_hybrid_past_window``), the HYBRID_PATH_LAYERS-layer
    model through the kernels against their plain versions in float32
    (``_hybrid_paths``), and trained at HYBRID_TRAIN_LAYERS layers
    (``_hybrid_train``).  Every earlier phase's tensor is freed first
    (gated).  ``row`` is the windowed flash row (``hybrid_kernel_phase``),
    given its launches here.  Returns the ``hybrid`` JSON object."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(HYBRID_ARCH)
    n = count_params(cfg)
    print(f"hybrid: {cfg.name}: {n:,} parameters ({cfg.n_layers} layers = "
          f"{cfg.n_layers // 3} groups of (RG-LRU, RG-LRU, local attention) + "
          f"{cfg.n_layers % 3} RG-LRU tail layers, d_model {cfg.d_model}, d_rnn "
          f"{cfg.d_rnn}, {cfg.n_heads} heads of {cfg.head_dim}, {cfg.n_kv_heads} KV head, "
          f"window {cfg.window}), {2 * n / 1e9:.2f} GB of bf16; device memory still "
          f"allocated before the phase {held:.3f} GB (need <= {MOE_HELD_GB})")
    if held > MOE_HELD_GB:
        fail(f"{held:.3f} GB of earlier phases' tensors still on the card")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab, n_)],
                    max_new_tokens=NEW_TOKENS) for n_ in PROMPT_LENS]
    parts = {}

    def part(label, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        parts[label] = time.perf_counter() - t1
        return out

    serve, serve_counts, params = part("serve", _serve, cfg, reqs, "hybrid")
    serve["device_ms_by_layer"] = part("by layer", _hybrid_by_layer, cfg, params, reqs)
    serve["past_window"] = part("past window", _hybrid_past_window, cfg, params, rng)
    del params
    gc.collect()                # the engines' spies hold their params in a cycle
    torch.cuda.empty_cache()
    paths = part("paths", _hybrid_paths,
                 cfg.with_(n_layers=HYBRID_PATH_LAYERS, dtype="float32"), reqs, rng)
    held = torch.cuda.memory_allocated() / 1e9
    print(f"hybrid: device memory still allocated before training {held:.3f} GB")
    train, train_counts = part("train", _hybrid_train, cfg.with_(n_layers=HYBRID_TRAIN_LAYERS))
    for kern in kernels:        # the main path: the served and the trained run
        kern["launches_by_path"]["hybrid"] = (serve_counts[kern["name"]]
                                              + train_counts[kern["name"]])
    row["launches_by_path"] = {"hybrid": serve_counts["flash_attention"]
                               + train_counts["flash_attention"]}
    row["launches"] = row["launches_by_path"]["hybrid"]
    gc.collect()        # the traced graphs and the engines' cycles, before serving's timed runs
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    print(f"hybrid: phase {phase_s:.1f}s (budget {HYBRID_BUDGET_S:.0f}s, printed): "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return {"device": name, "config": f"{cfg.name} served at {cfg.n_layers} layers, "
            f"paths at {HYBRID_PATH_LAYERS} in float32, trained at {HYBRID_TRAIN_LAYERS}, "
            f"random weights from seed 0", "serve": serve, "paths": paths,
            "train": train, "kernel": {k: row[k] for k in ("ms", "bound_ms", "plain_ms",
                                                          "library_ms", "launches")},
            "phase_s": phase_s, "parts_s": parts}


def _hybrid_by_layer(cfg, params, reqs) -> dict:
    """Where the served model's device time goes: one prefill of the
    requests and one decode step on their cache, each traced
    (``trace_measured``, one capture after one warm-up call), the device
    ms summed by layer scope (``rglru``, ``attn``, ``mlp``, ``norm``,
    ``embed``, ``unembed``; None: outside any)."""
    model = build_model(cfg)
    toks = _prompt_tokens(reqs)
    plen = toks.shape[1]
    out = {}
    with torch.inference_mode():
        cache = init_cache(cfg, len(reqs), plen + 1, DEV)
        for label, fn in (("prefill", lambda: model.prefill(params, {"tokens": toks})),
                          ("decode step", lambda: model.decode(params, cache, toks[:, :1],
                                                               plen))):
            graph = trace_measured(fn, device=DEV, warmup=1, profiles=1).graph
            by = {}
            for t in graph.lane_tasks(DEVICE_STREAM):
                by[str(t.layer)] = by.get(str(t.layer), 0.0) + t.duration * 1e3
            out[label] = dict(sorted(by.items(), key=lambda kv: -kv[1]))
            total = sum(by.values())
            print(f"hybrid: device ms by layer per {label} ({total:.3f} ms traced): "
                  + "; ".join(f"{k} {v:.3f} ({v / total:.1%})"
                              for k, v in out[label].items()))
    del cache
    torch.cuda.empty_cache()
    return out


def _hybrid_past_window(cfg, params, rng) -> dict:
    """One request of HYBRID_PAST prompt tokens (past the window) and
    NEW_TOKENS new ones through ``ServeEngine.generate`` at each max_seq of
    HYBRID_CACHE_SEQS: the prefill's K/V arrives as a rolled ring of the
    window; the bytes of the cache the engine grows and the tokens must be
    equal at every max_seq, the flash launches one a group on the kernel
    ``_flash_kernel_of`` names."""
    prompt = [int(t) for t in rng.integers(1, cfg.vocab, HYBRID_PAST)]
    out, tokens = {}, []
    for max_seq in HYBRID_CACHE_SEQS:
        engine = ServeEngine(cfg, params, max_seq=max_seq, device=DEV)
        grown = []
        plain = engine._grow_cache

        def spy(prefix, plen, plain=plain, grown=grown):
            grown.append(plain(prefix, plen))
            return grown[-1]

        engine._grow_cache = spy
        ops.reset_launch_counts()
        res = engine.generate([Request(prompt, NEW_TOKENS)])
        counts, by_variant = ops.launch_counts(), dict(flash_kernel.launches_by_variant)
        st = engine.stats
        ring = grown[-1][0]["attn"]["k"].shape[1]
        out[str(max_seq)] = {"cache_bytes": _cache_bytes(grown[-1]), "ring": ring,
                             "host_prefill_ms": st["prefill_s"] * 1e3,
                             "host_decode_ms": st["decode_s"] / st["decode_steps"] * 1e3,
                             "flash_by_kernel": by_variant}
        tokens.append(res[0].tokens)
        print(f"hybrid: past the window: one request of {HYBRID_PAST} tokens at max_seq "
              f"{max_seq}: prefill {st['prefill_s'] * 1e3:.2f} ms host, decode "
              f"{out[str(max_seq)]['host_decode_ms']:.3f} ms/token host; the engine's "
              f"cache {out[str(max_seq)]['cache_bytes']:,} B, K/V ring of {ring} "
              f"positions; flash by kernel {by_variant} (need {_flash_kernel_of(cfg)} "
              f"{_flashes(cfg)})")
        if (by_variant != {"wgmma": 0, "scalar": 0, _flash_kernel_of(cfg): _flashes(cfg)}
                or ring != cfg.window):
            fail(f"hybrid past the window: flash {by_variant}, ring {ring}")
        del engine, grown
    sizes = {k: o["cache_bytes"] for k, o in out.items()}
    same = tokens[0] == tokens[1]
    print(f"hybrid: cache bytes by max_seq {sizes} (need all equal); tokens equal "
          f"{same} (need True)")
    if len(set(sizes.values())) != 1 or not same:
        fail(f"the hybrid decode cache or tokens change with max_seq: {sizes} {tokens}")
    if not all(0 <= t < cfg.vocab for t in tokens[0]) or len(tokens[0]) != NEW_TOKENS:
        fail(f"bad hybrid generation past the window {tokens[0]}")
    return out


def _hybrid_paths(cfg, reqs, rng) -> dict:
    """The float32 model at HYBRID_PATH_LAYERS layers (attention projections
    rescaled, as the moe phase does): its prefill and one decode step
    through the kernels against the same through their plain versions
    (logits within MOE_LOGITS_RTOL of their largest magnitude; launches
    exact: flash one a group, on the CUDA-core kernel in float32, RMSNorm
    ``_norms`` a forward), the engine's greedy tokens on both paths (equal),
    and decode
    step S against a fresh prefill of S + 1 tokens with S = HYBRID_PAST,
    past the window (within HYBRID_DECODE_RTOL)."""
    params = init_params(cfg, seed=0, device=DEV)
    _rescale_attention(cfg, params)
    model = build_model(cfg)
    toks = _prompt_tokens(reqs)
    plen = toks.shape[1]
    nxt = toks[:, -1:]
    with torch.inference_mode():
        ops.reset_launch_counts()
        got, cache = model.prefill(params, {"tokens": toks})
        got_dec, _ = model.decode(params, cache, nxt, plen)
        sync()
        counts, by_variant = ops.launch_counts(), dict(flash_kernel.launches_by_variant)
        with _plain_kernels():
            want, cache = model.prefill(params, {"tokens": toks})
            want_dec, _ = model.decode(params, cache, nxt, plen)
        sync()
    plain_counts = ops.launch_counts()
    rel = max_err(got, want) / want.abs().max().item()
    rel_dec = max_err(got_dec, want_dec) / want_dec.abs().max().item()
    engine = ServeEngine(cfg, params, max_seq=plen + NEW_TOKENS, device=DEV)
    kernel_toks = [r.tokens for r in engine.generate(reqs)]
    with _plain_kernels():
        plain_toks = [r.tokens for r in engine.generate(reqs)]
    same = sum(a == b for ka, pa in zip(kernel_toks, plain_toks) for a, b in zip(ka, pa))
    seq = torch.tensor(rng.integers(1, cfg.vocab, (1, HYBRID_PAST + 1)), device=DEV)
    finite, top1, rel_s = _decode_vs_prefill(cfg, params, seq)
    need = {"flash_attention": _flashes(cfg), "rmsnorm": 2 * _norms(cfg),
            "fused_adam": 0, "dgc_mask": 0}
    print(f"hybrid: {cfg.n_layers} layers, float32, prefill of {tuple(toks.shape)} and "
          f"one decode step: kernel path against plain path, logits {rel:.3g} and "
          f"{rel_dec:.3g} of their largest magnitude (need <= {MOE_LOGITS_RTOL}); greedy "
          f"tokens through the engine {same} of {sum(map(len, kernel_toks))} equal (need "
          f"all); launches {counts}, flash by kernel {by_variant} then {plain_counts} "
          f"(need {need}, all scalar, then unchanged); decode vs a fresh prefill at "
          f"S={HYBRID_PAST}, past the window: relative max error {rel_s:.3g}, top-1 "
          f"agreement {top1:.3f}, finite {finite} (need <= {HYBRID_DECODE_RTOL}, True)")
    if not (rel <= MOE_LOGITS_RTOL and rel_dec <= MOE_LOGITS_RTOL
            and kernel_toks == plain_toks):
        fail("the hybrid model's kernel path disagrees with its plain path")
    if (counts != need or plain_counts != counts
            or by_variant != {"wgmma": 0, "scalar": 0, _flash_kernel_of(cfg): _flashes(cfg)}):
        fail(f"hybrid kernel-path launches {counts} {by_variant}, {plain_counts} != {need}")
    if not (finite and rel_s <= HYBRID_DECODE_RTOL):
        fail(f"hybrid decode past the window disagrees with a fresh prefill: {rel_s:.3g}")
    del params, model, engine, got, want, got_dec, want_dec, cache
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "dtype": "float32", "prefill_logits_rel_err": rel,
            "decode_logits_rel_err": rel_dec, "greedy_tokens_equal": same,
            "decode_vs_prefill_past_window": {"S": HYBRID_PAST, "rel_err": rel_s,
                                              "top1": top1}}


def _hybrid_train(cfg) -> tuple:
    """``Trainer.step_fn`` with ``AdamW(fused=True)`` at full width and
    ``cfg.n_layers`` layers (attention projections rescaled, as
    ``loss_falls_phase``) on one ``SyntheticLM`` batch of 1 x TRAIN_SEQ,
    HYBRID_TRAIN_STEPS steps, each timed by CUDA events: the loss finite
    and falling, launches exact per step (flash one a group, on the
    tensor-core kernel with the window; its backward plain), the peak device
    memory printed.  (JSON, launches)."""
    L, S = cfg.n_layers, TRAIN_SEQ
    n = count_params(cfg)
    flops = 6 * n * S
    per_step = {"flash_attention": _flashes(cfg), "rmsnorm": _norms(cfg), "fused_adam": 1,
                "dgc_mask": 0}
    trainer = Trainer(cfg, TrainerConfig(steps=HYBRID_TRAIN_STEPS, log_every=0, seed=0),
                      optimizer=AdamW(fused=True), device=DEV)
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in SyntheticLM(cfg.vocab, S, 1, seed=0).batch_at(0).items()}
    holder = {"state": trainer.init_state()}
    _rescale_attention(cfg, holder["state"]["params"])
    losses, step_counts, by_variant = [], [], []

    def one_step():
        holder["state"], m = trainer.step_fn(holder["state"], batch)
        losses.append(m["loss"])
        step_counts.append(ops.launch_counts())
        by_variant.append(dict(flash_kernel.launches_by_variant))
        ops.reset_launch_counts()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times = []
    for _ in range(HYBRID_TRAIN_STEPS):
        times.append(measure_wallclock(one_step, device=DEV, iters=1, warmup=0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    step_ms = float(np.median(times[1:]))
    print(f"hybrid: train {cfg.name} at {L} layers ({L // 3} group), full width, 1 x "
          f"{S}, {n:,} parameters, AdamW(fused=True), {HYBRID_TRAIN_STEPS} steps on one "
          f"batch: losses " + ", ".join(f"{x:.4f}" for x in losses) + " (need finite, "
          f"the last below the first); step ms " + ", ".join(f"{t:.1f}" for t in times)
          + f" (CUDA events; step 0 the warm-up), {step_ms:.1f} ms, mfu "
          f"{flops / step_ms / 1e-3 / PEAK_BF16_FLOPS:.4f} (6 x params x tokens / step / "
          f"989e12); peak device memory {peak:.2f} GB; launches per step {step_counts}, "
          f"flash by kernel {by_variant} (need {per_step} each, flash "
          f"{_flash_kernel_of(cfg)}); the "
          f"update's fused_adam launches {[c['fused_adam'] for c in step_counts]}")
    want_variant = {"wgmma": 0, "scalar": 0, _flash_kernel_of(cfg): per_step["flash_attention"]}
    if any(c != per_step for c in step_counts) or any(v != want_variant for v in by_variant):
        fail(f"hybrid train launch counts {step_counts} {by_variant}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"hybrid loss did not fall over {HYBRID_TRAIN_STEPS} steps on one batch: "
             f"{losses}")
    del holder, trainer, batch
    torch.cuda.empty_cache()
    counts = {k: v * HYBRID_TRAIN_STEPS for k, v in per_step.items()}
    return {"layers": L, "params": n, "batch": 1, "seq": S, "losses": losses,
            "step_ms": step_ms, "step_ms_each": times, "tokens_per_s": S / step_ms * 1e3,
            "flops_per_step": flops, "mfu": flops / step_ms / 1e-3 / PEAK_BF16_FLOPS,
            "peak_gb": peak, "launches_per_step": per_step}, counts


MOE_ROWS = [("attention", lambda k: k.startswith("attn ")),
            ("moe (routed experts)", lambda k: k.startswith("moe ")),
            ("moe (shared experts)", lambda k: k.startswith("mlp ")),
            ("norm", lambda k: k.startswith("norm ")),
            ("loss", lambda k: k.startswith("loss ")),
            ("embed", lambda k: k.startswith("embed ")),
            ("update", lambda k: k.startswith("update ")),
            ("unmapped", lambda k: k.startswith("None "))]

def _ssm_projection_ab(cfg, step_ms: float) -> dict:
    """The layer's one input product over the concatenated weights
    (``mamba2_forward``'s) against the reference's five products, forward
    and backward at 1 x TRAIN_SEQ in bf16 with one layer's weights, each
    timed alone (CUDA events, median of 20; interleaved five / one / five /
    one) and its host issue time (no profiler): the difference times the
    trained depth against the fused step (printed, not gated)."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    d, e = cfg.d_model, cfg.ssm_expand * cfg.d_model
    widths = [e, e, cfg.ssm_state, cfg.ssm_state, e // 64]
    x = randn(gen, 1, TRAIN_SEQ, d, dtype=torch.bfloat16).requires_grad_()
    ws = [(randn(gen, d, n, dtype=torch.bfloat16) * d ** -0.5).requires_grad_()
          for n in widths]
    dys = [randn(gen, 1, TRAIN_SEQ, n, dtype=torch.bfloat16) for n in widths]

    def five():
        torch.autograd.backward([x @ w for w in ws], dys)

    def one():
        ys = (x @ torch.cat(ws, 1)).split(widths, -1)
        torch.autograd.backward(list(ys), dys)

    ms, issue = {}, {}
    for label, fn in (("five", five), ("one", one), ("five 2", five), ("one 2", one)):
        ms[label] = measure_wallclock(fn, device=DEV, iters=20, warmup=3) * 1e3
        issue[label] = _issue_and_wait(fn, 5)[0]
    five_ms, one_ms = min(ms["five"], ms["five 2"]), min(ms["one"], ms["one 2"])
    five_issue, one_issue = min(issue["five"], issue["five 2"]), min(issue["one"], issue["one 2"])
    share = (five_ms - one_ms) * cfg.n_layers / step_ms
    print(f"ssm: input projections of one layer, forward and backward at 1 x {TRAIN_SEQ}: "
          f"five products {five_ms:.4f} ms (host issue {five_issue:.4f} ms), one product "
          f"of the concatenated weights {one_ms:.4f} ms (host issue {one_issue:.4f} ms); "
          f"the difference x {cfg.n_layers} layers is {share:+.2%} of the fused step "
          f"{step_ms:.3f} ms (printed, not gated)")
    out = {"five_ms": five_ms, "one_ms": one_ms, "five_issue_ms": five_issue,
           "one_issue_ms": one_issue, "runs_ms": ms, "share_of_step": share}
    del x, ws, dys
    torch.cuda.empty_cache()
    return out


SSM_ROWS = [("ssm", lambda k: k.startswith("ssm ")),
            ("norm", lambda k: k.startswith("norm ")),
            ("embed", lambda k: k.startswith("embed ")),
            ("unembed", lambda k: k.startswith("unembed ")),
            ("loss", lambda k: k.startswith("loss ")),
            ("update", lambda k: k.startswith("update ")),
            ("unmapped", lambda k: k.startswith("None "))]


def _layer_table(by: dict, rows: list, tag: str, must: str) -> dict:
    """The traced and predicted device ms by layer (forward + backward), as
    ``rows`` group them; printed as ``tag:``, the ``must`` row's traced time
    gated above 0."""
    table = {row: {kind: sum(v for k, v in by[kind].items() if pick(k))
                   for kind in ("traced", "predicted")} for row, pick in rows}
    print(f"{tag}: device ms by layer, traced per-leaf step / fused_optimizer "
          "predicted: " + "; ".join(f"{row} {v['traced']:.3f} / {v['predicted']:.3f}"
                                    for row, v in table.items()))
    if table[must]["traced"] <= 0:
        fail(f"no {must} layer in the traced {tag} step")
    return table


def _compiled_cell(cfg, tag: str, need: dict = None, layer: str = None,
                   measured_ms: float = None) -> dict:
    """``perf_report.trace_cell`` of ``cfg``'s train_4k step (the per-device
    1 x TRAIN_SEQ data-parallel step, the fused AdamW update included) on
    meta tensors, priced by H100_SXM: its kernel tasks gated equal to
    ``need`` and ``layer``'s device time above 0 where ``need`` is given;
    its simulated step against the fused step ``measured_ms`` measured on
    the card where given (printed, not gated).  Lines are printed as
    ``tag:``."""
    t0 = time.perf_counter()
    bundle = perf_report.trace_cell(cfg, SHAPES["train_4k"])
    trace_s = time.perf_counter() - t0
    dev = bundle.graph.lane_tasks(DEVICE_STREAM)
    kernel_tasks = {k: sum(t.attrs.get("kernel") == k for t in dev)
                    for k in ("flash_attention", "rmsnorm", "fused_adam", "dgc_mask")}
    by = {}
    for t in dev:
        by[str(t.layer)] = by.get(str(t.layer), 0.0) + t.duration * 1e3
    sim_ms = bundle.simulate().makespan * 1e3
    row = {"trace_s": trace_s, "layers": cfg.n_layers, "device_tasks": len(dev),
           "kernel_tasks": kernel_tasks, "simulated_ms": sim_ms, "ms_by_layer": by}
    text = ""
    if measured_ms is not None:
        row["ratio_to_measured"] = sim_ms / measured_ms
        text = (f" against the measured fused step {measured_ms:.3f} ms: "
                f"{sim_ms / measured_ms:.4f}")
    print(f"{tag}: trace_cell of {cfg.name} train_4k at {cfg.n_layers} layers, 1 x "
          f"{TRAIN_SEQ} on meta tensors in {trace_s:.1f}s: {len(dev)} device tasks, "
          f"kernel tasks {kernel_tasks}" + (f" (need {need})" if need else "")
          + f", simulated {sim_ms:.3f} ms on H100_SXM's data sheet{text}; by layer "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
          + " (printed, not gated)")
    if need is not None and (kernel_tasks != need or by.get(layer, 0.0) <= 0):
        fail(f"{tag} compiled route: kernel tasks {kernel_tasks} != {need} or no "
             f"{layer} layer")
    del bundle, dev
    return row


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x|: 2^(exponent - 8), frexp's mantissa in [0.5, 1)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)


def dgc_entry(g) -> dict:
    """The DGC threshold kernel on a training gradient (the unembedding's):
    its own path (k-th magnitude from the exact oracle, then one dgc_mask),
    checked and timed."""
    want, k, thr = ref.dgc_topk_ref(g, DGC_RATIO)
    ops.reset_launch_counts()
    got, count = ops.dgc_mask(g, thr)
    sync()
    launches = ops.launch_counts()["dgc_mask"]
    _, why = _dgc_check(g, DGC_RATIO)
    print(f"dgc: unembedding gradient {tuple(g.shape)} {g.dtype}, ratio {DGC_RATIO}: "
          f"k {k}, kept {int(count)}, max abs err {max_err(got, want)} (exact); "
          f"launches {launches}")
    if why or launches != 1:
        fail(f"dgc_mask on the unembedding gradient: {why} launches {launches}")
    return {"name": "dgc_mask", "route": "cuda",
            "source": "src/repro_torch/csrc/dgc_topk.cu",
            "replaces": "src/repro/kernels/dgc_topk.py:27",
            "max_abs_err": max_err(got, want),
            **timings(f"dgc_mask n={g.numel()}",
                      lambda: ops.dgc_mask(g, thr), lambda: ref.dgc_mask_ref(g, thr),
                      lambda: torch.where(g.abs() >= thr, g, 0)),
            "library_call": "torch.where(g.abs() >= thr, g, 0), without the count",
            **bound(*kernel_cost.dgc_mask(g.numel(), itemsize=g.element_size()),
                    PEAK_F32_FLOPS),
            "launches_by_path": {"dgc": launches},
            "shape": f"g {tuple(g.shape)} {str(g.dtype).replace('torch.', '')}"}


def loss_falls_phase(cfg, trainer) -> None:
    """5 fused-AdamW steps on one fixed batch: printed for the reference init,
    checked (last loss below the first) with the attention projections
    rescaled to the usual fan-in (the reference init is chaotic at this
    width, see serve_phase)."""
    batch = _device_batch(cfg, 0)
    for label, rescale in (("reference init (printed, not checked)", False),
                           ("attention rescaled", True)):
        state = trainer.init_state()
        if rescale:
            _rescale_attention(cfg, state["params"])
        losses = []
        for _ in range(5):
            state, m = trainer.step_fn(state, batch)
            losses.append(float(m["loss"]))
        del state
        print(f"train: 5 steps on one batch, {label}: losses "
              + ", ".join(f"{x:.4f}" for x in losses))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"loss did not fall over 5 steps on one batch: {losses}")


def _rescale_attention(cfg, params) -> None:
    """In place: wq, wk, wv to std 1/sqrt(d), wo to std 1/sqrt(H * hd) (the
    hybrid family's in each group's attention sub-block); MLA's wq_b to std
    1/sqrt(q_lora), wk_b and wv_b to std 1/sqrt(kv_lora), so q, k and v
    have entries of std ~1, and wo as GQA's."""
    d, H, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    for lp in params["blocks"]:
        a = lp["attn"]["attn"] if cfg.family == "hybrid" else lp["attn"]
        if cfg.family == "mla_moe":
            a["wq_b"] *= (H / cfg.q_lora) ** 0.5
            a["wk_b"] *= (H / cfg.kv_lora) ** 0.5
            a["wv_b"] *= (H / cfg.kv_lora) ** 0.5
        else:
            a["wq"] *= (H / d) ** 0.5
            a["wk"] *= (K / d) ** 0.5
            a["wv"] *= (K / d) ** 0.5
        a["wo"] *= (1 / H) ** 0.5


def _consistency(cfg, params, reqs, results, seq):
    """Each generated token against a fresh prefill of the tokens before it,
    and decode step S's logits against a fresh prefill of S + 1 tokens."""
    model = build_model(cfg)
    with torch.inference_mode():
        toks = _prompt_tokens(reqs)
        gen = torch.tensor([r.tokens for r in results], device=DEV)
        agree = []
        for t in range(gen.shape[1]):
            logits, _ = model.prefill(params, {"tokens": torch.cat([toks, gen[:, :t]], 1)})
            agree.append((logits.argmax(-1) == gen[:, t]).float().mean().item())
        teacher = float(np.mean(agree))
    finite, top1, rel = _decode_vs_prefill(cfg, params, seq)
    text = (f"share of the {gen.numel()} generated tokens equal to a fresh "
            f"prefill's argmax {teacher:.4f}; decode vs prefill at S={seq.shape[1] - 1}: "
            f"top-1 agreement {top1:.3f}, relative max error {rel:.3g}, finite "
            f"{finite} (need >= 0.5, >= 0.5, < 0.05, True)")
    return text, finite and teacher >= 0.5 and top1 >= 0.5 and rel < 0.05


def _decode_vs_prefill(cfg, params, seq) -> tuple:
    """(finite, top-1 agreement, relative max error) of decode step S's
    logits, on the prefill of ``seq[:, :S]``, against a fresh prefill of
    ``seq`` (S + 1 tokens)."""
    model = build_model(cfg)
    S = seq.shape[1] - 1
    with torch.inference_mode():
        full, _ = model.prefill(params, {"tokens": seq})
        _, prefix = model.prefill(params, {"tokens": seq[:, :S]})
        cache = ServeEngine(cfg, params, max_seq=S + 1, device=DEV)._grow_cache(prefix, S)
        dec, _ = model.decode(params, cache, seq[:, S:], S)
        a, b = full.float(), dec.float()
        finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
        top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        rel = ((a - b).abs().max() / (a.abs().max() + 1e-6)).item()
    return finite, top1, rel


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _named(tree, prefix=""):
    """{dotted path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_named(v, f"{prefix}{k}."))
    return out


def main() -> None:
    t0 = time.perf_counter()
    seconds = {}

    def phase(label, fn, *args):
        """``fn(*args)``, its seconds printed on a line of their own."""
        t1 = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t1
        print(f"chip_smoke: phase {label} took {seconds[label]:.1f}s", flush=True)
        return out

    name = phase("device", device_phase)
    phase("build", build_phase)
    prime_profiler()
    cfg = get_config(ARCH)
    kernels = phase("kernels", kernel_phase, cfg, len(PROMPT_LENS), max(PROMPT_LENS))
    deepseek_rows = phase("deepseek kernels", deepseek_kernel_phase)
    moe_rows = phase("moe kernels", moe_kernel_phase)
    ssm_rows = phase("ssm kernels", ssm_kernel_phase)
    hybrid_row = phase("hybrid kernels", hybrid_kernel_phase)
    n_params = phase("serve", serve_phase, cfg, kernels)
    kernels += phase("adam, dgc", adam_dgc_phase, n_params)
    phase("train", train_phase, cfg, kernels, n_params)
    with tempfile.TemporaryDirectory() as tmp:
        traces, handoff = Path(tmp), {}
        whatif = phase("whatif", whatif_phase, cfg, name, kernels, traces)
        amp = phase("amp", amp_phase, cfg, name, kernels, traces, handoff)
        traceio = phase("traceio", traceio_phase, name, traces, handoff)
        launch = phase("launch", launch_phase, cfg, name, kernels, traces, handoff, amp)
        del handoff
        faults = phase("faults", faults_phase, cfg, name, kernels, traces)
    moe = phase("moe", moe_phase, name, kernels, moe_rows)
    deepseek = phase("deepseek", deepseek_phase, name, kernels, deepseek_rows)
    ssm = phase("ssm", ssm_phase, name, kernels, ssm_rows)
    hybrid = phase("hybrid", hybrid_phase, name, kernels, hybrid_row)
    serving = phase("serving", serving_phase)   # last: no profiled phase follows its launches
    for kern in kernels:    # the count from this slice's main path, or its own
        paths = kern["launches_by_path"]
        paths["serving"] = serving["launches"][kern["name"]]
        kern["launches"] = paths["launch"] or paths.get("dgc", 0)
    kernels.append(hybrid_row)      # the windowed flash: its main path is the hybrid phase
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "event_ms", "event_ms_apart",
            "profiler",
            "call_ms", "shape",
            "launches_by_path", "launches_per_train_step"]
    extra = ["scalar_ms", "scalar_max_abs_err", "share_of_bound", "ratio_to_library",
             "scalar_source", "launches_by_variant", "train_shape", "library_call",
             "head_dim_256", "plan", "window", "sdpa_max_abs_err"]
    total = time.perf_counter() - t0
    print(f"chip_smoke: all phases passed in {total:.1f}s; by phase "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(card())           # again at the end: the limit the run ended under
    print(json.dumps({"whatif": whatif}))
    print(json.dumps({"amp": amp}))
    print(json.dumps({"traceio": traceio}))
    print(json.dumps({"faults": faults}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"launch": launch}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"deepseek": deepseek}))
    print(json.dumps({"ssm": ssm}))
    print(json.dumps({"hybrid": hybrid}))
    print(json.dumps({"phase_s": {**seconds, "total": total}}))
    print(json.dumps({"kernels": [{k: kern[k] for k in keys + extra if k in kern}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
