"""Batched serving engine: prefill + greedy decode over a shared KV cache
(counterpart of ``repro/serve/engine.py``).

Static-batch semantics as in the reference: one batch of requests is
left-padded with token 0 to the longest prompt (the pads are attended to,
positions count from the first pad), prefilled together, then decoded one
token per step until the largest ``max_new_tokens`` is reached; finished
slots keep decoding until the batch drains.

The cache is allocated at ``max_seq`` per layer, as the family's cache spec
gives it.  A prefill leaf whose spec carries the sequence axis (K/V, MLA's
c_kv/k_rope) is written into its first positions, as many as it holds (the
prompt's, so decode step ``pos`` writes its own slot; a local window's
ring of ``min(max_seq, window)`` positions arrives whole, rolled to slot
``pos % window`` when the prompt is at least the window); any other leaf
(the ssm family's conv window and state, the hybrid family's ``conv`` and
``h``, constant in the sequence length) is copied whole, and its shape must
be the spec's.  Nested leaves (a hybrid group's ``rec1``, ``rec2``,
``attn``) are walked.
(The reference's ``_grow_cache`` pads only 4-D leaves, and its prefill cache
is stacked over layers and 5-D, so its decode steps overwrite the last
prompt slot; that is not copied here.)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import (ModelConfig, cache_axes, init_cache,
                                      make_prefill_step, make_serve_step)


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16


@dataclasses.dataclass
class Result:
    tokens: List[int]              # generated continuation (greedy)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_seq: int = 256,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self._prefill = make_prefill_step(cfg)
        self._decode = make_serve_step(cfg)
        # host-clock seconds of the last generate(), each phase ending in a
        # device synchronise: prefill_s, decode_s, decode_steps
        self.stats: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _grow_cache(self, prefix: List[Dict[str, Any]], plen: int
                    ) -> List[Dict[str, Any]]:
        """The prefill's per-layer cache (``plen`` positions) written into a
        zeroed cache of ``max_seq`` positions, leaf by leaf: a leaf with a
        sequence axis into its first positions, as many as it holds (``plen``,
        or a whole window's ring), any other whole."""
        leaf = prefix[0]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        cache = init_cache(self.cfg, leaf.shape[0], self.max_seq, self.device)

        def grow(dst, pre, axes, path):
            for key, src in pre.items():
                if isinstance(src, dict):
                    grow(dst[key], src, axes[key], f"{path}{key}.")
                elif axes[key] is None:
                    if src.shape != dst[key].shape:
                        raise ValueError(f"cache leaf {path + key!r}: prefill shape "
                                         f"{tuple(src.shape)}, spec "
                                         f"{tuple(dst[key].shape)}")
                    dst[key].copy_(src)
                else:
                    dst[key].narrow(axes[key], 0, src.shape[axes[key]]).copy_(src)

        for layer, pre, axes in zip(cache, prefix, cache_axes(self.cfg)):
            grow(layer, pre, axes, "")
        return cache

    @torch.inference_mode()
    def generate(self, requests: List[Request]) -> List[Result]:
        B = len(requests)
        plen = max(len(r.prompt) for r in requests)
        if plen >= self.max_seq:
            raise ValueError(f"prompt length {plen} leaves no room in "
                             f"max_seq={self.max_seq}")
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt     # left-pad
        t0 = time.perf_counter()
        nxt, prefix = self._prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)})
        cache = self._grow_cache(prefix, plen)
        del prefix
        self._sync()
        t1 = time.perf_counter()
        budget = max(r.max_new_tokens for r in requests)
        out = [nxt]
        pos = plen
        for _ in range(min(budget - 1, self.max_seq - plen - 1)):
            nxt, cache = self._decode(self.params, cache, nxt, pos)
            out.append(nxt)
            pos += 1
        gen = torch.cat(out, dim=1).cpu().numpy()
        t2 = time.perf_counter()
        self.stats = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                      "decode_steps": len(out) - 1}
        return [Result(tokens=[int(t) for t in gen[i, :r.max_new_tokens]])
                for i, r in enumerate(requests)]
