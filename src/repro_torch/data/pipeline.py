"""Data pipeline (counterpart of ``repro/data/pipeline.py``): deterministic
synthetic token streams, per-host sharding, and background prefetch (double
buffering).  numpy only; batches are moved to the device by the trainer.

The synthetic stream has *learnable* structure — ``next = (a*tok + b) mod V``
with flip noise — so end-to-end training shows a real loss decrease, not just
throughput.  For the same ``(cfg, seq_len, batch, step, seed)`` it yields the
same arrays as the reference.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.model import ModelConfig


def host_shard(global_batch: int, host_id: int, n_hosts: int) -> slice:
    per = global_batch // n_hosts
    rem = global_batch % n_hosts
    start = host_id * per + min(host_id, rem)
    return slice(start, start + per + (1 if host_id < rem else 0))


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic LM stream with a learnable affine structure."""

    vocab: int
    seq_len: int
    batch: int                      # this host's slice of the global batch
    seed: int = 0
    noise: float = 0.05
    a: int = 5
    b: int = 131

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((self.batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        for t in range(self.seq_len):
            nxt = (self.a * toks[:, t] + self.b) % self.vocab
            flip = rng.random(self.batch) < self.noise
            nxt = np.where(flip, rng.integers(0, self.vocab, self.batch), nxt)
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch(cfg: ModelConfig, *, seq_len: int, batch: int, step: int,
               seed: int = 0, kind: str = "train") -> Dict[str, np.ndarray]:
    """Synthetic batch (numpy, host-local).  The reference's ``vlm`` and
    ``encdec`` batches carry bf16 embeddings, which numpy holds only through
    ``ml_dtypes``; those families are not ported and raise."""
    if cfg.family in ("vlm", "encdec"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    b = SyntheticLM(cfg.vocab, seq_len, batch, seed).batch_at(step)
    if kind != "train":
        b.pop("labels", None)
    return b


class Prefetcher:
    """Background-thread double buffering over any batch iterator."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, depth: int = 2) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:   # surfaced on next()
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
