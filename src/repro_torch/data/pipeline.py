"""Data pipeline (counterpart of ``repro/data/pipeline.py``): deterministic
synthetic token streams, per-host sharding, and background prefetch (double
buffering).  numpy only; batches are moved to the device by the trainer.

The synthetic stream has *learnable* structure — ``next = (a*tok + b) mod V``
with flip noise — so end-to-end training shows a real loss decrease, not just
throughput.  For the same ``(cfg, seq_len, batch, step, seed)`` it yields the
same arrays as the reference, whose ``batch_at`` draws from numpy once per
position.  Here the same draws are taken from the generator's raw stream in
bulk and the recurrence is solved in closed form between flips: a batch of
4096 positions costs milliseconds rather than a Python loop of 4096 steps,
which held the GIL in ``Prefetcher``'s thread while the trainer issued its
step.
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
        V, B, S, a, b = self.vocab, self.batch, self.seq_len, self.a, self.b
        toks = np.empty((B, S + 1), np.int32)
        if not (1 < V < 2 ** 31 and a >= 0 and b >= 0 and a * (V - 1) + b < 2 ** 31
                and isinstance(rng.bit_generator, np.random.PCG64)):
            # the reference's int32 arithmetic would wrap: its loop, as it is
            toks[:, 0] = rng.integers(0, V, B)
            for t in range(S):
                nxt = (a * toks[:, t] + b) % V
                flip = rng.random(B) < self.noise
                toks[:, t + 1] = np.where(flip, rng.integers(0, V, B), nxt)
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        # the reference's draws: B integers for position 0, then for each
        # position B uniforms and B integers
        kinds = np.concatenate([np.zeros(B, bool), np.tile(
            np.concatenate([np.ones(B, bool), np.zeros(B, bool)]), S)])
        ints, doubles = _pcg64_draws(rng.bit_generator, kinds, V)
        ints = ints.reshape(S + 1, B)
        flip = doubles.reshape(S, B) < self.noise
        # the last position at or before each t whose token was drawn (0, or
        # a flip), and the affine map applied k = t - that position times:
        # x -> mult[k] * x + add[k] (mod V)
        drawn = np.concatenate([np.ones((1, B), bool), flip])
        pos = np.arange(S + 1)[:, None]
        last = np.maximum.accumulate(np.where(drawn, pos, 0), axis=0)
        mult, add = np.empty(S + 1, np.int64), np.empty(S + 1, np.int64)
        m, c = 1, 0
        for k in range(S + 1):
            mult[k], add[k] = m, c
            m, c = a * m % V, (a * c + b) % V
        base = np.take_along_axis(ints, last, axis=0)
        k = pos - last
        toks[:] = ((mult[k] * base + add[k]) % V).T
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def _pcg64_draws(bitgen, kinds: np.ndarray, V: int):
    """The values numpy's ``Generator.integers(0, V, n)`` (``kinds`` False)
    and ``Generator.random(n)`` (True) calls would give, in the order of
    ``kinds``, from PCG64's raw 64-bit stream: a uniform is a whole draw's
    top 53 bits; an integer is Lemire's bounded map of a 32-bit draw, which
    takes the low half of a new 64-bit draw and then its high half, and is
    drawn again while the map's leftover is below ``2**32 % V``.  Returns
    (integers as int64, uniforms)."""
    threshold = (2 ** 32 - V) % V
    n_int = int((~kinds).sum())
    ints, doubles = np.empty(n_int, np.int64), np.empty(len(kinds) - n_int)
    raw = np.empty(0, np.uint64)
    p, carry, start = 0, None, 0       # next raw draw, the draw whose high half is
                                       # buffered, next kind
    i0 = d0 = 0                        # integers and uniforms done
    while start < len(kinds):
        kind = kinds[start:]
        is_int = ~kind
        nth = np.cumsum(is_int) - is_int             # integer draw's index
        low = is_int & ((nth + (carry is not None)) % 2 == 0)
        new = kind | low                             # takes a new raw draw
        at = p + np.cumsum(new) - new
        need = int(at[-1]) + 1
        if need > len(raw):
            raw = np.concatenate([raw, bitgen.random_raw(need - len(raw) + 64)])
        src = raw[np.minimum(at, len(raw) - 1)]
        # an integer draw's 64-bit source: its own new draw for a low half,
        # the previous integer draw's for a high half (or the carried one)
        i_src = src[is_int]
        i_low = low[is_int]
        prev = np.maximum.accumulate(np.where(i_low, np.arange(len(i_src)), -1))
        hi = np.where(prev >= 0, i_src[np.maximum(prev, 0)],
                      np.uint64(0 if carry is None else carry))
        x = np.where(i_low, i_src & np.uint64(0xFFFFFFFF), hi >> np.uint64(32))
        mapped = x * np.uint64(V)
        reject = (mapped & np.uint64(0xFFFFFFFF)) < np.uint64(threshold)
        cut = int(np.argmax(reject)) if reject.any() else len(x)
        # kinds before the first rejected integer draw are final
        end = int(np.flatnonzero(is_int)[cut]) if cut < len(x) else len(kind)
        ints[i0:i0 + cut] = (mapped[:cut] >> np.uint64(32)).astype(np.int64)
        dk = src[:end][kind[:end]]
        doubles[d0:d0 + len(dk)] = (dk >> np.uint64(11)) * (1.0 / 9007199254740992.0)
        i0, d0 = i0 + cut, d0 + len(dk)
        if cut == len(x):
            break
        # the rejected draw is consumed; the same kind is drawn again
        p = int(at[end]) + int(low[end])
        carry = int(src[end]) if low[end] else None
        start += end
    return ints, doubles


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
