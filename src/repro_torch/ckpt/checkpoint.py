"""Checkpointing (counterpart of ``repro/ckpt/checkpoint.py``): atomic
commit, async save, keep-last-k, in the reference's on-disk layout.

Layout (one directory per step):

    <dir>/step_000042/
        manifest.json     tree structure, shapes, dtypes, step
        <flat.key>.npy    one array per leaf (host-gathered values)
        COMMIT            written last — a checkpoint without it is invalid

Leaf keys are the reference's: dict keys sorted (as ``jax.tree_util``
flattens them), list and tuple positions written as their index, joined by
``.``.  Leaves whose dtype ``np.save`` cannot write as-is (bfloat16, ...)
ride a float32 carrier, with their own dtype in the manifest.  So a
checkpoint of the same tree written by either package is byte-equal and
restores in the other (the trainer saves the reference's tree:
``convert.state_to_reference``).

Design points:
  * **atomic commit** — writers stage into ``step_X.tmp`` and rename; readers
    only trust directories containing COMMIT, so a mid-save crash can never
    corrupt restore state.
  * **async** — ``CheckpointManager.save_async`` copies every leaf to host
    memory synchronously and writes in a background thread, keeping the
    write off the training critical path.
  * Restores go onto one device (``restore_checkpoint(device=...)``); the
    reference's elastic re-shard onto a mesh waits for meshes in the port.

Leaves may be torch tensors (meta tensors too, for ``checkpoint_bytes`` and
as ``like``), numpy arrays or Python scalars.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "."

# dtypes np.save writes as-is; anything else (bf16/fp8/...) rides a float32
# carrier (lossless upcast) — shared by save_checkpoint and checkpoint_bytes
_SAVED_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.int8,
                 np.uint8, np.bool_, np.float16, np.uint16, np.uint32)


def _np_dtype(dtype) -> Optional[np.dtype]:
    """numpy's dtype for ``dtype`` (numpy or torch), None where numpy has
    none (torch.bfloat16 without ``ml_dtypes``)."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
        try:
            return np.dtype(name)
        except TypeError:
            return None
    return np.dtype(dtype)


def _carrier_dtype(dtype) -> np.dtype:
    dt = _np_dtype(dtype)
    return dt if dt is not None and dt in (np.dtype(d) for d in _SAVED_DTYPES) \
        else np.dtype(np.float32)


def _dtype_name(dtype) -> str:
    """The manifest's name of a leaf dtype: numpy's (``bfloat16`` for
    torch.bfloat16 as for ml_dtypes')."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(np.dtype(dtype))
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) in the reference's flattening order, or None for a
    leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree) -> List[Tuple[str, Any]]:
    out = []

    def walk(node, path):
        if node is None:        # an empty subtree, as in jax.tree_util
            return
        kids = _children(node)
        if kids is None:
            out.append((_SEP.join(path), node))
            return
        for k, v in kids:
            walk(v, path + [k])

    walk(tree, [])
    return out


def _map_with_key(fn: Callable[[str, Any], Any], tree, path=()) -> Any:
    """``tree`` with each leaf replaced by ``fn(flat key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_key(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_key(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(_SEP.join(path), tree)


def _host_array(leaf) -> np.ndarray:
    """``leaf`` as a host numpy array in its carrier dtype."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if _carrier_dtype(leaf.dtype) != _np_dtype(leaf.dtype):
            leaf = leaf.float()     # a bf16 tensor has no .numpy()
        return leaf.cpu().numpy()
    arr = np.asarray(leaf)
    carrier = _carrier_dtype(arr.dtype)
    return arr if arr.dtype == carrier else arr.astype(carrier)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Write one atomic checkpoint; returns the committed path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": {},
                                "extra": extra_meta or {}}
    for key, leaf in _flatten(tree):
        dtype = getattr(leaf, "dtype", None)
        orig_dtype = _dtype_name(dtype if dtype is not None
                                 else np.asarray(leaf).dtype)
        arr = _host_array(leaf)
        np.save(os.path.join(tmp, key + ".npy"), arr)
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": orig_dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def checkpoint_bytes(tree: Any) -> int:
    """Deterministic on-disk payload size of ``save_checkpoint(tree)``.

    Sums leaf ``shape x carrier-dtype`` over the tree using the same
    dtype-carrier rules as the save path (exotic dtypes ride a float32
    carrier), without materializing or transferring any array — meta
    tensors size the same as concrete ones.  Manifest/COMMIT bookkeeping is
    excluded: this is the number the fault simulator's RecoveryModel turns
    into restore seconds over the host DMA bandwidth.
    """
    total = 0
    for _, leaf in _flatten(tree):
        shape = getattr(leaf, "shape", None)
        if shape is None:
            shape = np.shape(leaf)
        n = 1
        for d in shape:
            n *= int(d)
        dtype = getattr(leaf, "dtype", None)
        if dtype is None:
            dtype = np.asarray(leaf).dtype
        total += n * _carrier_dtype(dtype).itemsize
    return total


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "COMMIT")):
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None,
                       device=None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (tensors, meta tensors,
    arrays): each leaf a tensor in ``like``'s dtype, on ``device``, else on
    the ``like`` leaf's device (the CPU for a non-tensor).  Returns
    (tree, step)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"checkpoint {path} is uncommitted")

    def load(key, ref):
        arr = np.load(os.path.join(path, key + ".npy"))
        dev = device if device is not None else getattr(ref, "device", "cpu")
        want = getattr(ref, "dtype", arr.dtype)
        return torch.from_numpy(arr).to(device=dev, dtype=_torch_dtype(want))

    return _map_with_key(load, like), step


def _snapshot(leaf):
    """A host copy of ``leaf`` that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class CheckpointManager:
    """Keep-last-k manager with async save."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[cf.Future] = None
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, **meta) -> str:
        path = save_checkpoint(self.directory, step, tree, meta or None)
        self._gc()
        return path

    def save_async(self, step: int, tree: Any, **meta) -> None:
        """Snapshot to host synchronously, write in the background.

        One save in flight at a time: joins the previous one first, so a
        failed background write surfaces *here* (or in :meth:`wait`) as
        its exception rather than being dropped with the worker thread.
        """
        self.wait()                      # one in flight at a time
        host_tree = _map_with_key(lambda _, x: _snapshot(x), tree)
        self._pending = self._pool.submit(self.save, step, host_tree, **meta)

    def wait(self) -> None:
        """Join the in-flight save, re-raising its exception exactly once.

        The pending future is cleared *before* ``result()`` can raise:
        a failed save must not wedge the manager by re-raising forever
        and blocking every later ``save_async``.
        """
        with self._lock:
            if self._pending is not None:
                fut, self._pending = self._pending, None
                fut.result()

    def restore_latest(self, like, device=None):
        return restore_checkpoint(self.directory, like, device=device)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n)
             for n in os.listdir(self.directory)) if m)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
