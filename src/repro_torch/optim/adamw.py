"""AdamW with f32 moments over (possibly bf16) params (counterpart of
``repro/optim/adamw.py``).

Two update paths:
  * ``apply``       — the per-leaf update, a chain of PyTorch ops per leaf;
  * ``apply_fused`` — flattens params and gradients into one f32 vector each
    and runs one ``ops.fused_adam`` launch over them (the FusedAdam of paper
    §6.3; on CUDA the hand-written kernel of ``csrc/fused_adam.cu``).

State is ``{"m", "v", "count", "gnorm"}``.  Unlike the reference's, it is
updated in place: ``m`` and ``v`` are trees of views into one flat f32
buffer each (made by ``init`` or ``opt_state``), which both paths update in
place, so the fused path hands the kernel those buffers as they are, with no
copy.  ``count`` (int32) and ``gnorm`` (f32) are 0-dim device tensors, and
the learning rate and bias corrections are computed from ``count`` on the
device: nothing in an update waits for the host.  Params are not updated in
place: both paths return new param tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from repro_torch.kernels import ops

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def global_norm(tree) -> torch.Tensor:
    leaves = [l.float().square().sum() for l in tree_leaves(tree)]
    return torch.stack(leaves).sum().sqrt() if leaves else torch.zeros(())


def _flat_zeros_like(tree):
    """A tree like ``tree`` of f32 zeros, views into one flat buffer in leaf
    order."""
    leaves, spec = tree_flatten(tree)
    flat = torch.zeros(sum(l.numel() for l in leaves), dtype=torch.float32,
                       device=leaves[0].device)
    views, off = [], 0
    for l in leaves:
        views.append(flat[off:off + l.numel()].view(l.shape))
        off += l.numel()
    return tree_unflatten(views, spec)


def _flat_buffer(leaves) -> torch.Tensor:
    """The flat buffer behind the leaves of a tree made by
    ``_flat_zeros_like``, which must lie in it in the order given."""
    base = leaves[0]._base if leaves else None
    off = 0
    for l in leaves:
        if (base is None or l._base is not base
                or l.data_ptr() != base.data_ptr() + 4 * off):
            raise ValueError("AdamW state: m and v must be the flat-backed "
                             "trees made by AdamW.init or opt_state")
        off += l.numel()
    if off != base.numel():
        raise ValueError("AdamW state: m/v leaves do not cover their buffer")
    return base


def opt_state(m, v, count) -> Dict[str, Any]:
    """An AdamW state holding copies of the moment trees ``m`` and ``v`` (in
    f32, flat-backed) and the step ``count`` as an int32 0-dim tensor."""
    state = AdamW.init(m)
    tree_map(torch.Tensor.copy_, state["m"], m)
    tree_map(torch.Tensor.copy_, state["v"], v)
    state["count"].fill_(int(count))
    return state


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Schedule = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    fused: bool = False

    # ------------------------------------------------------------------ init
    @staticmethod
    def init(params) -> Dict[str, Any]:
        dev = tree_leaves(params)[0].device
        return {"m": _flat_zeros_like(params), "v": _flat_zeros_like(params),
                "count": torch.zeros((), dtype=torch.int32, device=dev),
                "gnorm": torch.zeros((), dtype=torch.float32, device=dev)}

    # ---------------------------------------------------------------- update
    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(count).float()
        return torch.full((), self.lr, dtype=torch.float32, device=count.device)

    def _constants(self, count: torch.Tensor, gnorm: torch.Tensor):
        """(clip scale, lr, c1, c2) as 0-dim f32 device tensors."""
        scale = (torch.where(gnorm > self.grad_clip,
                             self.grad_clip / gnorm.clamp_min(1e-12), 1.0)
                 if self.grad_clip else torch.ones_like(gnorm))
        c = count.float()
        return (scale, self._lr(count), 1.0 - torch.pow(self.b1, c),
                1.0 - torch.pow(self.b2, c))

    def apply(self, grads, state, params) -> Tuple[Any, Dict[str, Any]]:
        if self.fused:
            return self.apply_fused(grads, state, params)
        count = state["count"] + 1
        gnorm = global_norm(grads)
        scale, lr, c1, c2 = self._constants(count, gnorm)

        def upd(p, g, m, v):
            g = g.float() * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g.square())
            step = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            step = step + self.weight_decay * p.float()
            return (p.float() - lr * step).to(p.dtype)

        newp = tree_map(upd, params, grads, state["m"], state["v"])
        return newp, {"m": state["m"], "v": state["v"], "count": count,
                      "gnorm": gnorm}

    def apply_fused(self, grads, state, params) -> Tuple[Any, Dict[str, Any]]:
        """One fused update over one flattened vector (FusedAdam)."""
        count = state["count"] + 1
        leaves_p, spec = tree_flatten(params)

        def in_param_order(tree):
            return tree_leaves(tree_map(lambda _, t: t, params, tree))

        m_flat = _flat_buffer(in_param_order(state["m"]))
        v_flat = _flat_buffer(in_param_order(state["v"]))
        p = torch.cat([l.reshape(-1) for l in leaves_p]).float()
        g = torch.cat([l.reshape(-1) for l in in_param_order(grads)]).float()
        gnorm = g.square().sum().sqrt()
        scale, lr, c1, c2 = self._constants(count, gnorm)
        g.mul_(scale)
        p, m, v = ops.fused_adam(p, g, m_flat, v_flat, lr=lr, b1=self.b1,
                                 b2=self.b2, eps=self.eps,
                                 wd=self.weight_decay, c1=c1, c2=c2)
        if m is not m_flat:     # the plain version returns new tensors
            m_flat.copy_(m)
            v_flat.copy_(v)
        # an f32 leaf of a model with leaves of another dtype is copied out
        # of the flat vector: as a view it would keep all of it alive (one
        # f32 copy of every parameter) until the next update
        mixed = any(l.dtype != p.dtype for l in leaves_p)
        outs, off = [], 0
        for l in leaves_p:
            t = p[off:off + l.numel()].view(l.shape)
            outs.append(t.clone() if mixed and l.dtype == p.dtype else t.to(l.dtype))
            off += l.numel()
        return tree_unflatten(outs, spec), {"m": state["m"], "v": state["v"],
                                            "count": count, "gnorm": gnorm}

    @staticmethod
    def last_grad_norm(state) -> torch.Tensor:
        return state["gnorm"]


def adamw(lr: Schedule = 3e-4, **kw) -> AdamW:
    return AdamW(lr=lr, **kw)
