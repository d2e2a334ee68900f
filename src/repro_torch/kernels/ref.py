"""Plain PyTorch versions of the kernels (the allclose ground truth).

Same math as ``repro/kernels/ref.py``: f32 arithmetic, ``1/sqrt(D)`` scale
(q and k's head dim; v may have its own, ``D_v``, as in the reference's
``chunked_attention``), causal ``-inf`` mask and, with ``window > 0``, the
local window's (``q - k < window``, ``chunked_attention(window=)``), output
in the input dtype;
the k-th magnitude as the DGC threshold.  The backward functions are the plain backwards of the two
forward kernels (neither TPU kernel has a backward kernel): they recompute
the forward from the saved inputs and differentiate it with autograd.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# query rows per chunk of the attention backward are chosen so that one
# chunk's f32 scores hold at most this many elements (1 GiB)
BWD_SCORE_ELEMS = 1 << 28


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
               q0: int = 0, window: int = 0, k0: int = 0) -> torch.Tensor:
    """f32 attention of q rows ``q0 .. q0 + Sq`` against keys ``k0 .. k0 + Sk``."""
    D, Sq, Sk = q.shape[-1], q.shape[2], k.shape[2]
    G = q.shape[1] // k.shape[1]
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(D)
    if causal or window > 0:
        qpos = torch.arange(q0, q0 + Sq, device=q.device)[:, None]
        kpos = torch.arange(k0, k0 + Sk, device=q.device)[None, :]
        mask = kpos <= qpos if causal else None
        if window > 0:
            near = qpos - kpos < window
            mask = near if mask is None else mask & near
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, S, D); k: (B, KH, S, D); v: (B, KH, S, D_v) -> (B, H, S, D_v):
    naive full-score attention, scaled by ``1/sqrt(D)``; ``window > 0``
    masks keys ``window`` or more positions before the query."""
    return _attention(q, k, v, causal, window=window).to(q.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_ref`` at ``(q, k, v)`` for the output
    gradient ``do``, by recomputation in f32 and autograd, in chunks of query
    rows so one chunk's scores stay under ``BWD_SCORE_ELEMS``.  Under
    ``causal`` a chunk reads only the keys up to its last row, and with a
    ``window`` only those from its first row's first, ``q0 - window + 1``.
    GQA's dk/dv are summed over the query heads of each KV head (the
    backward of ``repeat_interleave``) and accumulated over the chunks in
    f32."""
    B, H, S, _ = q.shape
    rows = max(1, min(S, BWD_SCORE_ELEMS // max(B * H * S, 1)))
    kf = k.detach().float().requires_grad_()
    vf = v.detach().float().requires_grad_()
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    with torch.enable_grad():
        for q0 in range(0, S, rows):
            q1 = min(q0 + rows, S)
            kend = q1 if causal else S
            kbeg = max(0, q0 - window + 1) if window > 0 else 0
            qc = q[:, :, q0:q1].detach().float().requires_grad_()
            o = _attention(qc, kf[:, :, kbeg:kend], vf[:, :, kbeg:kend], causal, q0,
                           window, kbeg)
            gq, gk, gv = torch.autograd.grad(o, (qc, kf, vf),
                                             do[:, :, q0:q1].float())
            dq[:, :, q0:q1] = gq
            dk += gk
            dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``rmsnorm_ref`` at ``(x, w)`` for the output gradient
    ``dy``, by recomputation in f32 and autograd."""
    xf = x.detach().float().requires_grad_()
    wf = w.detach().float().requires_grad_()
    with torch.enable_grad():
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * wf
        dx, dw = torch.autograd.grad(y, (xf, wf), dy.float())
    return dx.to(x.dtype), dw.to(w.dtype)


def fused_adam_ref(p, g, m, v, *, lr, b1, b2, eps, wd, c1, c2):
    """One AdamW pass over flat vectors -> new (p, m, v), all f32."""
    p = p.float()
    g = g.float()
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    step = (m_new / c1) / (torch.sqrt(v_new / c2) + eps) + wd * p
    return p - lr * step, m_new, v_new


def dgc_mask_ref(g: torch.Tensor, threshold
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entries with ``|g| < threshold`` zeroed (compared in f32), in g's dtype,
    and the int64 count of entries kept."""
    flat = g.reshape(-1).float()
    keep = flat.abs() >= threshold
    sparse = torch.where(keep, flat, 0.0).reshape(g.shape).to(g.dtype)
    return sparse, keep.sum()


def dgc_topk_ref(g: torch.Tensor, ratio: float
                 ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Exact top-|k|: returns (sparse gradient, k, threshold)."""
    flat = g.reshape(-1).float()
    k = max(1, int(round(ratio * flat.numel())))
    vals = torch.sort(flat.abs(), descending=True).values
    thr = vals[k - 1]
    sparse = torch.where(flat.abs() >= thr, flat, 0.0)
    return sparse.reshape(g.shape).to(g.dtype), k, thr
