"""Mamba-2 (SSD, state-space duality) block: chunked train scan and O(1)
decode (counterpart of ``repro/models/ssm.py``).

The reference's simplifications are kept: one group (B and C shared across
heads), the short causal conv on the x branch only, and the gate normalised
as RMSNorm(y * silu(z)), which runs the RMSNorm kernel.  The SSD chunked scan
is plain PyTorch, as the reference leaves it to XLA (no ``pallas_call``).

Two differences from the reference's code, neither a change of function:

* **No loop over chunks.**  The reference's ``lax.scan`` body computes the
  intra-chunk term, the chunk's decays and its contribution ``U`` to the
  state once per chunk.  None of these depends on the carried state, so here
  they are computed for a block of chunks at once, and the recurrence
  ``state = state * a + U`` is taken in closed form: the states entering the
  block's chunks are one batched product of the contributions with their
  decays (``_segsum`` of the chunks' log-decays, as in the Mamba-2 paper's
  state passing).  A Python loop over the chunks launched ~5 kernels a chunk
  forward and backward, 32 chunks a layer at 4096 tokens, and left the train
  step host-bound.  A block holds at most ``SSD_BLOCK_CHUNKS`` chunks (8192
  tokens at the config's chunk of 128): a longer prefill loops over blocks,
  the state carried from one to the next, so its memory grows linearly in
  the length, not with the square of the chunk count.  The five input
  projections are one product over the concatenated weights and the causal
  conv one grouped ``conv1d``, for the same reason: on an H100 80GB HBM3
  (700 W) the one product took 1.56-1.57 ms forward and backward at
  1 x 4096 against the five's 2.13-2.37 ms, both paced by the host, 3.6-6.3%
  of the 32-layer train step (``chip_smoke.py``'s ssm phase prints the
  pair).  Decode keeps the
  reference's separate products: a concatenation there would write the
  weights once a token.
* **The masked exponential.**  The reference computes
  ``where(causal, exp(seg), 0)``: above the diagonal ``seg`` sums up to
  ``chunk - 1`` positive decay terms, overflows float32 at the config's chunk
  of 128, and the gradient of the hidden ``inf`` is ``0 * inf = NaN``.  Here
  ``L = exp(where(causal, seg, -inf))``: the same loss, the same gradients
  wherever the reference's are finite, and finite ones where they are not
  (ROADMAP C21, ``tests/test_torch_ssm.py``).

``softplus`` is ``F.softplus``, which returns its input above 20 where the
reference's is exact everywhere: they differ there by less than 2e-9.
Dtypes are the reference's: ``dt``, the cumulative decays, ``seg``, ``L``
and the scores in float32; ``M``, ``Xe``, the decays into and out of a chunk
and the state in the input's dtype.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .layers import rmsnorm, rmsnorm_init
from .paramdecl import normal_param, ones_param, zeros_param

Params = Dict[str, torch.Tensor]

CONV_K = 4         # short depthwise conv kernel width
HEAD_P = 64        # SSD head dim
SSD_BLOCK_CHUNKS = 64   # chunks in one closed form; more go block by block


def mamba2_init(gen, d: int, d_state: int, dtype, *, expand: int = 2) -> Params:
    d_inner = expand * d
    n_heads = d_inner // HEAD_P
    return {
        "wz": normal_param(gen, (d, d_inner), dtype),
        "wx": normal_param(gen, (d, d_inner), dtype),
        "wB": normal_param(gen, (d, d_state), dtype),
        "wC": normal_param(gen, (d, d_state), dtype),
        "w_dt": normal_param(gen, (d, n_heads), dtype),
        "dt_bias": zeros_param(gen, (n_heads,), torch.float32),
        "A_log": zeros_param(gen, (n_heads,), torch.float32),
        "D": ones_param(gen, (n_heads,), torch.float32),
        "conv": normal_param(gen, (CONV_K, d_inner), dtype, scale=0.5),
        "norm": rmsnorm_init(gen, d_inner, dtype),
        "w_out": normal_param(gen, (d_inner, d), dtype),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, ``out_t = sum_i kernel[K-1-i] * x_{t-i}`` with
    zeros before the start (the reference's shifted adds), as one grouped
    ``conv1d``.  x: (B,S,D); kernel: (K,D)."""
    K, D = kernel.shape
    y = F.conv1d(x.transpose(1, 2), kernel.T[:, None, :], padding=K - 1, groups=D)
    return y[..., :x.shape[1]].transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _upper(T: int, device: torch.device, diagonal: int) -> torch.Tensor:
    """The (T, T) mask ``j - i >= diagonal`` on ``device``, made once and
    outside inference mode (a training step saves it for its backward)."""
    with torch.inference_mode(False):
        return torch.ones((T, T), dtype=torch.bool, device=device).triu(diagonal)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (B, H, T) -> (B, H, T, T), ``[i, j] = sum_{j<k<=i} a_k`` for
    ``j <= i`` and ``-inf`` above the diagonal: cumulative sums of the
    masked terms, so no difference of two large sums is taken."""
    T = a.shape[-1]
    terms = a[..., :, None].expand(-1, -1, T, T).masked_fill(
        _upper(T, a.device, 0), 0.0)                        # [k, j] = a_k, k > j
    return terms.cumsum(-2).masked_fill(_upper(T, a.device, 1), float("-inf"))


def _dt(p: Params, x: torch.Tensor) -> torch.Tensor:
    """softplus(x . w_dt + dt_bias) in float32: (..., d) -> (..., H)."""
    return F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])


def _ssd_block(Xec, Bc, Cc, dAc, state0):
    """The SSD scan over one block of chunks, without the skip term.
    Xec: (B, nc, Q, H, P) dt-scaled input; Bc, Cc: (B, nc, Q, N); dAc:
    (B, nc, Q, H) float32 log-decays; state0: (B, H, N, P) entering the
    block, or None for zeros.  -> (y (B, nc, Q, H, P), the state after the
    block (B, H, N, P))."""
    B_, nc, Q, H, P = Xec.shape
    N = Bc.shape[-1]
    dtype = Xec.dtype
    cum = dAc.cumsum(2)                                       # (B,nc,Q,H) f32
    # intra-chunk (attention-like) term, every chunk at once, heads before
    # positions: L[i, j] = exp(cum_i - cum_j) for j <= i
    cum_h = cum.transpose(2, 3)                               # (B,nc,H,Q)
    seg = cum_h[..., :, None] - cum_h[..., None, :]           # (B,nc,H,Q,Q) i,j
    L = torch.exp(seg.masked_fill(_upper(Q, Xec.device, 1), float("-inf")))
    scores = Cc.float() @ Bc.float().transpose(-1, -2)        # (B,nc,Q,Q) f32
    M = (scores[:, :, None] * L).to(dtype)
    y_intra = M @ Xec.transpose(2, 3)                         # (B,nc,H,Q,P)
    # each chunk's decay over its length and its contribution to the state,
    # U[n, (h, p)] = sum_j B_j[n] Xe_j[h, p] w_j[h]
    last = cum[:, :, -1:]                                     # (B,nc,1,H)
    w = torch.exp(last - cum).to(dtype)                       # decay j..end
    U = Bc.transpose(-1, -2) @ (Xec * w[..., None]).reshape(B_, nc, Q, H * P)
    # the state recurrence in closed form: the state entering chunk c (and
    # after the last, c = nc) is exp(A_0+...+A_{c-1}) state0 +
    # sum_{z<c} exp(A_{z+1}+...+A_{c-1}) U_z, A_k the chunks' log-decays;
    # one batched product over the chunks
    A = F.pad(last[:, :, 0].transpose(1, 2), (1, 0))          # (B,H,nc+1): 0, A_0..
    Uh = U.reshape(B_, nc, N, H, P).permute(0, 3, 1, 2, 4).reshape(B_, H, nc, N * P)
    if state0 is None:
        states = torch.exp(_segsum(A)[..., 1:]).to(dtype) @ Uh
    else:
        states = torch.exp(_segsum(A)).to(dtype) @ torch.cat(
            [state0.reshape(B_, H, 1, N * P), Uh], 2)
    states = states.reshape(B_, H, nc + 1, N, P)              # (B,H,nc+1,N,P)
    # inter-chunk term from the states entering the chunks
    entering = states[:, :, :nc].permute(0, 2, 3, 1, 4).reshape(B_, nc, N, H * P)
    decay_in = torch.exp(cum).to(dtype)                       # (B,nc,Q,H)
    y_inter = (Cc @ entering).reshape(B_, nc, Q, H, P) * decay_in[..., None]
    return y_intra.transpose(2, 3) + y_inter, states[:, :, nc]


def mamba2_forward(p: Params, x: torch.Tensor, *, chunk: int = 128,
                   return_state: bool = False):
    """x: (B, S, d) -> (B, S, d) via the SSD chunked algorithm; with
    ``return_state`` also the decode cache ``{"conv": the last CONV_K - 1
    pre-conv rows (left-padded with zeros), "state": (B, H, P, N)}``."""
    with record_function("ssm"):
        B_, S, _ = x.shape
        d_inner = p["wx"].shape[-1]
        H = d_inner // HEAD_P
        N = p["wB"].shape[-1]
        # the five input projections as one product (the same columns)
        w_in = torch.cat([p["wz"], p["wx"], p["wB"], p["wC"], p["w_dt"]], 1)
        z, xb_pre, Bm, Cm, dt_in = (x @ w_in).split([d_inner, d_inner, N, N, H], -1)
        xb = F.silu(_causal_conv(xb_pre, p["conv"]))
        dt = F.softplus(dt_in.float() + p["dt_bias"])         # (B,S,H) f32
        dA = dt * -torch.exp(p["A_log"])                      # log-decay
        X = xb.reshape(B_, S, H, HEAD_P)
        Xe = X * dt[..., None].to(X.dtype)                    # dt-scaled input

        Q = min(chunk, S)
        nc = -(-S // Q)
        pad = nc * Q - S

        def chunks(t):
            """(B, S, ...) -> (B, nc, Q, ...); padded steps are zeros, so
            they neither decay the state nor add to it."""
            if pad:
                t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
            return t.reshape((B_, nc, Q) + t.shape[2:])

        Xc, Xec, Bc, Cc, dAc = map(chunks, (X, Xe, Bm, Cm, dA))
        ys, state = [], None
        for c0 in range(0, nc, SSD_BLOCK_CHUNKS):
            blk = slice(c0, c0 + SSD_BLOCK_CHUNKS)
            y, state = _ssd_block(Xec[:, blk], Bc[:, blk], Cc[:, blk], dAc[:, blk], state)
            ys.append(y)
        Y = (ys[0] if len(ys) == 1 else torch.cat(ys, 1)) \
            + Xc * p["D"][:, None].to(x.dtype)
        Y = Y.reshape(B_, nc * Q, d_inner)[:, :S]
        Y = rmsnorm(p["norm"], Y * F.silu(z))
        out = Y @ p["w_out"]
        if not return_state:
            return out
        tail = F.pad(xb_pre, (0, 0, CONV_K - 1, 0))[:, S:S + CONV_K - 1]
        return out, {"conv": tail, "state": state.transpose(-1, -2).contiguous()}


def mamba2_decode(p: Params, x: torch.Tensor, cache: Params
                  ) -> Tuple[torch.Tensor, Params]:
    """One-token step.  x: (B, 1, d); cache: {"conv": (B, K-1, d_inner),
    "state": (B, H, P, N)}.  O(1) in sequence length."""
    with record_function("ssm"):
        B_ = x.shape[0]
        d_inner = p["wx"].shape[-1]
        H = d_inner // HEAD_P
        x0 = x[:, 0]
        z = x0 @ p["wz"]
        xb = x0 @ p["wx"]                                     # (B, d_inner)
        window = torch.cat([cache["conv"], xb[:, None]], 1)
        conv_out = torch.einsum("bke,ke->be", window, p["conv"].to(window.dtype))
        xb = F.silu(conv_out)
        Bt = x0 @ p["wB"]
        Ct = x0 @ p["wC"]
        dt = _dt(p, x0)                                       # (B,H) f32
        a = torch.exp(dt * -torch.exp(p["A_log"])).to(cache["state"].dtype)
        X = xb.reshape(B_, H, HEAD_P)
        Xe = X * dt[..., None].to(X.dtype)
        state = torch.addcmul(torch.einsum("bn,bhp->bhpn", Bt, Xe),
                              cache["state"], a[:, :, None, None])
        y = torch.einsum("bn,bhpn->bhp", Ct, state) \
            + X * p["D"][None, :, None].to(X.dtype)
        y = rmsnorm(p["norm"], y.reshape(B_, d_inner) * F.silu(z))
        out = (y @ p["w_out"])[:, None, :]
        return out, {"conv": window[:, 1:], "state": state}


def mamba2_cache_spec(batch: int, d: int, d_state: int, *, expand: int = 2
                      ) -> Dict[str, Tuple[int, ...]]:
    """One layer's decode cache shapes: constant in the sequence length."""
    d_inner = expand * d
    return {"conv": (batch, CONV_K - 1, d_inner),
            "state": (batch, d_inner // HEAD_P, HEAD_P, d_state)}
