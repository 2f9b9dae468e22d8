"""The plain PyTorch version of the RG-LRU scan, and a sequential oracle.

``rglru_blocked`` is the TPU kernel's own algorithm
(``repro.kernels.rglru.kernel._rglru_kernel``) written in torch: inside a
block of ``BLOCK_T`` steps, per feature lane,

    h_i = exp(cum_i) h_prev + sum_{j<=i} exp(cum_i - cum_j) b_j,
    cum = cumsum(log max(a, 1e-37)),

an (L x L) masked decay-weighted sum, with the state carried from block to
block.  The CUDA kernels scan step by step (in 32-step chunks with a
look-back over time in the ``chunked`` variant) instead, so holding one
against the other on the card compares two formulations.  The CPU path of
``ops.rglru`` and the tests use it; nothing on the card's main path does.

``rglru_sequential`` is the per-step recurrence of
``repro.kernels.rglru.ref.rglru_ref``, kept for the tests.
``rglru_chunked_ref`` is the CUDA ``chunked`` variant's algorithm (chunk
aggregates, carry-in over chunks, rescan), also for the tests only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

#: steps per block, the TPU kernel's default ``block_t``
BLOCK_T = 16


def gated_input(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """b = sqrt(max(1 - a^2, 1e-12)) * x in fp32 (``rglru/ops.py:50``)."""
    a = a.float()
    return torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * x.float()


def rglru_blocked(x: torch.Tensor, a: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x, a (B, S, D), ``init_state`` (B, D) fp32 or None (zeros) -> h
    (B, S, D) fp32 with h_t = a_t h_{t-1} + sqrt(1 - a_t^2) x_t.  S is
    padded to a multiple of the block with identity steps (a = 1, b = 0)."""
    B, S, D = x.shape
    b = gated_input(x, a)
    af = a.float()
    L = BLOCK_T
    pad = (L - S % L) % L
    if pad:
        af = F.pad(af, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    nb = (S + pad) // L
    cum = torch.cumsum(torch.log(torch.clamp(af, min=1e-37)).reshape(B, nb, L, D), dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B, nb, i, j, D)
    lower = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    # the mask first: exp(seg) above the diagonal may be inf, and inf * 0
    # would be NaN
    w = torch.where(lower[:, :, None], torch.exp(seg), 0.0)
    local = torch.einsum("bnijd,bnjd->bnid", w, b.reshape(B, nb, L, D))
    decay = torch.exp(cum)
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    out = []
    for n in range(nb):
        hb = local[:, n] + decay[:, n] * h[:, None]
        h = hb[:, -1]
        out.append(hb)
    if not out:
        return b.new_zeros((B, 0, D))
    return torch.cat(out, dim=1)[:, :S]


def rglru_sequential(a: torch.Tensor, b: torch.Tensor,
                     init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b (B, S, D) -> h fp32 with h_t = a_t h_{t-1} + b_t, h_{-1} =
    ``init_state`` (zeros when None)."""
    B, S, D = a.shape
    h = (torch.zeros((B, D), dtype=torch.float32, device=a.device)
         if init_state is None else init_state.float())
    hs = []
    for t in range(S):
        h = a[:, t].float() * h + b[:, t].float()
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else a.new_zeros((B, 0, D), dtype=torch.float32)


def _chunked(t: torch.Tensor, chunk: int, fill: float) -> torch.Tensor:
    """(B, S, D) -> (B, n_chunks, chunk, D), the last chunk filled with
    ``fill`` (identity steps: a = 1, b = 0)."""
    B, S, D = t.shape
    nc = math.ceil(S / chunk)
    return F.pad(t, (0, 0, 0, nc * chunk - S), value=fill).reshape(B, nc, chunk, D)


def chunk_aggregates(a: torch.Tensor, b: torch.Tensor, chunk: int):
    """Each chunk's scan from a zero state, as the ``chunked`` kernel's
    first step: a, b (B, S, D) -> (A, H) (B, n_chunks, D), A = prod a_t (a
    direct product, so it may underflow to 0) and H the local end state."""
    a4, b4 = _chunked(a.float(), chunk, 1.0), _chunked(b.float(), chunk, 0.0)
    A = torch.ones_like(a4[:, :, 0])
    H = torch.zeros_like(A)
    for u in range(chunk):
        H = a4[:, :, u] * H + b4[:, :, u]
        A = A * a4[:, :, u]
    return A, H


def rglru_chunked_ref(x: torch.Tensor, a: torch.Tensor,
                      init_state: Optional[torch.Tensor] = None,
                      chunk: int = 32) -> torch.Tensor:
    """The ``chunked`` kernel's algorithm: x, a (B, S, D), ``init_state``
    (B, D) or None -> h (B, S, D) fp32.  Time is cut into chunks of
    ``chunk`` steps (the last one ragged, filled with identity steps); each
    chunk's aggregate comes from ``chunk_aggregates``; the carry-in of
    chunk c is the aggregates of chunks 0 .. c-1 applied to
    ``init_state`` in order; each chunk is scanned again from its
    carry-in."""
    B, S, D = x.shape
    b = gated_input(x, a)
    A, H = chunk_aggregates(a, b, chunk)
    carry = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    carries = []
    for c in range(A.shape[1]):
        carries.append(carry)
        carry = A[:, c] * carry + H[:, c]
    a4, b4 = _chunked(a.float(), chunk, 1.0), _chunked(b, chunk, 0.0)
    s = torch.stack(carries, dim=1)
    out = []
    for u in range(chunk):
        s = a4[:, :, u] * s + b4[:, :, u]
        out.append(s)
    return torch.stack(out, dim=2).reshape(B, -1, D)[:, :S]


def rglru_bwd_ref(x: torch.Tensor, a: torch.Tensor, h: torch.Tensor,
                  init_state: Optional[torch.Tensor], dh: torch.Tensor,
                  dh_last: Optional[torch.Tensor]):
    """The gradients of ``rglru_blocked`` (output h, and its last step a
    second time) at ``dh`` and ``dh_last`` (None for zeros), computed as
    the backward kernel (``csrc/rglru_bwd.cu``) computes them, by the
    reverse recurrence over the forward's output ``h``: (dx, da, dinit)
    fp32.  With s(a) = sqrt(max(1 - a^2, 1e-12)), g_t = dh_t + a_{t+1}
    g_{t+1} (plus ``dh_last`` at the last step), dx_t = g_t s(a_t), da_t =
    g_t h_{t-1} + g_t x_t s'(a_t), s'(a) = -a / s(a) where 1 - a^2 >
    1e-12 and 0 elsewhere, dinit = a_0 g_0.  Only the tests use it."""
    B, S, D = x.shape
    xf, af = x.float(), a.float()
    one = 1.0 - af * af
    s = torch.sqrt(torch.clamp(one, min=1e-12))
    ds = torch.where(one > 1e-12, -af / s, torch.zeros_like(af))
    h0 = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    h_prev = torch.cat([h0[:, None], h.float()[:, :-1]], dim=1)
    g = torch.zeros_like(h0) if dh_last is None else dh_last.float().clone()
    dx, da = torch.empty_like(xf), torch.empty_like(af)
    for t in reversed(range(S)):
        g = g + dh[:, t].float()
        dx[:, t] = g * s[:, t]
        da[:, t] = g * h_prev[:, t] + g * xf[:, t] * ds[:, t]
        g = af[:, t] * g
    return dx, da, g
