"""The plain PyTorch version of the SSD chunked scan, in model layout.

The chunked algorithm of ``repro.models.ssm.ssd_chunked`` written in
torch: quadratic, attention-like math inside chunks of ``CHUNK`` steps, a
linear recurrence of an fp32 (B, H, P, N) state across them.  The CPU path
of ``ops.ssd`` and the tests use it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card; nothing on the card's main path calls it.

``ssd_passes_ref`` is the same function computed the way the ``tc``
variant of the CUDA kernel computes it: three passes (chunk states, state
passing, chunk scan) over head groups, with the tensor cores' bf16
operands rounded where the kernel rounds them.  Only the tests use it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

#: steps per chunk of the CUDA kernel (``L`` in ``csrc/ssd.cu``); the plain
#: version chunks the same way, so the CPU and card paths sum alike
CHUNK = 64


def _segsum(z: torch.Tensor) -> torch.Tensor:
    """z (..., L) -> (..., L, L): out[i, j] = sum(z[j+1..i]) for j <= i,
    -inf above the diagonal."""
    L = z.shape[-1]
    cs = torch.cumsum(z, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=z.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor,
            init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H) post-softplus, A (H,) negative, Bm/Cm
    (B, S, N) (one group, shared by the heads), ``init_state`` (B, H, P, N)
    fp32 or None (zeros) -> (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) fp32).  S is padded to a multiple of the chunk with
    identity steps (dt = 0: decay 1, contribution 0)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = max(1, min(CHUNK, S))
    pad = (L - S % L) % L
    f32 = torch.float32
    xf, dtf, bf, cf = x.to(f32), dt.to(f32), Bm.to(f32), Cm.to(f32)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        bf = F.pad(bf, (0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, pad))
    nc = (S + pad) // L
    xc = xf.reshape(B, nc, L, H, P)
    dtc = dtf.reshape(B, nc, L, H)
    bc = bf.reshape(B, nc, L, N)
    cc = cf.reshape(B, nc, L, N)
    da = dtc * A.to(f32)
    h = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    ys = []
    for c in range(nc):
        xb, dtb, bb, cb, dab = xc[:, c], dtc[:, c], bc[:, c], cc[:, c], da[:, c]
        cum = torch.cumsum(dab, dim=1)                            # (B,L,H)
        decay = torch.exp(_segsum(dab.transpose(1, 2)))           # (B,H,L,L)
        scores = torch.einsum("bin,bjn->bij", cb, bb)             # (B,L,L)
        w = scores[:, None] * decay                               # (B,H,L,L)
        xdt = xb * dtb[..., None]                                 # (B,L,H,P)
        y_intra = torch.einsum("bhij,bjhp->bihp", w, xdt)
        y_inter = torch.einsum("bin,bhpn,bih->bihp", cb, h, torch.exp(cum))
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)            # (B,L,H)
        hc = torch.einsum("bjn,bjhp,bjh->bhpn", bb, xdt, decay_to_end)
        h = torch.exp(cum[:, -1])[:, :, None, None] * h + hc
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :S] if ys else xf.new_zeros((B, 0, H, P))
    return y.to(x.dtype), h


def _bf16(t: torch.Tensor, on: bool) -> torch.Tensor:
    """``t`` rounded to bf16 and back when ``on`` (a tensor-core operand)."""
    return t.to(torch.bfloat16).to(torch.float32) if on else t


def ssd_passes_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None, *,
                   heads_per_block: int = 4, bf16_operands: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_ref``'s function by the ``tc`` kernel's three passes, over
    chunks of ``CHUNK`` steps and groups of ``heads_per_block`` heads (the
    last group may be smaller):

    1. chunk states S_c = (x dt e^(cum_last - cum))^T B_c per (chunk, head);
    2. state passing, sequential over chunks only: h_in[c] = h, then
       h = e^(cum_last[c]) h + S_c, from ``init_state`` or zeros;
    3. chunk scan y_c = (C_c B_c^T o e^(cum_i - cum_j) dt_j, j <= i) x_c
       + e^(cum_i) C_c h_in[c]^T, C_c B_c^T once per (chunk, head group).

    ``bf16_operands`` rounds to bf16 what the kernel hands the tensor cores
    in bf16: the decayed x dt of pass 1, h_in of pass 3 and the masked
    decayed scores W of pass 3 (x, B and C are taken as they come).  The
    ragged last chunk is padded here with identity steps (dt = 0); the
    kernel masks it instead."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = CHUNK
    nc = -(-S // L)
    pad = nc * L - S
    f32 = torch.float32
    xf, dtf, bf, cf = x.to(f32), dt.to(f32), Bm.to(f32), Cm.to(f32)
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        bf = F.pad(bf, (0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, pad))
    xc = xf.reshape(B, nc, L, H, P)
    dtc = dtf.reshape(B, nc, L, H)
    bc = bf.reshape(B, nc, L, N)
    cc = cf.reshape(B, nc, L, N)
    cum = torch.cumsum(dtc * A.to(f32), dim=2)                   # (B,nc,L,H)
    last = cum[:, :, -1]                                          # (B,nc,H)
    groups = [slice(h0, min(h0 + heads_per_block, H))
              for h0 in range(0, H, heads_per_block)]

    # pass 1: chunk states, parallel over (row, chunk, head group)
    states = x.new_empty((B, nc, H, P, N), dtype=f32)
    for hs in groups:
        scale = dtc[..., hs] * torch.exp(last[:, :, None, hs] - cum[..., hs])
        xs = _bf16(xc[..., hs, :] * scale[..., None], bf16_operands)
        states[:, :, hs] = torch.einsum("bcjhp,bcjn->bchpn", xs, bc)

    # pass 2: state passing, sequential over chunks
    h = (x.new_zeros((B, H, P, N), dtype=f32) if init_state is None
         else init_state.to(f32))
    h_in = torch.empty_like(states)
    for c in range(nc):
        h_in[:, c] = h
        h = torch.exp(last[:, c])[..., None, None] * h + states[:, c]
    h_op = _bf16(h_in, bf16_operands)

    # pass 3: chunk scan, parallel over (row, chunk, head group)
    tril = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    y = x.new_empty((B, nc, L, H, P), dtype=f32)
    for hs in groups:
        scores = torch.einsum("bcin,bcjn->bcij", cc, bc)          # shared by the group
        cg = cum[..., hs].transpose(2, 3)                         # (B,nc,h,L)
        seg = (cg[..., :, None] - cg[..., None, :]).masked_fill(~tril, float("-inf"))
        w = scores[:, :, None] * torch.exp(seg) * dtc[..., hs].transpose(2, 3)[..., None, :]
        w = _bf16(w, bf16_operands)                               # (B,nc,h,i,j)
        y_intra = torch.einsum("bchij,bcjhp->bcihp", w, xc[..., hs, :])
        y_inter = (torch.einsum("bcin,bchpn->bcihp", cc, h_op[:, :, hs])
                   * torch.exp(cum[..., hs])[..., None])
        y[..., hs, :] = y_intra + y_inter
    return y.reshape(B, nc * L, H, P)[:, :S].to(x.dtype), h
