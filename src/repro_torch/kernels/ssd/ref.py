"""The plain PyTorch version of the SSD chunked scan, in model layout.

The chunked algorithm of ``repro.models.ssm.ssd_chunked`` written in
torch: quadratic, attention-like math inside chunks of ``CHUNK`` steps, a
linear recurrence of an fp32 (B, H, P, N) state across them.  The CPU path
of ``ops.ssd`` and the tests use it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card; nothing on the card's main path calls it.
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
