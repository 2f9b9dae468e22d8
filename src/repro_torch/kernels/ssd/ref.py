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
    identity steps (dt = 0: decay 1, contribution 0).  Float64 x is
    computed (and its state returned) in float64, for a check of the
    fp32 gradients against this function's exact ones."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = max(1, min(CHUNK, S))
    pad = (L - S % L) % L
    f32 = torch.promote_types(x.dtype, torch.float32)
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


def ssd_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, init_state: Optional[torch.Tensor],
                dy: torch.Tensor, dstate: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``ssd_ref`` at output gradients ``dy`` (y-shaped)
    and ``dstate`` (final-state-shaped, None for zeros), computed as the
    backward kernel (``csrc/ssd_bwd.cu``) computes them: (dx, ddt, dA,
    dBm, dCm, dinit), each in its input's dtype (dt, A and dinit fp32).
    Only the tests use it.

    Per (row, head), with a_t = e^(dt_t A), the forward is h_t = a_t
    h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t, and g_t = dL/dh_t runs
    backward: g_t = dy_t C_t^T + a_{t+1} g_{t+1}, from ``dstate``.  Over
    chunks of ``CHUNK`` steps (cum the inclusive prefix sum of dt A in the
    chunk, last its end):

    1. chunk states S_c = sum_j e^(last - cum_j) dt_j x_j B_j^T and
       gradient states D_c = sum_s e^(cum_s) dy_s C_s^T, per (chunk, head);
    2. two carries, sequential over chunks only: h_in[c] (the state
       entering chunk c, from ``init_state``) forward, and R_c (the
       gradient reaching chunk c's end from later steps, from ``dstate``)
       backward, R_{c-1} = e^(last_c) R_c + D_c; dinit = R_{-1};
    3. per (chunk, head), with E = e^(cum_i - cum_j) (j <= i), W = C B^T o
       E, M = dy x^T o E:
       u_t = sum_{s>=t} W_st dy_s + e^(last - cum_t) R B_t, dx_t = dt_t u_t;
       dC_t = e^(cum_t) h_in^T dy_t + sum_{j<=t} M_tj dt_j B_j;
       dB_t = dt_t (sum_{s>=t} M_st C_s + e^(last - cum_t) R^T x_t);
       the decays' gradient dda_t = a_t <g_t, h_{t-1}> as four sums, each
       without cancellation: z_t = sum_{i>=t} sum_{j<t} T_ij (T = W o dy
       x^T o dt_j: an exclusive prefix sum along each row, then a suffix
       sum down each column), plus sum_{k>=t} e_k (e_k = dC_inter_k . C_k,
       the inter-chunk term), plus sum_{j<t} v_j (v_j = dB_R_j . B_j, the
       chunk-end term), plus e^(last) <R, h_in>;
       ddt_t = x_t . u_t + A dda_t, dA = sum dt_t dda_t.
    dB and dC sum their per-head terms over the heads last."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = CHUNK
    nc = -(-S // L)
    pad = nc * L - S
    f32 = torch.float32
    xf, dtf, bf, cf, dyf = (t.to(f32) for t in (x, dt, Bm, Cm, dy))
    if pad:
        xf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, dyf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        bf, cf = (F.pad(t, (0, 0, 0, pad)) for t in (bf, cf))
    xc, dyc = xf.reshape(B, nc, L, H, P), dyf.reshape(B, nc, L, H, P)
    dtc = dtf.reshape(B, nc, L, H)
    bc, cc = bf.reshape(B, nc, L, N), cf.reshape(B, nc, L, N)
    Af = A.to(f32)
    cum = torch.cumsum(dtc * Af, dim=2)                          # (B,nc,L,H)
    last = cum[:, :, -1]                                          # (B,nc,H)
    to_end = torch.exp(last[:, :, None] - cum)                    # (B,nc,L,H)

    # pass 1: chunk states and gradient states
    states = torch.einsum("bcjh,bcjhp,bcjn->bchpn", dtc * to_end, xc, bc)
    gstates = torch.einsum("bcjh,bcjhp,bcjn->bchpn", torch.exp(cum), dyc, cc)

    # pass 2: the carries
    zero = x.new_zeros((B, H, P, N), dtype=f32)
    h = zero if init_state is None else init_state.to(f32)
    h_in = torch.empty_like(states)
    for c in range(nc):
        h_in[:, c] = h
        h = torch.exp(last[:, c])[..., None, None] * h + states[:, c]
    r = zero if dstate is None else dstate.to(f32)
    R = torch.empty_like(gstates)
    for c in reversed(range(nc)):
        R[:, c] = r
        r = torch.exp(last[:, c])[..., None, None] * r + gstates[:, c]
    dinit = r

    # pass 3: per chunk and head
    cg = cum.transpose(2, 3)                                      # (B,nc,H,L)
    tril = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    E = torch.exp((cg[..., :, None] - cg[..., None, :]).masked_fill(~tril, float("-inf")))
    CB = torch.einsum("bcin,bcjn->bcij", cc, bc)
    Q = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)
    W = CB[:, :, None] * E                                        # (B,nc,H,i,j)
    M = Q * E
    T = W * Q * dtc.transpose(2, 3)[..., None, :]
    RB = torch.einsum("bchpn,bcjn->bcjhp", R, bc)
    u = torch.einsum("bchst,bcshp->bcthp", W, dyc) + to_end[..., None] * RB
    dx = dtc[..., None] * u
    xu = (xc * u).sum(-1)                                         # (B,nc,L,H)
    dc_inter = torch.exp(cum)[..., None] * torch.einsum("bchpn,bcthp->bcthn", h_in, dyc)
    dC_h = dc_inter + torch.einsum("bchtj,bcjh,bcjn->bcthn", M, dtc, bc)
    e = (dc_inter * cc[:, :, :, None]).sum(-1)
    db_r = (dtc * to_end)[..., None] * torch.einsum("bchpn,bcthp->bcthn", R, xc)
    dB_h = dtc[..., None] * torch.einsum("bchst,bcsn->bcthn", M, cc) + db_r
    v = (db_r * bc[:, :, :, None]).sum(-1)
    prefix = F.pad(torch.cumsum(T[..., :-1], dim=-1), (1, 0))   # sum_{j<u} T_iu
    z = (prefix * tril).sum(-2).transpose(2, 3)               # sum_{i>=u}
    e_suffix = torch.flip(torch.cumsum(torch.flip(e, (2,)), dim=2), (2,))
    v_prefix = F.pad(torch.cumsum(v[:, :, :-1], dim=2), (0, 0, 1, 0))
    ends = torch.exp(last) * (R * h_in).sum((-2, -1))             # (B,nc,H)
    dda = z + e_suffix + v_prefix + ends[:, :, None]
    ddt = xu + Af * dda
    dA = (dtc * dda).sum((0, 1, 2))

    def rows(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(B, nc * L, *t.shape[3:])[:, :S]
    return (rows(dx).to(x.dtype), rows(ddt), dA, rows(dB_h.sum(3)).to(Bm.dtype),
            rows(dC_h.sum(3)).to(Cm.dtype), dinit)
