"""Plain PyTorch version of the flash-attention kernel.

The materialised-scores formulation of ``repro.kernels.flash_attention.ref.
attention_ref``, generalised to what the model path needs: the reference
layout (B, S, H, D) with GQA by kv head ``h // G``, per-row (B,)
``q_offset`` and ``kv_len``, the ``causal`` / ``local`` / ``full`` /
``prefix`` masks, ``softcap`` and an explicit scale.  Math is fp32 with
the additive -1e30 mask convention of ``repro.models.layers._mask_bias``,
so a fully masked row gives a uniform softmax rather than NaN.

``ops.flash_attention`` takes this path for tensors on the CPU; on the
card it is the version the CUDA kernel is held against.
``attention_bwd_ref`` is the plain backward (FlashAttention-2's formulas),
the version the backward kernel is held against; the CPU path
differentiates ``attention_ref`` by autograd instead.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.kernels.flash_attention.kernel import BWD_TILE, bwd_rows_seeing

NEG_INF = -1e30

MASKS = ("full", "causal", "local", "prefix")

IntOrRows = Union[int, torch.Tensor]


def _rows(x: IntOrRows, device) -> torch.Tensor:
    """A scalar or (B,) position argument as a tensor that broadcasts over
    (B, Sq, Sk) once indexed as ``[:, None, None]``."""
    t = torch.as_tensor(x, device=device)
    return t.reshape(-1) if t.ndim else t.reshape(1)


def allowed_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, mask_type: str,
                 window: int, prefix_len: int) -> torch.Tensor:
    """Boolean visibility of key positions ``k_pos`` (Sk,) from query
    positions ``q_pos`` (..., Sq): shape (..., Sq, Sk)."""
    qp = q_pos[..., :, None]
    kp = k_pos
    if mask_type == "full":
        return torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                          dtype=torch.bool, device=kp.device)
    if mask_type == "causal":
        return kp <= qp
    if mask_type == "local":
        return (kp <= qp) & (kp > qp - window)
    if mask_type == "prefix":
        return (kp <= qp) | (kp < prefix_len)
    raise ValueError(f"unknown mask_type {mask_type!r} (known: {MASKS})")


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mask_type: str = "causal", window: int = 0,
                  prefix_len: int = 0, q_offset: IntOrRows = 0,
                  kv_len: Optional[IntOrRows] = None,
                  softmax_scale: Optional[float] = None,
                  softcap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, D), k (B, Sk, K, D), v (B, Sk, K, Dv) -> (B, Sq, H, Dv)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"H={H} is not a multiple of K={K}")
    G = H // K
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    kv_head = torch.arange(H, device=dev) // G
    qf = q.float() * scale
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()[:, :, kv_head])
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = _rows(q_offset, dev)[:, None] + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    vis = allowed_mask(q_pos, k_pos, mask_type, window, prefix_len)
    bias = torch.where(vis, 0.0, NEG_INF)
    if kv_len is not None:
        lim = _rows(kv_len, dev)[:, None, None]
        bias = bias + torch.where(k_pos < lim, 0.0, NEG_INF)
    s = s + bias[:, None]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()[:, :, kv_head])
    return o.to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *,
                      mask_type: str = "causal", window: int = 0,
                      prefix_len: int = 0, q_offset: IntOrRows = 0,
                      kv_len: Optional[IntOrRows] = None,
                      softmax_scale: Optional[float] = None,
                      softcap: float = 0.0):
    """(dq, dk, dv) of ``attention_ref`` at output ``o`` and output
    gradient ``do``, by the FlashAttention-2 formulas and not by autograd:
    P = e^(s - lse), dv = sum_q P^T do, dP = do v^T, dS = P (dP - delta)
    with delta = rowsum(do * o) (times 1 - tanh^2(s / cap) under a
    softcap), dq = scale dS k, dk = scale sum_q dS^T q.  GQA sums dk and dv
    over the G query heads of each kv head.  fp32 math, gradients in the
    inputs' dtypes.  The backward kernel is held against it on the card."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    kv_head = torch.arange(H, device=dev) // G
    qf = q.float() * scale
    kf, vf = k.float()[:, :, kv_head], v.float()[:, :, kv_head]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = t * softcap
    q_pos = _rows(q_offset, dev)[:, None] + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    bias = torch.where(allowed_mask(q_pos, k_pos, mask_type, window, prefix_len),
                       0.0, NEG_INF)
    if kv_len is not None:
        bias = bias + torch.where(k_pos < _rows(kv_len, dev)[:, None, None],
                                  0.0, NEG_INF)
    s = s + bias[:, None]
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]   # (B, H, Sq, 1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta)
    if softcap > 0:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Sk, K, G, D).sum(3)
    dv = dv.reshape(B, Sk, K, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The split-KV (flash-decoding) algorithm of the kernel's ``split`` variant,
# in plain PyTorch: used by the tests, never by the op.
# ---------------------------------------------------------------------------

SPLIT_TILE = 32   # keys per tile of the split kernel; a split is a multiple


def split_ranges(q_offset: int, kv_len: int, Sq: int, Sk: int, mask_type: str,
                 window: int, prefix_len: int, n_split: int):
    """The key range [lo, hi) of each of ``n_split`` splits of one batch
    row, as the split kernel computes it: the range any of the row's Sq
    queries can see (``kv_len``, then the mask), cut into equal chunks of
    whole tiles.  Trailing splits may be empty (lo >= hi)."""
    q_hi = q_offset + Sq - 1
    end = min(kv_len, Sk)
    if mask_type in ("causal", "local"):
        end = min(end, q_hi + 1)
    elif mask_type == "prefix":
        end = min(end, max(q_hi + 1, prefix_len))
    beg = max(0, q_offset - window + 1) if mask_type == "local" else 0
    per_split = -(-max(end - beg, 0) // n_split)
    chunk = -(-per_split // SPLIT_TILE) * SPLIT_TILE
    return [(beg + i * chunk, min(end, beg + (i + 1) * chunk))
            for i in range(n_split)]


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        n_split: int, mask_type: str = "causal",
                        window: int = 0, prefix_len: int = 0,
                        q_offset: IntOrRows = 0,
                        kv_len: Optional[IntOrRows] = None,
                        softmax_scale: Optional[float] = None,
                        softcap: float = 0.0) -> torch.Tensor:
    """``attention_ref`` computed as the split kernel does: each split of
    each row's key range gives a partial (m, l, acc) in fp32, with masked
    keys at -1e30 and keys outside the split at -inf (so an empty split
    has m = -1e30, l = 0, acc = 0); then O = sum e^(m_i - M) acc_i /
    sum e^(m_i - M) l_i.  Equal to ``attention_ref`` on every row that
    sees at least one key."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    dev = q.device
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    kv_head = torch.arange(H, device=dev) // G
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale,
                     k.float()[:, :, kv_head])
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    qo = _rows(q_offset, dev).expand(B)
    kl = _rows(Sk if kv_len is None else kv_len, dev).expand(B)
    q_pos = qo[:, None] + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    vis = allowed_mask(q_pos, k_pos, mask_type, window, prefix_len)
    vis = vis & (k_pos < kl[:, None, None])
    s = torch.where(vis[:, None], s, NEG_INF)
    vf = v.float()[:, :, kv_head]
    ms, ls, accs = [], [], []
    ranges = [split_ranges(int(qo[b]), int(kl[b]), Sq, Sk, mask_type, window,
                           prefix_len, n_split) for b in range(B)]
    for i in range(n_split):
        inside = torch.stack([(k_pos >= ranges[b][i][0]) & (k_pos < ranges[b][i][1])
                              for b in range(B)])
        si = torch.where(inside[:, None, None], s, -math.inf)
        m = torch.clamp(si.amax(-1), min=NEG_INF)
        p = torch.exp(si - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhqk,bkhd->bqhd", p, vf))
    m_all = torch.stack(ms)                              # (n, B, H, Sq)
    w = torch.exp(m_all - m_all.amax(0))
    den = (w * torch.stack(ls)).sum(0).clamp(min=1e-30)  # (B, H, Sq)
    num = (w.permute(0, 1, 3, 2)[..., None] * torch.stack(accs)).sum(0)
    return (num / den.transpose(1, 2)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# The tensor-core backward's algorithm (the ``tc`` variant of
# ``csrc/flash_attention_bwd.cu``), in plain PyTorch: used by the tests,
# never by the op.  Its tiles and the rows that see a key block are the
# kernel plan's (``kernel.BWD_TILE``, ``kernel.bwd_rows_seeing``).
# ---------------------------------------------------------------------------

BWD_QCHUNK = 16    # row tiles per dk/dv block (one query chunk)


def bwd_key_range(q_lo: int, q_hi: int, klim: int, mask_type: str, window: int,
                   prefix_len: int):
    """The keys [beg, end) queries q_lo..q_hi see, beg rounded down to a
    tile (the kernel's ``key_range``)."""
    end = klim
    if mask_type in ("causal", "local"):
        end = min(end, q_hi + 1)
    elif mask_type == "prefix":
        end = min(end, max(q_hi + 1, prefix_len))
    beg = max(0, q_lo - window + 1) // BWD_TILE * BWD_TILE if mask_type == "local" else 0
    return beg, end


def attention_bwd_tiles_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, do: torch.Tensor, *,
                            mask_type: str = "causal", window: int = 0,
                            prefix_len: int = 0, q_offset: int = 0,
                            kv_len: Optional[int] = None,
                            softmax_scale: Optional[float] = None,
                            softcap: float = 0.0, bf16_products: bool = False,
                            qchunk: int = BWD_QCHUNK):
    """``attention_bwd_ref`` computed as the ``tc`` backward does, on
    packed rows p = qi G + (h % G) of each (row, kv head):

    1. lse by an online max and sum over the 64-key tiles each 64-row
       tile sees, and delta = rowsum(do o);
    2. per 64-key block, in the transposed orientation: the rows that see
       the block cut into chunks of ``qchunk`` 64-row tiles; per tile
       S^T = K Q^T, P^T = e^(S^T - lse), dP^T = V dO^T,
       dS^T = P^T (1 - tanh^2) (dP^T - delta); dV += P^T dO and
       dK += dS^T Q per chunk (dk times scale), then the chunks summed in
       order;
    3. per 64-row tile over its visible 64-key tiles: dQ += dS K, times
       scale.

    fp32 math.  ``bf16_products`` rounds P and dS to bf16 where the kernel
    does (the A operands of the dV, dK and dQ products).  Scalar
    ``q_offset`` and ``kv_len`` only; every query must see a key."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G, R, T = H // K, Sq * (H // K), BWD_TILE
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    klim = Sk if kv_len is None else min(int(kv_len), Sk)
    dev = q.device

    def packed(x):   # (B, Sq, H, D) -> (B, K, R, D)
        return x.float().reshape(B, Sq, K, G, D).permute(0, 2, 1, 3, 4).reshape(B, K, R, D)

    Q, dO = packed(q), packed(do)
    Kf, Vf = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)
    qpos = q_offset + torch.arange(R, device=dev) // G
    kpos = torch.arange(Sk, device=dev)
    vis = allowed_mask(qpos, kpos, mask_type, window, prefix_len) & (kpos < klim)
    rnd = (lambda x: x.bfloat16().float()) if bf16_products else (lambda x: x)   # noqa: E731

    def scores(a, b):   # (logits, 1 - tanh^2 or None)
        s = torch.einsum("bkrd,bkcd->bkrc", a, b) * scale
        if softcap > 0:
            t = torch.tanh(s / softcap)
            return t * softcap, 1.0 - t * t
        return s, None

    delta = (dO * packed(o)).sum(-1)                       # (B, K, R)
    lse = torch.empty(B, K, R, device=dev)
    dq = torch.zeros(B, K, R, D, device=dev)
    for p0 in range(0, R, T):
        rows = slice(p0, min(p0 + T, R))
        q_lo, q_hi = int(qpos[rows][0]), int(qpos[rows][-1])
        beg, end = bwd_key_range(q_lo, q_hi, klim, mask_type, window, prefix_len)
        m = torch.full((B, K, rows.stop - p0), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        for k0 in range(beg, end, T):                       # pass 1: online lse
            keys = slice(k0, min(k0 + T, Sk))
            s, _ = scores(Q[:, :, rows], Kf[:, :, keys])
            s = torch.where(vis[rows, keys], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
            m = m_new
        lse[:, :, rows] = m + torch.log(l)
        for k0 in range(beg, end, T):                       # pass 3: dq
            keys = slice(k0, min(k0 + T, Sk))
            s, dt = scores(Q[:, :, rows], Kf[:, :, keys])
            p = torch.where(vis[rows, keys], torch.exp(s - lse[:, :, rows, None]), 0.0)
            dp = torch.einsum("bkrd,bkcd->bkrc", dO[:, :, rows], Vf[:, :, keys])
            ds = (p if dt is None else p * dt) * (dp - delta[:, :, rows, None])
            dq[:, :, rows] += rnd(ds) @ Kf[:, :, keys]
    dk, dv = torch.zeros_like(Kf), torch.zeros_like(Vf)
    for k0 in range(0, Sk, T):                              # pass 2: dk, dv
        keys = slice(k0, min(k0 + T, Sk))
        lo, hi = bwd_rows_seeing(k0, keys.stop - k0, Sq, G, q_offset, klim, mask_type,
                                  window, prefix_len)
        parts = []
        for c_lo in range(lo, hi, qchunk * T):
            c_hi = min(hi, c_lo + qchunk * T)
            pk = torch.zeros_like(Kf[:, :, keys])
            pv = torch.zeros_like(pk)
            for p0 in range(c_lo, c_hi, T):
                rows = slice(p0, min(p0 + T, c_hi))
                st, dt = scores(Kf[:, :, keys], Q[:, :, rows])
                pt = torch.where(vis[rows, keys].T, torch.exp(st - lse[:, :, None, rows]), 0.0)
                dpt = torch.einsum("bkcd,bkrd->bkcr", Vf[:, :, keys], dO[:, :, rows])
                dst = (pt if dt is None else pt * dt) * (dpt - delta[:, :, None, rows])
                pv += rnd(pt) @ dO[:, :, rows]
                pk += rnd(dst) @ Q[:, :, rows]
            parts.append((pk * scale, pv))
        for pk, pv in parts:                                # the combine, in chunk order
            dk[:, :, keys] += pk
            dv[:, :, keys] += pv
    dq = (dq * scale).reshape(B, K, Sq, G, D).permute(0, 2, 1, 3, 4).reshape(B, Sq, H, D)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
