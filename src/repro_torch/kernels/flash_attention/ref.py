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
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

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
