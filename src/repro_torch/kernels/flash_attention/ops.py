"""Public flash-attention op: the CUDA kernel on the card, the plain
version on the CPU.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``.  It
keeps the reference layout — q (B, Sq, H, D), k/v (B, Sk, K, D) — and
takes what the model path needs: per-row ``q_offset`` / ``kv_len``, the
prefix mask, an explicit scale and softcap.  GQA is handled inside the
kernel (kv head ``h // G``), so nothing is repeated here.

Dispatch is by where the tensors lie, and nowhere else: a CPU tensor goes
to ``ref.attention_ref`` (autograd differentiates its plain ops); a CUDA
tensor launches the kernel, or the call raises.  There is no fallback
from one to the other.  The kernel's variant (tensor-core prefill,
split-KV decode or the CUDA-core kernel) is chosen by ``kernel.plan``
from shapes and dtype.  A scalar ``q_offset`` / ``kv_len`` reaches the
kernel as an int, with no tensor made for it.  When a gradient is wanted
(grad mode on and q, k or v requiring grad), the CUDA call goes through
``FlashAttention``, an autograd Function whose forward is the same
kernel launch and whose backward is the backward kernel
(``kernel.flash_attention_bwd_cuda``); it saves q, k, v and the output.
Each call, forward or backward, runs in ``accounting.kernel_scope``, so
the profiler counts it as one attention call of ``kernel.cost`` /
``kernel.cost_bwd`` work on either device (on the CPU the backward is
autograd's plain ops, counted as such).  There is no tuning-DB lookup
yet (``tuning/`` is ROADMAP Queue 1, slice 7): the kernel's tiles are
fixed in its source.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels.accounting import kernel_scope
from repro_torch.kernels.flash_attention.kernel import (cost, cost_bwd,
                                                        flash_attention_bwd_cuda,
                                                        flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import IntOrRows, attention_ref


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kw: Dict[str, Any]):
        o = flash_attention_cuda(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        kw = ctx.kw
        with kernel_scope("flash_attention_bwd", lambda: cost_bwd(
                *_shape(q, k), q.dtype, mask_type=kw["mask_type"], window=kw["window"],
                prefix_len=kw["prefix_len"], q_offset=kw["q_offset"],
                kv_len=kw["kv_len"]), q.device):
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, do.contiguous(), **kw)
        return dq, dk, dv, None


def _shape(q: torch.Tensor, k: torch.Tensor):
    """(B, Sq, Sk, H, K, D) of a call."""
    B, Sq, H, D = q.shape
    return B, Sq, k.shape[1], H, k.shape[2], D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mask_type: str = "causal", window: int = 0,
                    prefix_len: int = 0, q_offset: IntOrRows = 0,
                    kv_len: Optional[IntOrRows] = None,
                    softmax_scale: Optional[float] = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, K, D) with H % K == 0 -> (B, Sq, H, D).

    ``q_offset`` is the position of q[:, 0] and ``kv_len`` the valid kv
    length (None: all of Sk); each is a scalar or a per-row (B,) tensor.
    """
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError(
            "flash_attention: Dv != D (MLA) is not ported yet (ROADMAP "
            "Queue 1, slice 5: deepseek-v2)")
    if q.device.type == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    elif q.device.type != "cpu":
        raise ValueError(f"flash_attention: no path for device {q.device}")
    work = lambda: cost(*_shape(q, k), q.dtype, mask_type=mask_type,  # noqa: E731
                        window=window, prefix_len=prefix_len, q_offset=q_offset,
                        kv_len=kv_len)
    with kernel_scope("flash_attention", work, q.device):
        return _flash_attention(q, k, v, mask_type=mask_type, window=window,
                                prefix_len=prefix_len, q_offset=q_offset, kv_len=kv_len,
                                softmax_scale=softmax_scale, softcap=softcap)


def _flash_attention(q, k, v, *, mask_type, window, prefix_len, q_offset, kv_len,
                     softmax_scale, softcap):
    if q.device.type == "cpu":
        return attention_ref(q, k, v, mask_type=mask_type, window=window,
                             prefix_len=prefix_len, q_offset=q_offset,
                             kv_len=kv_len, softmax_scale=softmax_scale,
                             softcap=softcap)
    D = q.shape[-1]
    Sk = k.shape[1]
    kw = dict(q_offset=q_offset, kv_len=Sk if kv_len is None else kv_len,
              mask_type=mask_type, window=window, prefix_len=prefix_len,
              scale=softmax_scale if softmax_scale is not None else D ** -0.5,
              softcap=softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, kw)
    return flash_attention_cuda(q, k, v, **kw)
