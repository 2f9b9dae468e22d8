"""Public flash-attention op: the CUDA kernel on the card, the plain
version on the CPU.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``.  It
keeps the reference layout — q (B, Sq, H, D), k/v (B, Sk, K, D) — and
takes what the model path needs: per-row ``q_offset`` / ``kv_len``, the
prefix mask, an explicit scale and softcap.  GQA is handled inside the
kernel (kv head ``h // G``), so nothing is repeated here.

Dispatch is by where the tensors lie, and nowhere else: a CPU tensor goes
to ``ref.attention_ref``; a CUDA tensor launches the kernel, or the call
raises.  There is no fallback from one to the other.  There is no
tuning-DB lookup yet (``tuning/`` is ROADMAP Queue 1, slice 5): the
kernel's tiles are fixed in its source.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import IntOrRows, attention_ref


def _rows_int32(x: IntOrRows, B: int, device) -> torch.Tensor:
    t = torch.as_tensor(x, device=device)
    return t.to(torch.int32).expand(B).contiguous() if t.ndim == 0 else \
        t.to(torch.int32).contiguous()


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
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if v.shape[-1] != D:
        raise NotImplementedError(
            "flash_attention: Dv != D (MLA) is not ported yet (ROADMAP "
            "Queue 1, slice 3: deepseek-v2)")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, mask_type=mask_type, window=window,
                             prefix_len=prefix_len, q_offset=q_offset,
                             kv_len=kv_len, softmax_scale=softmax_scale,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no path for device {q.device}")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    return flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(),
        q_offset=_rows_int32(q_offset, B, q.device),
        kv_len=_rows_int32(Sk if kv_len is None else kv_len, B, q.device),
        mask_type=mask_type, window=window, prefix_len=prefix_len,
        scale=scale, softcap=softcap)
