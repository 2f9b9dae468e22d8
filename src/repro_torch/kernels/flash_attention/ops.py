"""Public flash-attention op: the CUDA kernel on the card, the plain
version on the CPU.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``.  It
keeps the reference layout — q (B, Sq, H, D), k/v (B, Sk, K, D) — and
takes what the model path needs: per-row ``q_offset`` / ``kv_len``, the
prefix mask, an explicit scale and softcap.  GQA is handled inside the
kernel (kv head ``h // G``), so nothing is repeated here.

The call goes through the custom op ``repro_torch::flash_attention``
(``kernels/library.py``), and dispatch is by where the tensors lie, and
nowhere else: a CPU tensor goes to ``ref.attention_ref``; a CUDA tensor
launches the kernel, or the call raises.  There is no fallback from one
to the other.  The kernel's variant (tensor-core prefill, split-KV decode
or the CUDA-core kernel) is chosen by ``kernel.plan`` from shapes and
dtype.  A scalar ``q_offset`` / ``kv_len`` reaches the kernel as an int,
with no tensor made for it.  The op's gradient is the backward op
``repro_torch::flash_attention_bwd``: the backward kernel on the card,
``attention_ref`` differentiated again on the CPU.  Each call, forward or
backward, runs whole in ``accounting.kernel_scope`` inside the op, so the
profiler, the analysis pass and the coverage pass count it as one
attention call of ``kernel.cost`` / ``kernel.cost_bwd`` work on either
device, compiled or not.  There is no tuning-DB lookup yet (``tuning/``
is ROADMAP Queue 1, slice 7): the kernel's tiles are fixed in its source.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import library
from repro_torch.kernels.flash_attention.ref import IntOrRows


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
    library.check_device("flash_attention", q)
    qo, qo_rows = library.split_rows(q_offset)
    kl, kl_rows = library.split_rows(kv_len)
    return library.flash_attention(q, k, v, mask_type, int(window), int(prefix_len), qo,
                                   qo_rows, kl, kl_rows, softmax_scale, float(softcap))
