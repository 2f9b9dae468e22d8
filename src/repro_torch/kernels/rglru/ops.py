"""Public RG-LRU op: the CUDA kernel on the card, the plain version on the CPU.

Counterpart of ``repro.kernels.rglru.ops.rglru``.  It keeps the model
layout x, a (B, S, D) and takes what the model path needs: an optional
fp32 initial state, and the final state as a second result.  b =
sqrt(max(1 - a^2, 1e-12)) x is formed in fp32, inside the kernel on the
card; the kernel takes any S and D, so nothing is padded.

The call goes through the custom op ``repro_torch::rglru``
(``kernels/library.py``), and dispatch is by where the tensors lie, and
nowhere else: a CPU tensor goes to ``ref.rglru_blocked``; a CUDA tensor
launches the kernel, or the call raises.  Its gradient is the op
``repro_torch::rglru_bwd``: the backward kernel (``csrc/rglru_bwd.cu``) on
the card, autograd through ``ref.rglru_blocked`` on the CPU.  There is no
fallback from one to the other.  Either call runs whole in ``accounting.kernel_scope`` inside the
op: the profiler and the analysis and coverage passes count it as one
attention call of ``kernel.cost`` work on both devices.  The reference's
``block_t``/``block_d`` arguments and tuning-DB lookup have no
counterpart: ``kernel.plan()`` picks the kernel's variant from shapes
(``tuning/`` is ROADMAP Queue 1, slice 7).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import library


def rglru(x: torch.Tensor, a: torch.Tensor,
          init_state: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, a (B, S, D), ``init_state`` (B, D) fp32 or None -> (h (B, S, D)
    fp32, h_last (B, D) fp32) with h_t = a_t h_{t-1} + sqrt(1 - a_t^2) x_t."""
    library.check_device("rglru", x)
    return library.rglru(x, a, init_state)
