"""Public RG-LRU op: the CUDA kernel on the card, the plain version on the CPU.

Counterpart of ``repro.kernels.rglru.ops.rglru``.  It keeps the model
layout x, a (B, S, D) and takes what the model path needs: an optional
fp32 initial state, and the final state as a second result.  b =
sqrt(max(1 - a^2, 1e-12)) x is formed in fp32, inside the kernel on the
card; the kernel takes any S and D, so nothing is padded.

Dispatch is by where the tensors lie, and nowhere else: a CPU tensor goes
to ``ref.rglru_blocked``; a CUDA tensor launches the kernel, or the call
raises (also when a gradient is wanted: the kernel has no backward
yet).  There is no fallback from one to the other.  Either call runs in
``accounting.kernel_scope``: the profiler counts it as one attention call
of ``kernel.cost`` work.  The reference's
``block_t``/``block_d`` arguments and tuning-DB lookup have no
counterpart: ``kernel.plan()`` picks the kernel's variant from shapes
(``tuning/`` is ROADMAP Queue 1, slice 7).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.accounting import kernel_scope
from repro_torch.kernels.rglru.kernel import cost, rglru_cuda
from repro_torch.kernels.rglru.ref import rglru_blocked


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32 with unit stride over its last dim (a view when it
    has one)."""
    t = t.float()
    return t if t.stride(-1) == 1 else t.contiguous()


def rglru(x: torch.Tensor, a: torch.Tensor,
          init_state: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, a (B, S, D), ``init_state`` (B, D) fp32 or None -> (h (B, S, D)
    fp32, h_last (B, D) fp32) with h_t = a_t h_{t-1} + sqrt(1 - a_t^2) x_t."""
    B, S, D = x.shape
    work = lambda: cost(B, S, D, init_state is not None)   # noqa: E731
    if x.device.type == "cpu":
        with kernel_scope("rglru", work, x.device):
            h = rglru_blocked(x, a, init_state)
    elif x.device.type == "cuda":
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in (x, a, init_state)):
            raise NotImplementedError(
                "rglru: the CUDA kernel has no backward yet, and its output "
                "would carry no gradient (ROADMAP Queue 1: recurrentgemma "
                "training on the card)")
        args = (_rows(x), _rows(a),
                None if init_state is None else init_state.float().contiguous())
        with kernel_scope("rglru", work, x.device):
            h = rglru_cuda(*args)
    else:
        raise ValueError(f"rglru: no path for device {x.device}")
    return h, h[:, -1]
