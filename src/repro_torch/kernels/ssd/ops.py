"""Public SSD op: the CUDA kernel on the card, the plain version on the CPU.

Counterpart of ``repro.kernels.ssd.ops.ssd``.  It keeps the reference's
model layout — x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, N) — and
takes what the model path needs: an optional fp32 initial state, and the
final state as a second result.  B and C of the single group are read by
row inside the kernel, so nothing is repeated over the heads here; the
ragged last chunk is masked inside the kernel, so nothing is padded.

Dispatch is by where the tensors lie, and nowhere else: a CPU tensor goes
to ``ref.ssd_ref``; a CUDA tensor launches the kernel (the variant
``kernel.plan()`` names), or the call raises; it raises too when a
gradient is wanted, since the kernel has no backward yet.
There is no fallback from one to the other.  Either call runs in
``accounting.kernel_scope``: the profiler counts it as one attention call
of ``kernel.cost`` work.  Both chunk by the kernel's 64
steps (``ref.CHUNK``); the reference's ``chunk`` argument and tuning-DB
lookup have no counterpart yet (``tuning/`` is ROADMAP Queue 1, slice 7).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.accounting import kernel_scope
from repro_torch.kernels.ssd.kernel import cost, ssd_cuda
from repro_torch.kernels.ssd.ref import ssd_ref


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with unit stride over its last dim (a view when it has one)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, init_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32, Bm/Cm (B,S,N),
    ``init_state`` (B,H,P,N) fp32 or None -> (y (B,S,H,P) in x's dtype,
    final state (B,H,P,N) fp32)."""
    B, S, H, P = x.shape
    work = lambda: cost(B, S, H, P, Bm.shape[-1], x.dtype,   # noqa: E731
                        init_state is not None)
    if x.device.type == "cpu":
        with kernel_scope("ssd", work, x.device):
            return ssd_ref(x, dt, A, Bm, Cm, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no path for device {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, dt, A, Bm, Cm, init_state)):
        raise NotImplementedError(
            "ssd: the CUDA kernel has no backward yet, and its output would "
            "carry no gradient (ROADMAP Queue 1: mamba2 training on the card)")
    if x.stride(-1) != 1 or (x.stride(2) != P and H > 1):
        x = x.contiguous()
    args = (x, dt.contiguous(), A.contiguous(), _rows(Bm), _rows(Cm),
            None if init_state is None else init_state.contiguous())
    with kernel_scope("ssd", work, x.device):
        return ssd_cuda(*args)
