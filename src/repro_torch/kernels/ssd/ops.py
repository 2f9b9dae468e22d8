"""Public SSD op: the CUDA kernel on the card, the plain version on the CPU.

Counterpart of ``repro.kernels.ssd.ops.ssd``.  It keeps the reference's
model layout — x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, N) — and
takes what the model path needs: an optional fp32 initial state, and the
final state as a second result.  B and C of the single group are read by
row inside the kernel, so nothing is repeated over the heads here; the
ragged last chunk is masked inside the kernel, so nothing is padded.

The call goes through the custom op ``repro_torch::ssd``
(``kernels/library.py``), and dispatch is by where the tensors lie, and
nowhere else: a CPU tensor goes to ``ref.ssd_ref``; a CUDA tensor launches
the kernel (the variant ``kernel.plan()`` names), or the call raises.  Its
gradient is the op ``repro_torch::ssd_bwd``: the backward kernel
(``csrc/ssd_bwd.cu``) on the card, autograd through ``ref.ssd_ref`` on the
CPU.  There is no fallback from one to the other.  Either call runs whole
in ``accounting.kernel_scope`` inside the op: the profiler and the
analysis and coverage passes count it as one attention call of
``kernel.cost`` work on both devices.  Both chunk by the kernel's 64
steps (``ref.CHUNK``); the reference's ``chunk`` argument and tuning-DB
lookup have no counterpart yet (``tuning/`` is ROADMAP Queue 1, slice 7).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import library


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, init_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32, Bm/Cm (B,S,N),
    ``init_state`` (B,H,P,N) fp32 or None -> (y (B,S,H,P) in x's dtype,
    final state (B,H,P,N) fp32)."""
    library.check_device("ssd", x)
    return library.ssd(x, dt, A, Bm, Cm, init_state)
