"""Hand-written CUDA kernels for Hopper, one package per TPU kernel.

Each kernel package has:
  kernel.py — binds the CUDA source under ``repro_torch/csrc/`` (built with
              nvcc at first use by ``build.py``) with ctypes, checks and
              launches it, and counts its launches
  ops.py    — public wrapper: the kernel for CUDA tensors, the plain
              version for CPU tensors, nothing else, through the
              kernel's custom op
  ref.py    — the plain PyTorch version the kernel is held against

``library.py`` registers the kernels and their backward kernels as
``torch.library`` custom ops, ``torch.ops.repro_torch.*``: the kernel
launch as the CUDA implementation, the plain version as the CPU one, a
fake for ``torch.compile``, which keeps each call one opaque op.

Ported: flash attention (K1), the Mamba-2 SSD chunked scan (K2) and the
RG-LRU scan (K3): every Pallas kernel of the reference has its
counterpart.  Each has a hand-written backward kernel too (no TPU
counterpart: the reference differentiates its XLA code), in the same
package: ``csrc/flash_attention_bwd.cu``, ``csrc/ssd_bwd.cu`` and
``csrc/rglru_bwd.cu``.
"""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
from repro_torch.kernels.rglru.ops import rglru  # noqa: F401
from repro_torch.kernels.ssd.ops import ssd  # noqa: F401
