"""Hand-written CUDA kernels for Hopper, one package per TPU kernel.

Each kernel package has:
  kernel.py — builds the CUDA source under ``repro_torch/csrc/`` with nvcc
              (at first use), binds it with ctypes, checks and launches it
  ops.py    — public wrapper: the kernel for CUDA tensors, the plain
              version for CPU tensors, nothing else
  ref.py    — the plain PyTorch version the kernel is held against

Only flash attention is ported so far; the SSD and RG-LRU kernels come
with their families (ROADMAP Queue 2, K2 and K3).
"""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
