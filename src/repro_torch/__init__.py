"""PyTorch/CUDA port of the ``repro`` benchmark suite, for one NVIDIA H100.

Module paths mirror ``repro`` one to one.  The package imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``.  Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU, where every
kernel's plain PyTorch version runs instead.
"""
