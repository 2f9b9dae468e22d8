"""The hand-written CUDA RG-LRU scan kernel: build, load, launch.

Port of the Pallas TPU kernel ``repro.kernels.rglru.kernel.
rglru_scan_kernel``; the source and its design note are in
``src/repro_torch/csrc/rglru.cu``.  It is built with ``nvcc`` at first
use and bound with ``ctypes`` by ``repro_torch.kernels.build``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import CSRC, CudaLibrary


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.rglru_forward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("rglru", CSRC / "rglru.cu", _bind)
#: the last build's {"seconds", "ptxas", "path"} (chip_smoke prints it)
build_info = LIBRARY.build_info
library = LIBRARY.load


def _fail(msg: str):
    raise ValueError(f"rglru: {msg}")


def rglru_cuda(x: torch.Tensor, a: torch.Tensor,
               init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel.  x, a (B, S, D) fp32 CUDA tensors with unit
    stride over D (any row strides); ``init_state`` (B, D) fp32 contiguous
    or None (zeros).  Returns a new contiguous h (B, S, D) fp32 with
    h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) x_t."""
    if x.ndim != 3:
        _fail(f"x must be (B, S, D), got {tuple(x.shape)}")
    B, S, D = x.shape
    for name, t in (("x", x), ("a", a)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, S, D):
            _fail(f"{name} must be float32 {(B, S, D)}, got {t.dtype} "
                  f"{tuple(t.shape)}")
        if t.stride(2) != 1 and D > 1:
            _fail(f"{name} must have unit stride over D, got {t.stride()}")
    if S < 1:
        _fail("S must be at least 1")
    if init_state is not None and (
            init_state.dtype != torch.float32 or tuple(init_state.shape) != (B, D)
            or not init_state.is_contiguous()):
        _fail(f"init_state must be a contiguous float32 {(B, D)} tensor, got "
              f"{init_state.dtype} {tuple(init_state.shape)}")
    dev = x.device
    if dev.type != "cuda":
        _fail(f"rglru_cuda needs CUDA tensors, got {dev}")
    for t in (a,) if init_state is None else (a, init_state):
        if t.device != dev:
            _fail(f"every tensor must lie on {dev}, got one on {t.device}")
    h = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rglru_forward(
            x.data_ptr(), a.data_ptr(),
            None if init_state is None else init_state.data_ptr(), h.data_ptr(),
            B, S, D, x.stride(0), x.stride(1), a.stride(0), a.stride(1), stream)
    if rc != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {rc}")
    rglru_cuda.launches += 1
    return h


#: launches of the kernel since the count was last set to 0
rglru_cuda.launches = 0
