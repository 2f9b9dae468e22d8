"""The hand-written CUDA SSD chunked-scan kernel: build, load, launch.

Port of the Pallas TPU kernel ``repro.kernels.ssd.kernel.ssd_bh``; the
source and its design note are in ``src/repro_torch/csrc/ssd.cu``.  It is
built with ``nvcc`` at first use and bound with ``ctypes`` by
``repro_torch.kernels.build``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import CSRC, CudaLibrary
from repro_torch.kernels.ssd.ref import CHUNK

MAX_DIM = 128
DTYPES = (torch.bfloat16, torch.float32)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_forward
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ssd_smem_bytes.restype = ctypes.c_size_t
    lib.ssd_chunk.restype = ctypes.c_int
    if lib.ssd_chunk() != CHUNK:
        raise RuntimeError(f"csrc/ssd.cu has chunk {lib.ssd_chunk()}, "
                           f"kernel.py expects {CHUNK}")


LIBRARY = CudaLibrary("ssd", CSRC / "ssd.cu", _bind)
#: the last build's {"seconds", "ptxas", "path"} (chip_smoke prints it)
build_info = LIBRARY.build_info
library = LIBRARY.load


def shared_memory_bytes(P: int, N: int) -> int:
    """Dynamic shared memory one block of the kernel takes at (P, N)."""
    return int(library().ssd_smem_bytes(P, N))


def _fail(msg: str):
    raise ValueError(f"ssd: {msg}")


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel.  x (B, S, H, P) with unit stride over P and
    stride P over H; dt (B, S, H) fp32 contiguous; A (H,) fp32; Bm/Cm
    (B, S, N) with unit stride over N; x, Bm, Cm of one dtype (bf16 or
    fp32); ``init_state`` (B, H, P, N) fp32 contiguous or None (zeros).
    Returns new tensors y (B, S, H, P) in x's dtype and the final state
    (B, H, P, N) fp32."""
    dev = x.device
    if dev.type != "cuda":
        _fail(f"ssd_cuda needs CUDA tensors, got {dev}")
    if x.dtype not in DTYPES:
        _fail(f"dtype {x.dtype} not supported (bf16 or fp32)")
    if x.ndim != 4:
        _fail(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    if Bm.ndim != 3:
        _fail(f"Bm must be (B, S, N), got {tuple(Bm.shape)}")
    N = Bm.shape[-1]
    for name, d in (("head_dim P", P), ("d_state N", N)):
        if d % 8 or not 8 <= d <= MAX_DIM:
            _fail(f"{name}={d} must be a multiple of 8 and at most {MAX_DIM}")
    for name, t, shape, dtype in (("Bm", Bm, (B, S, N), x.dtype),
                                  ("Cm", Cm, (B, S, N), x.dtype),
                                  ("dt", dt, (B, S, H), torch.float32),
                                  ("A", A, (H,), torch.float32)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            _fail(f"{name} must be {dtype} {shape} on {dev}, got "
                  f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if x.stride(3) != 1 or (x.stride(2) != P and H > 1):
        _fail(f"x must have strides (*, *, {P}, 1), got {x.stride()}")
    if Bm.stride(2) != 1 or Cm.stride(2) != 1:
        _fail("Bm and Cm must have unit stride over N")
    if not (dt.is_contiguous() and A.is_contiguous()):
        _fail("dt and A must be contiguous")
    if init_state is not None and (
            init_state.device != dev or init_state.dtype != torch.float32
            or tuple(init_state.shape) != (B, H, P, N)
            or not init_state.is_contiguous()):
        _fail(f"init_state must be a contiguous float32 {(B, H, P, N)} "
              f"tensor on {dev}, got {init_state.dtype} "
              f"{tuple(init_state.shape)} on {init_state.device}")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_forward(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, S, H, P, N,
            x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
            Cm.stride(0), Cm.stride(1), int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {rc}")
    ssd_cuda.launches += 1
    return y, state


#: launches of the kernel since the count was last set to 0
ssd_cuda.launches = 0
