"""The hand-written CUDA RG-LRU scan kernels: plan, build, load, launch.

Port of the Pallas TPU kernel ``repro.kernels.rglru.kernel.
rglru_scan_kernel``; the source and its design note are in
``src/repro_torch/csrc/rglru.cu``.  It is built with ``nvcc`` at first
use and bound with ``ctypes`` by ``repro_torch.kernels.build``.

One C entry point, ``rglru_forward``, runs one of two variants, and the
variant is chosen here, by ``plan()``, from shapes alone:

* ``chunked`` — a scan over time in chunks of ``CHUNK`` steps: chunk
                aggregates, a decoupled look-back over earlier chunks and a
                rescan from the carry-in, in one launch, through a scratch
                the wrapper allocates;
* ``seq``     — the first design: one thread per (row, lane) walks every
                step, where the walk is short or its lanes alone keep the
                memory busy.

No variant stands in for another that fails to build or launch.

The backward (``csrc/rglru_bwd.cu``, its own library) has one variant,
``seq`` (``plan_bwd``), launched by ``rglru_bwd_cuda``: one thread per
(row, lane) walks the steps backward over the forward's output.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import CSRC, CudaLibrary

VARIANTS = ("seq", "chunked")
VARIANT_IDS = {name: i for i, name in enumerate(VARIANTS)}
CHUNK = 32                # steps a chunk of the chunked kernel (csrc/rglru.cu)
# Lanes (B * D) from which the step-by-step walk keeps the memory as busy
# as the chunked kernel: at every S measured, and at S <= 4 chunks, where
# the chunked kernel's fixed cost (its memset, ticket and look-back) is
# not repaid.  From chip_smoke.py's plan sweep on an H100 (PERF.md).
FILL_LANES = 16 * 4096
SHORT_FILL_LANES = 3 * 4096


def plan(B: int, S: int, D: int) -> Tuple[str, int]:
    """(variant, chunk) for one call at x (B, S, D): ``seq`` (chunk S)
    where S is at most two chunks, where B*D reaches ``FILL_LANES``, or
    where S is at most four chunks and B*D reaches ``SHORT_FILL_LANES``;
    else ``chunked`` (chunk ``CHUNK``)."""
    lanes = B * D
    if (S <= 2 * CHUNK or lanes >= FILL_LANES
            or (S <= 4 * CHUNK and lanes >= SHORT_FILL_LANES)):
        return "seq", S
    return "chunked", CHUNK


def cost(B: int, S: int, D: int, init: bool) -> Tuple[float, float]:
    """(flops, bytes) of one call, whatever computes it: ~7 fp32
    operations an element (a·a, 1 −, max, sqrt, ·x, and the multiply-add),
    and a and x read and h written once in fp32 (and the initial state
    read when ``init``)."""
    return 7.0 * B * S * D, float(4 * (3 * B * S * D + (B * D if init else 0)))


def scratch_words(B: int, S: int, D: int) -> int:
    """The ``chunked`` variant's scratch in 64-bit words: the ticket
    counter, then per (row, chunk, lane) two words, each a published fp32
    value with its state (the aggregate's A; its H or the inclusive end
    state)."""
    return 1 + 2 * B * math.ceil(S / CHUNK) * D


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.rglru_forward
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.rglru_chunk.restype = ctypes.c_int
    if lib.rglru_chunk() != CHUNK:
        raise RuntimeError(f"csrc/rglru.cu has chunk {lib.rglru_chunk()}, "
                           f"kernel.py expects {CHUNK}")


LIBRARY = CudaLibrary("rglru", CSRC / "rglru.cu", _bind)
#: the last build's {"seconds", "ptxas", "path"} (chip_smoke prints it)
build_info = LIBRARY.build_info
library = LIBRARY.load


def _fail(msg: str):
    raise ValueError(f"rglru: {msg}")


def launch(x: torch.Tensor, a: torch.Tensor, init_state: Optional[torch.Tensor],
           variant: str) -> torch.Tensor:
    """Launch ``variant`` on tensors ``rglru_cuda`` has checked; counts
    nothing (``chip_smoke.py`` times both variants through it)."""
    B, S, D = x.shape
    dev = x.device
    h = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    words = None
    if variant == "chunked":   # zeroed on the stream by the C entry
        words = torch.empty(scratch_words(B, S, D), dtype=torch.int64, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    lib = library()
    # the launch goes to the thread's current device: switch only if x is
    # elsewhere (the switch costs host time on every call)
    switch = (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
              else contextlib.nullcontext())
    with switch:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rglru_forward(
            x.data_ptr(), a.data_ptr(), ptr(init_state), h.data_ptr(), ptr(words),
            B, S, D, x.stride(0), x.stride(1), a.stride(0), a.stride(1),
            VARIANT_IDS[variant], stream)
    if rc != 0:
        raise RuntimeError(f"rglru kernel ({variant}) launch failed: CUDA error {rc}")
    return h


def rglru_cuda(x: torch.Tensor, a: torch.Tensor,
               init_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the planned variant.  x, a (B, S, D) fp32 CUDA tensors with
    unit stride over D (any row strides); ``init_state`` (B, D) fp32
    contiguous or None (zeros).  Returns a new contiguous h (B, S, D) fp32
    with h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) x_t."""
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
    variant, _ = plan(B, S, D)
    h = launch(x, a, init_state, variant)
    rglru_cuda.launches += 1
    rglru_cuda.launches_by_variant[variant] += 1
    return h


#: op calls that launched a kernel since the count was last set to 0
rglru_cuda.launches = 0
#: the same calls by variant
rglru_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)


# ---- the backward (csrc/rglru_bwd.cu) -------------------------------------------

BWD_VARIANTS = ("seq",)
BWD_VARIANT_IDS = {name: i for i, name in enumerate(BWD_VARIANTS)}


def plan_bwd(B: int, S: int, D: int) -> str:
    """The backward's variant for one call: ``seq`` (one thread per (row,
    lane) walks the steps backward), the only one."""
    return "seq"


def cost_bwd(B: int, S: int, D: int, init: bool, dh_last: bool) -> Tuple[float, float]:
    """(flops, bytes) of one backward call, whatever computes it: ~12 fp32
    operations an element (the gate s(a) and its slope, the carried
    gradient's add and decay, dx, da), and x, a, h and dh read and dx and
    da written once in fp32 (the initial state and ``dh_last`` read when
    given, dinit always written)."""
    return 12.0 * B * S * D, float(4 * (6 * B * S * D + B * D * (1 + int(init) + int(dh_last))))


def _bind_bwd(lib: ctypes.CDLL) -> None:
    fn = lib.rglru_backward
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


BWD_LIBRARY = CudaLibrary("rglru_bwd", CSRC / "rglru_bwd.cu", _bind_bwd)
#: the last backward build's {"seconds", "ptxas", "path"}
bwd_build_info = BWD_LIBRARY.build_info
bwd_library = BWD_LIBRARY.load


def rglru_bwd_cuda(x: torch.Tensor, a: torch.Tensor, h: torch.Tensor,
                   init_state: Optional[torch.Tensor], dh: torch.Tensor,
                   dh_last: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward: (dx, da, dinit) fp32 of ``rglru_cuda`` at its
    output ``h`` and output gradients ``dh`` ((B, S, D) fp32 contiguous,
    like h) and ``dh_last`` ((B, D) fp32 contiguous, or None for zeros).
    x and a as ``rglru_cuda`` takes them; dinit is computed whether or not
    ``init_state`` was given."""
    if x.ndim != 3:
        _fail(f"x must be (B, S, D), got {tuple(x.shape)}")
    B, S, D = x.shape
    dev = x.device
    if dev.type != "cuda":
        _fail(f"rglru_bwd_cuda needs CUDA tensors, got {dev}")
    for name, t in (("x", x), ("a", a), ("h", h), ("dh", dh)):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (B, S, D):
            _fail(f"{name} must be float32 {(B, S, D)} on {dev}, got {t.dtype} "
                  f"{tuple(t.shape)} on {t.device}")
        if t.stride(2) != 1 and D > 1:
            _fail(f"{name} must have unit stride over D, got {t.stride()}")
    if not (h.is_contiguous() and dh.is_contiguous()):
        _fail("h and dh must be contiguous")
    for name, t in (("init_state", init_state), ("dh_last", dh_last)):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or tuple(t.shape) != (B, D) or not t.is_contiguous()):
            _fail(f"{name} must be a contiguous float32 {(B, D)} tensor on {dev}, "
                  f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if S < 1:
        _fail("S must be at least 1")
    variant = plan_bwd(B, S, D)
    dx = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    da = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    dinit = torch.empty((B, D), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    lib = bwd_library()
    # autograd runs the backward on a thread of its own, where no card is
    # current: make x's card current for the launch
    switch = (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
              else contextlib.nullcontext())
    with switch:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rglru_backward(
            x.data_ptr(), a.data_ptr(), h.data_ptr(), ptr(init_state), dh.data_ptr(),
            ptr(dh_last), dx.data_ptr(), da.data_ptr(), dinit.data_ptr(), B, S, D,
            x.stride(0), x.stride(1), a.stride(0), a.stride(1), BWD_VARIANT_IDS[variant],
            stream)
    if rc != 0:
        raise RuntimeError(f"rglru backward kernel ({variant}) launch failed: CUDA error {rc}")
    rglru_bwd_cuda.launches += 1
    rglru_bwd_cuda.launches_by_variant[variant] += 1
    return dx, da, dinit


#: backward calls that launched the kernel
rglru_bwd_cuda.launches = 0
#: the same calls by variant
rglru_bwd_cuda.launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
