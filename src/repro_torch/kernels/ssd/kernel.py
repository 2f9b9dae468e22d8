"""The hand-written CUDA SSD chunked-scan kernels: plan, build, load, launch.

Port of the Pallas TPU kernel ``repro.kernels.ssd.kernel.ssd_bh``; the
source and its design note are in ``src/repro_torch/csrc/ssd.cu``.  It is
built with ``nvcc`` at first use and bound with ``ctypes`` by
``repro_torch.kernels.build``.

One C entry point, ``ssd_forward``, runs one of two variants, and the
variant is chosen here, by ``plan()``, from shapes and dtype alone:

* ``tc``   — bf16 with head_dim P = 64 and d_state N = 128 (every Mamba-2
             model of the repository): three passes, chunk states and chunk scan on
             the tensor cores, parallel over (chunk, head group, row), and a
             state pass sequential over chunks only, through a scratch the
             wrapper allocates;
* ``simt`` — the first design on the CUDA cores: fp32 (held to 5e-5) and
             any other P, N (multiples of 8, at most 128).

No variant stands in for another that fails to build or launch.

The backward (``csrc/ssd_bwd.cu``, its own library) has one variant,
``simt`` (``plan_bwd``), launched by ``ssd_bwd_cuda``: the forward's three
passes reversed, every product on the CUDA cores in fp32.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import CSRC, CudaLibrary
from repro_torch.kernels.ssd.ref import CHUNK

MAX_DIM = 128
DTYPES = (torch.bfloat16, torch.float32)
VARIANTS = ("tc", "simt")
VARIANT_IDS = {name: i for i, name in enumerate(VARIANTS)}
TC_HEAD_DIM = 64
TC_STATE_DIM = 128
HEADS_PER_BLOCK = 4       # C·Bᵀ and the B/C loads are shared by this many heads
SMS = 132                 # streaming multiprocessors of an H100 SXM
KERNEL_IDS = {"simt": 0, "chunk_state": 1, "chunk_scan": 2}


def plan(B: int, S: int, H: int, P: int, N: int,
         dtype: torch.dtype) -> Tuple[str, int]:
    """(variant, heads_per_block) for one call.  ``tc`` for bf16 at
    P = 64, N = 128; its heads per block are 4, halved (down to 1)
    while a pass would have fewer than two blocks per SM (2 x 132).
    ``heads_per_block`` is 1 for ``simt`` (one block per row and head)."""
    if dtype != torch.bfloat16 or P != TC_HEAD_DIM or N != TC_STATE_DIM:
        return "simt", 1
    chunks = math.ceil(S / CHUNK)
    hpb = HEADS_PER_BLOCK
    while hpb > 1 and B * chunks * math.ceil(H / hpb) < 2 * SMS:
        hpb //= 2
    return "tc", hpb


#: the chunk length at which ``cost`` counts the chunked algorithm's flops
#: (the reference configs' ``ssm_chunk``), whatever chunk computes them
WORK_CHUNK = 256


def cost(B: int, S: int, H: int, P: int, N: int, dtype: torch.dtype,
         init: bool) -> Tuple[float, float]:
    """(flops, bytes) of one call, whatever computes it: the chunked
    algorithm's flops at ``WORK_CHUNK`` (C·Bᵀ once per row and chunk,
    shared by the heads; per head the masked product with x and the
    state terms), and the bytes of x, dt, A, B, C (and the initial state
    when ``init``) read once and y and the final state written once."""
    flops = 0.0
    for s0 in range(0, S, WORK_CHUNK):
        n = min(WORK_CHUNK, S - s0)
        flops += B * (2.0 * n * n * N + H * (2.0 * n * n * P + 4.0 * n * N * P))
    nbytes = (dtype.itemsize * (2 * B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + H)
              + 4 * B * H * P * N * (2 if init else 1))
    return flops, float(nbytes)


def scratch_shapes(B: int, S: int, H: int, P: int, N: int):
    """The ``tc`` variant's scratch: chunk states (B, n_chunks, H, P, N)
    fp32, the incoming states h_in of the same shape in bf16, and cum_last
    (B, n_chunks, H) fp32, n_chunks = ceil(S / CHUNK)."""
    nc = math.ceil(S / CHUNK)
    return (B, nc, H, P, N), (B, nc, H, P, N), (B, nc, H)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_forward
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_smem_bytes.restype = ctypes.c_size_t
    lib.ssd_chunk.restype = ctypes.c_int
    if lib.ssd_chunk() != CHUNK:
        raise RuntimeError(f"csrc/ssd.cu has chunk {lib.ssd_chunk()}, "
                           f"kernel.py expects {CHUNK}")


LIBRARY = CudaLibrary("ssd", CSRC / "ssd.cu", _bind)
#: the last build's {"seconds", "ptxas", "path"} (chip_smoke prints it)
build_info = LIBRARY.build_info
library = LIBRARY.load


def shared_memory_bytes(P: int, N: int, kernel: str = "simt") -> int:
    """Dynamic shared memory one block of ``kernel`` (``simt``,
    ``chunk_state`` or ``chunk_scan``) takes at (P, N)."""
    return int(library().ssd_smem_bytes(KERNEL_IDS[kernel], P, N))


def _aligned16(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` (unit stride last) starts 16 bytes
    aligned, as the ``tc`` variant's 16-byte copies need."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % step == 0 for s in t.stride()[:-1])


def _fail(msg: str):
    raise ValueError(f"ssd: {msg}")


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the planned variant.  x (B, S, H, P) with unit stride over P
    and stride P over H; dt (B, S, H) fp32 contiguous; A (H,) fp32; Bm/Cm
    (B, S, N) with unit stride over N; x, Bm, Cm of one dtype (bf16 or
    fp32), their rows 16-byte aligned under ``tc``; ``init_state``
    (B, H, P, N) fp32 contiguous or None (zeros).  Returns new tensors y
    (B, S, H, P) in x's dtype and the final state (B, H, P, N) fp32."""
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
    variant, hpb = plan(B, S, H, P, N, x.dtype)
    if variant == "tc" and not all(_aligned16(t) for t in (x, Bm, Cm)):
        _fail("x, Bm and Cm rows must be 16-byte aligned")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    scratch = [None, None, None]
    if variant == "tc":
        s_shape, h_shape, l_shape = scratch_shapes(B, S, H, P, N)
        scratch = [torch.empty(s_shape, dtype=torch.float32, device=dev),
                   torch.empty(h_shape, dtype=torch.bfloat16, device=dev),
                   torch.empty(l_shape, dtype=torch.float32, device=dev)]
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    lib = library()
    # the launch goes to the thread's current device: switch only if x is
    # elsewhere (the switch costs host time on every call)
    switch = (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
              else contextlib.nullcontext())
    with switch:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_forward(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), ptr(init_state), y.data_ptr(), state.data_ptr(),
            *(ptr(t) for t in scratch), B, S, H, P, N,
            x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
            Cm.stride(0), Cm.stride(1), int(x.dtype == torch.bfloat16),
            VARIANT_IDS[variant], hpb, stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel ({variant}) launch failed: CUDA error {rc}")
    ssd_cuda.launches += 1
    ssd_cuda.launches_by_variant[variant] += 1
    return y, state


#: op calls that launched a kernel since the count was last set to 0 (the
#: tc variant's three passes are one call, one launch here)
ssd_cuda.launches = 0
#: the same calls by variant
ssd_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)


# ---- the backward (csrc/ssd_bwd.cu) ---------------------------------------------

BWD_VARIANTS = ("simt",)
BWD_VARIANT_IDS = {name: i for i, name in enumerate(BWD_VARIANTS)}
#: dynamic shared memory one block may have on an H100 (227 KB)
MAX_BLOCK_SMEM = 232448


def bwd_shared_memory_bytes(P: int, N: int) -> Tuple[int, int]:
    """Dynamic shared memory of one block of the backward's pass 1 (chunk
    and gradient states) and pass 3 (the chunk's gradients) at (P, N), as
    ``csrc/ssd_bwd.cu`` sizes them: fp32 tiles with odd row strides."""
    ld = lambda n: n + 1   # noqa: E731
    state = 2 * CHUNK + CHUNK * ld(P) + CHUNK * ld(N)
    chunk = (8 * CHUNK + 2 * CHUNK * ld(P) + 2 * CHUNK * ld(N) + P * ld(N)
             + 3 * CHUNK * (CHUNK + 1) + 8)
    return 4 * state, 4 * chunk


def plan_bwd(B: int, S: int, H: int, P: int, N: int, dtype: torch.dtype) -> str:
    """The backward's variant for one call: ``simt`` (every product on the
    CUDA cores in fp32), the only one.  Raises for what it does not take:
    another dtype, P or N not a multiple of 8 in [8, 128], or a shape whose
    pass-3 block needs more shared memory than a block may have (P = N =
    128)."""
    if dtype not in DTYPES:
        raise ValueError(f"ssd backward: dtype {dtype} not supported (bf16 or fp32)")
    for name, d in (("head_dim P", P), ("d_state N", N)):
        if d % 8 or not 8 <= d <= MAX_DIM:
            raise ValueError(f"ssd backward: {name}={d} must be a multiple of 8 "
                             f"and at most {MAX_DIM}")
    if bwd_shared_memory_bytes(P, N)[1] > MAX_BLOCK_SMEM:
        raise ValueError(f"ssd backward: P={P}, N={N} needs "
                         f"{bwd_shared_memory_bytes(P, N)[1]} bytes of shared memory "
                         f"a block (at most {MAX_BLOCK_SMEM})")
    return "simt"


def cost_bwd(B: int, S: int, H: int, P: int, N: int, dtype: torch.dtype, init: bool,
             dstate: bool) -> Tuple[float, float]:
    """(flops, bytes) of one backward call: the chunked algorithm's
    products at the backward kernel's ``CHUNK`` (C·Bᵀ once per row and
    chunk; per head dy·xᵀ, the two masked products for dx and the two for
    dB and dC, and five (P, N)-state products a step: the chunk and
    gradient states, R·B, Rᵀ·x, h_inᵀ·dy), and the bytes of x, dt, A, B, C
    and dy read once and their gradients written once (the initial state
    and ``dstate`` read when given, dinit always written).  The products
    bound the call, so they are counted at the chunk the kernel computes
    in, not at ``WORK_CHUNK``, whose intra-chunk products are 4x as many:
    the bound is then no more than the work the call does."""
    flops = 0.0
    for s0 in range(0, S, CHUNK):
        n = min(CHUNK, S - s0)
        flops += B * (2.0 * n * n * N + H * (4.0 * n * n * P + 4.0 * n * n * N
                                             + 10.0 * n * P * N))
    state = 4 * B * H * P * N
    nbytes = (dtype.itemsize * (3 * B * S * H * P + 4 * B * S * N) + 4 * (2 * B * S * H + 2 * H)
              + state * (1 + int(init) + int(dstate)))
    return flops, float(nbytes)


def bwd_scratch_floats(B: int, S: int, H: int, P: int, N: int) -> int:
    """Floats of the backward's scratch: the chunk states and gradient
    states (B, n_chunks, H, P, N) fp32, cum_last and dA's partials (B,
    n_chunks, H), and dB's and dC's per-head partials (B, S, H, N), n_chunks
    = ceil(S / CHUNK)."""
    nc = math.ceil(S / CHUNK)
    return 2 * B * nc * H * P * N + 2 * B * nc * H + 2 * B * S * H * N


def _bind_bwd(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_backward
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ssd_bwd_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.ssd_bwd_scratch_floats.restype = ctypes.c_size_t
    lib.ssd_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.ssd_bwd_chunk.restype = ctypes.c_int
    if lib.ssd_bwd_chunk() != CHUNK:
        raise RuntimeError(f"csrc/ssd_bwd.cu has chunk {lib.ssd_bwd_chunk()}, "
                           f"kernel.py expects {CHUNK}")
    probe = (2, 100, 3, 16, 24)
    if lib.ssd_bwd_scratch_floats(*probe) != bwd_scratch_floats(*probe) or any(
            lib.ssd_bwd_smem_bytes(k + 1, 64, 128) != bwd_shared_memory_bytes(64, 128)[k]
            for k in (0, 1)):
        raise RuntimeError("csrc/ssd_bwd.cu and kernel.py size the backward's "
                           "scratch or shared memory differently")


BWD_LIBRARY = CudaLibrary("ssd_bwd", CSRC / "ssd_bwd.cu", _bind_bwd)
#: the last backward build's {"seconds", "ptxas", "path"}
bwd_build_info = BWD_LIBRARY.build_info
bwd_library = BWD_LIBRARY.load


def ssd_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, init_state: Optional[torch.Tensor], dy: torch.Tensor,
                 dstate: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Launch the backward: (dx, ddt, dA, dBm, dCm, dinit) of ``ssd_cuda``
    at its output gradients ``dy`` (y-shaped, x's dtype, contiguous) and
    ``dstate`` ((B, H, P, N) fp32 contiguous, or None for zeros).  The
    inputs as ``ssd_cuda`` takes them.  dx, dBm and dCm come back
    contiguous in x's dtype, ddt, dA and dinit in fp32; dinit is computed
    whether or not ``init_state`` was given."""
    dev = x.device
    if dev.type != "cuda":
        _fail(f"ssd_bwd_cuda needs CUDA tensors, got {dev}")
    if x.ndim != 4 or Bm.ndim != 3:
        _fail(f"x must be (B, S, H, P) and Bm (B, S, N), got {tuple(x.shape)}, "
              f"{tuple(Bm.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    variant = plan_bwd(B, S, H, P, N, x.dtype)
    for name, t, shape, dtype in (("Bm", Bm, (B, S, N), x.dtype),
                                  ("Cm", Cm, (B, S, N), x.dtype),
                                  ("dt", dt, (B, S, H), torch.float32),
                                  ("A", A, (H,), torch.float32),
                                  ("dy", dy, (B, S, H, P), x.dtype)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            _fail(f"{name} must be {dtype} {shape} on {dev}, got "
                  f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if x.stride(3) != 1 or (x.stride(2) != P and H > 1):
        _fail(f"x must have strides (*, *, {P}, 1), got {x.stride()}")
    if Bm.stride(2) != 1 or Cm.stride(2) != 1:
        _fail("Bm and Cm must have unit stride over N")
    if not (dt.is_contiguous() and A.is_contiguous() and dy.is_contiguous()):
        _fail("dt, A and dy must be contiguous")
    for name, t in (("init_state", init_state), ("dstate", dstate)):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or tuple(t.shape) != (B, H, P, N) or not t.is_contiguous()):
            _fail(f"{name} must be a contiguous float32 {(B, H, P, N)} tensor on "
                  f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dBm = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    dCm = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    dinit = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    scratch = torch.empty(bwd_scratch_floats(B, S, H, P, N), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    lib = bwd_library()
    # autograd runs the backward on a thread of its own, where no card is
    # current: make x's card current for the launch
    switch = (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
              else contextlib.nullcontext())
    with switch:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_backward(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            ptr(init_state), dy.data_ptr(), ptr(dstate), dx.data_ptr(), ddt.data_ptr(),
            dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(), dinit.data_ptr(),
            scratch.data_ptr(), B, S, H, P, N, x.stride(0), x.stride(1), Bm.stride(0),
            Bm.stride(1), Cm.stride(0), Cm.stride(1), int(x.dtype == torch.bfloat16),
            BWD_VARIANT_IDS[variant], stream)
    if rc != 0:
        raise RuntimeError(f"ssd backward kernel ({variant}) launch failed: CUDA error {rc}")
    ssd_bwd_cuda.launches += 1
    ssd_bwd_cuda.launches_by_variant[variant] += 1
    return dx, ddt, dA, dBm, dCm, dinit


#: backward calls that launched the kernels (its passes are one call)
ssd_bwd_cuda.launches = 0
#: the same calls by variant
ssd_bwd_cuda.launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
