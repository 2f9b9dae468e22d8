"""The hand-written CUDA flash-attention kernels: plan, build, load, launch.

Port of the Pallas TPU kernel ``repro.kernels.flash_attention.kernel.
flash_attention_bh``; the sources and their design notes are in
``src/repro_torch/csrc/flash_attention.cu``.  It is built with ``nvcc`` at
first use and bound with ``ctypes`` by ``repro_torch.kernels.build``.

One C entry point, ``fa_forward``, runs one of three variants, and the
variant is chosen here, by ``plan()``, from shapes and dtype alone:

* ``tc``    — bf16 prefill on the tensor cores (wgmma, TMA-fed K/V ring),
              when a (row, kv head) has more than 64 packed rows
              Sq·G and D is 32, 64, 128 or 256;
* ``split`` — split-KV decode (flash-decoding) in bf16 or fp32, when
              Sq·G <= 64: ``n_split`` blocks per (row, kv head) write fp32
              partials to a scratch buffer that a second kernel combines
              (bf16 with Sq·G <= 16 and D in {64, 128, 256} on the tensor
              cores by ``mma.sync``, the rest on the CUDA cores);
* ``simt``  — the first design on the CUDA cores: fp32 prefill and any
              other head_dim (a multiple of 4, at most 256).

No variant stands in for another that fails to build or launch.

The backward, ``flash_attention_bwd_cuda``, is a kernel of its own
(``csrc/flash_attention_bwd.cu``, C entry ``fa_backward``, its own
library), for scalar ``q_offset``/``kv_len`` only: three passes (lse and
delta; dk and dv per key block and query chunk, then a fixed-order
combine of the chunks; dq per row block) in one of two variants, chosen
by ``plan_bwd()`` from dtype, head_dim and group size:

* ``tc``   — bf16 with D in {32, 64, 128, 256} and H / K dividing 64:
             the passes on the tensor cores (wgmma, tiles streamed by TMA,
             two warpgroups exchanging P and dS through shared memory);
* ``simt`` — fp32 (held to 1e-4, which TF32 would miss) and other head
             dims: the CUDA-core passes.

It has no TPU counterpart: the reference trains through XLA attention.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Tuple, Union

import torch

from repro_torch.kernels.build import CSRC, CudaLibrary

MASK_IDS = {"full": 0, "causal": 1, "local": 2, "prefix": 3}
VARIANTS = ("tc", "split", "simt")
VARIANT_IDS = {name: i for i, name in enumerate(VARIANTS)}
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (32, 64, 128, 256)
SPLIT_MAX_ROWS = 64       # packed rows Sq·G one split block holds
SPLIT_MIN_KEYS = 64       # a split keeps at least this many keys
SMS = 132                 # streaming multiprocessors of an H100 SXM
TC_ROWS = 128             # packed rows per tc block (two warpgroups of 64)

RowsArg = Union[int, torch.Tensor]


def plan(B: int, Sq: int, Sk: int, H: int, K: int, D: int,
         dtype: torch.dtype) -> Tuple[str, int]:
    """(variant, n_split) for one call; ``n_split`` is 1 except for
    ``split``, where it is chosen so that B·K·n_split >= 2 x 132 blocks
    unless that would leave a split fewer than 64 keys."""
    rows = Sq * (H // K)
    if rows <= SPLIT_MAX_ROWS:
        want = math.ceil(2 * SMS / max(B * K, 1))
        return "split", max(1, min(want, Sk // SPLIT_MIN_KEYS))
    if dtype == torch.bfloat16 and D in TC_HEAD_DIMS:
        return "tc", 1
    return "simt", 1


def visible(B: int, Sq: int, Sk: int, *, mask_type: str, window: int,
            prefix_len: int, q_offset: RowsArg, kv_len) -> torch.Tensor:
    """(B, Sq, Sk) bool: which keys each query of each row attends to
    (``kv_len`` None: all Sk), on the device of a per-row argument, else
    on the CPU."""
    from repro_torch.kernels.flash_attention.ref import allowed_mask
    dev = next((x.device for x in (q_offset, kv_len) if isinstance(x, torch.Tensor)),
               torch.device("cpu"))
    qo = torch.as_tensor(q_offset, device=dev).reshape(-1)
    q_pos = qo[:, None] + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    vis = allowed_mask(q_pos, k_pos, mask_type, window, prefix_len).expand(B, Sq, Sk)
    if kv_len is not None:
        lim = torch.as_tensor(kv_len, device=dev).reshape(-1)[:, None, None]
        vis = vis & (k_pos < lim)
    return vis


def cost(B: int, Sq: int, Sk: int, H: int, K: int, D: int, dtype: torch.dtype, *,
         mask_type: str = "causal", window: int = 0, prefix_len: int = 0,
         q_offset: RowsArg = 0, kv_len=None) -> Tuple[float, float]:
    """(flops, bytes) of one forward call, whatever computes it: 4 D
    flops a visible (query, key) pair and query head (q·kᵀ and p·v), and
    the bytes of q and the output and of the keys and values some query
    of the row sees, each read or written once."""
    vis = visible(B, Sq, Sk, mask_type=mask_type, window=window,
                  prefix_len=prefix_len, q_offset=q_offset, kv_len=kv_len)
    flops = 4.0 * D * H * int(vis.sum().item())
    kv_rows = int(vis.any(dim=1).sum().item())
    return flops, float(dtype.itemsize * (2 * B * Sq * H * D + 2 * kv_rows * K * D))


def cost_bwd(B: int, Sq: int, Sk: int, H: int, K: int, D: int, dtype: torch.dtype, *,
             mask_type: str = "causal", window: int = 0, prefix_len: int = 0,
             q_offset: int = 0, kv_len=None) -> Tuple[float, float]:
    """(flops, bytes) of one backward call: five products of 2 D flops a
    visible pair and query head (s, dv, dp, dq, dk), and q, o, do, dq and
    k, v, dk, dv each read or written once."""
    vis = visible(B, Sq, Sk, mask_type=mask_type, window=window,
                  prefix_len=prefix_len, q_offset=q_offset, kv_len=kv_len)
    flops = 10.0 * D * H * int(vis.sum().item())
    return flops, float(dtype.itemsize * 4 * D * (B * Sq * H + B * Sk * K))


def tc_warpgroups(B: int, Sq: int, H: int, K: int) -> int:
    """Warpgroups (64 rows each) of a ``tc`` block: two, unless
    128-row blocks would fill fewer than 132 SMs."""
    blocks = math.ceil(Sq * (H // K) / TC_ROWS) * K * B
    return 2 if blocks >= SMS else 1


def scratch_shape(B: int, Sq: int, H: int, K: int, D: int,
                  n_split: int) -> Tuple[int, ...]:
    """fp32 partials of the ``split`` variant: per split, row, kv head and
    packed row, the unnormalised accumulator (D) then m and l."""
    return (n_split, B, K, Sq * (H // K), D + 2)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fa_forward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                   + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    lib.fa_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.fa_smem_bytes.restype = ctypes.c_size_t


LIBRARY = CudaLibrary("flash_attention", CSRC / "flash_attention.cu", _bind)
#: the last build's {"seconds", "ptxas", "path"} (chip_smoke prints it)
build_info = LIBRARY.build_info
library = LIBRARY.load


def shared_memory_bytes(head_dim: int, variant: str = "simt", rows: int = 64,
                        bf16: bool = True, warpgroups: int = 2) -> int:
    """Dynamic shared memory one block of ``variant`` takes at ``head_dim``
    (``rows``: packed rows of a split block)."""
    return int(library().fa_smem_bytes(VARIANT_IDS[variant], head_dim, rows,
                                       int(bf16), warpgroups))


def _rows_arg(name: str, x: RowsArg, B: int, device):
    """(scalar, row pointer) for the C call: an int goes as itself with a
    null pointer; a tensor as a contiguous int32 (B,) tensor on ``device``
    (a 0-d tensor is expanded there, without a copy from the host)."""
    if not isinstance(x, torch.Tensor):
        return int(x), None
    if x.ndim > 1 or (x.ndim == 1 and x.shape[0] != B):
        raise ValueError(f"flash_attention: {name} must be a scalar or a "
                         f"({B},) tensor, got {tuple(x.shape)}")
    t = x.to(device=device, dtype=torch.int32)
    return 0, (t.expand(B) if t.ndim == 0 else t).contiguous()


def _check_inputs(fn: str, mask_type: str, **ts: torch.Tensor):
    """Check the kernels' common contract and return (B, Sq, Sk, H, K, D):
    CUDA tensors of one dtype (bf16 or fp32), q-shaped (B, Sq, H, D) and
    k-shaped (B, Sk, K, D) with H % K == 0, head_dim a multiple of 4 up to
    256, contiguous and 16-byte aligned.  ``ts`` holds q and k and any of
    v, o, do (o and do are q-shaped, v k-shaped)."""
    q, k = ts["q"], ts["k"]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         f"(bf16 or fp32)")
    for name, t in ts.items():
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {dev}")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {', '.join(ts)} must be 4-d")
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    want = {name: (q.shape if name in ("q", "o", "do") else (B, Sk, K, D))
            for name in ts}
    if any(t.shape != want[name] for name, t in ts.items()) or H % K:
        shapes = ", ".join(f"{n} {tuple(t.shape)}" for n, t in ts.items())
        raise ValueError(f"flash_attention: shapes {shapes} disagree")
    if D % 4 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} must be a multiple "
                         f"of 4 and at most {MAX_HEAD_DIM}")
    if not all(t.is_contiguous() for t in ts.values()):
        raise ValueError(f"flash_attention: {', '.join(ts)} must be contiguous")
    if any(t.data_ptr() % 16 for t in ts.values()):
        raise ValueError(f"flash_attention: {', '.join(ts)} must be 16-byte "
                         f"aligned")
    if mask_type not in MASK_IDS:
        raise ValueError(f"unknown mask_type {mask_type!r}")
    return B, Sq, Sk, H, K, D


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         q_offset: RowsArg, kv_len: RowsArg,
                         mask_type: str, window: int, prefix_len: int,
                         scale: float, softcap: float) -> torch.Tensor:
    """Launch the planned variant: q (B, Sq, H, D), k/v (B, Sk, K, D)
    contiguous CUDA tensors of one dtype (bf16 or fp32), 16-byte aligned;
    ``q_offset``/``kv_len`` ints or per-row (B,) integer tensors.  Returns
    a new (B, Sq, H, D) tensor."""
    B, Sq, Sk, H, K, D = _check_inputs("flash_attention_cuda", mask_type,
                                       q=q, k=k, v=v)
    dev = q.device
    qo, qo_rows = _rows_arg("q_offset", q_offset, B, dev)
    kl, kl_rows = _rows_arg("kv_len", kv_len, B, dev)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    variant, n_split = plan(B, Sq, Sk, H, K, D, q.dtype)
    scratch = (torch.empty(scratch_shape(B, Sq, H, K, D, n_split),
                           dtype=torch.float32, device=dev)
               if variant == "split" else None)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    lib = library()
    # the launch goes to the thread's current device: switch only if q is
    # elsewhere (the switch costs host time on every call)
    switch = (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
              else contextlib.nullcontext())
    with switch:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), ptr(qo_rows), ptr(kl_rows), qo, kl,
                            B, Sq, Sk, H, K, D, MASK_IDS[mask_type],
                            int(window), int(prefix_len),
                            float(scale), float(softcap),
                            int(q.dtype == torch.bfloat16), VARIANT_IDS[variant],
                            n_split, tc_warpgroups(B, Sq, H, K),
                            ptr(scratch), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel ({variant}) launch "
                           f"failed: CUDA error {rc}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_variant[variant] += 1
    return out


#: op calls that launched a kernel since the count was last set to 0 (the
#: split variant's combine kernel is part of its call, not a launch more)
flash_attention_cuda.launches = 0
#: the same calls by variant
flash_attention_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)


# ---------------------------------------------------------------------------
# The backward: ``csrc/flash_attention_bwd.cu``, its own library
# ---------------------------------------------------------------------------


BWD_VARIANTS = ("tc", "simt")
BWD_VARIANT_IDS = {name: i for i, name in enumerate(BWD_VARIANTS)}
BWD_TILE = 64      # packed rows and keys per tile of every tc pass


def plan_bwd(B: int, Sq: int, Sk: int, H: int, K: int, D: int,
             dtype: torch.dtype) -> str:
    """The backward variant for one call: ``tc`` for bf16 with D in
    ``TC_HEAD_DIMS`` and a group size G = H / K that divides 64 (a TMA box
    of its packed rows holds 64 / G queries of G heads), ``simt``
    otherwise.  B, Sq and Sk do not change the pick."""
    tc = dtype == torch.bfloat16 and D in TC_HEAD_DIMS and BWD_TILE % (H // K) == 0
    return "tc" if tc else "simt"


def bwd_rows_seeing(k0: int, nk: int, Sq: int, G: int, q_offset: int, klim: int,
                    mask_type: str, window: int, prefix_len: int) -> Tuple[int, int]:
    """The packed rows [lo, hi) whose queries see any key of [k0, k0 + nk)
    (the kernel's ``rows_seeing``)."""
    qp_lo, qp_hi = q_offset, q_offset + Sq
    k_last = min(k0 + nk, klim) - 1
    if k_last < k0:
        qp_hi = qp_lo
    elif mask_type == "causal":
        qp_lo = max(qp_lo, k0)
    elif mask_type == "local":
        qp_lo, qp_hi = max(qp_lo, k0), min(qp_hi, k_last + window)
    elif mask_type == "prefix" and k0 >= prefix_len:
        qp_lo = max(qp_lo, k0)
    lo = (qp_lo - q_offset) * G
    return lo, max(lo, (qp_hi - q_offset) * G)


@functools.lru_cache(maxsize=1024)
def bwd_dkv_blocks(Sq: int, Sk: int, G: int, q_offset: int, klim: int, mask_type: str,
                   window: int, prefix_len: int, chunk: int) -> int:
    """Blocks of the ``tc`` backward's dk/dv pass that do work, for one
    (row, kv head), with query chunks of ``chunk`` row tiles: per 64-key
    block, the rows that see it cut into chunks, at least one (the
    kernel's ``chunks_of``).  Each writes one (64 keys, D) pair of fp32
    partials, packed, so this also sizes the scratch; the grid holds as
    many chunks for every key block as the most any has, and the blocks
    past a key block's last chunk return at once."""
    T = BWD_TILE
    return sum(max(1, -(-(hi - lo) // (chunk * T))) for lo, hi in (
        bwd_rows_seeing(k0, min(T, Sk - k0), Sq, G, q_offset, klim, mask_type, window,
                        prefix_len) for k0 in range(0, Sk, T)))


@functools.lru_cache(maxsize=256)
def bwd_chunk_tiles(B: int, Sq: int, Sk: int, H: int, K: int, mask_type: str,
                    window: int, prefix_len: int, q_offset: int, kv_len: int) -> int:
    """Row tiles (64 packed rows each) per query chunk of the ``tc``
    backward's dk/dv pass: the fewest that keep its grid, one block per
    (row, kv head, 64-key block, chunk), within two waves of 132 blocks
    (one block fills an SM), so that no third wave of a few blocks
    lengthens the pass.  gemma-2b's training call (B=1, S=2048, 8 heads
    over 1, causal) gets 17: 264 blocks that do work."""
    G, klim = H // K, min(kv_len, Sk)

    def blocks(c: int) -> int:
        return B * K * bwd_dkv_blocks(Sq, Sk, G, q_offset, klim, mask_type, window,
                                      prefix_len, c)

    lo, hi = 1, max(1, -(-Sq * G // BWD_TILE))
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if blocks(mid) <= 2 * SMS else (mid + 1, hi)
    return lo


def _bind_bwd(lib: ctypes.CDLL) -> None:
    fn = lib.fa_backward
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.fa_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fa_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.fa_bwd_scratch_floats.argtypes = [ctypes.c_int] * 8
    lib.fa_bwd_scratch_floats.restype = ctypes.c_size_t


BWD_LIBRARY = CudaLibrary("flash_attention_bwd", CSRC / "flash_attention_bwd.cu",
                          _bind_bwd)
#: the last backward build's {"seconds", "ptxas", "path"}
bwd_build_info = BWD_LIBRARY.build_info
bwd_library = BWD_LIBRARY.load


def bwd_shared_memory_bytes(pass_: int, head_dim: int, variant: str = "simt") -> int:
    """Dynamic shared memory of one block of backward pass 1, 2 or 3 of
    ``variant`` (0 where it has no instance at ``head_dim``)."""
    return int(bwd_library().fa_bwd_smem_bytes(BWD_VARIANT_IDS[variant], pass_,
                                                head_dim))


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, do: torch.Tensor, *,
                             q_offset: RowsArg, kv_len: RowsArg,
                             mask_type: str, window: int, prefix_len: int,
                             scale: float, softcap: float
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the planned backward variant: (dq, dk, dv) of
    ``flash_attention_cuda`` at its output ``o`` and output gradient
    ``do`` (q-shaped), contiguous CUDA tensors of q's dtype.  ``q_offset``
    and ``kv_len`` must be ints (training passes 0 and Sk); a per-row
    tensor raises, and so does a configuration in which some query sees
    no key."""
    shape = _check_inputs("flash_attention_bwd_cuda", mask_type,
                          q=q, k=k, v=v, o=o, do=do)
    variant = plan_bwd(*shape, q.dtype)
    out = _bwd(q, k, v, o, do, variant, shape, q_offset, kv_len, mask_type,
               window, prefix_len, scale, softcap)
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.launches_by_variant[variant] += 1
    return out


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               o: torch.Tensor, do: torch.Tensor, variant: str, *,
               q_offset: RowsArg, kv_len: RowsArg, mask_type: str, window: int,
               prefix_len: int, scale: float, softcap: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's ``variant`` on these inputs, whatever ``plan_bwd``
    would pick, without counting a launch (for timing both variants)."""
    shape = _check_inputs("flash_attention_bwd_cuda", mask_type,
                          q=q, k=k, v=v, o=o, do=do)
    if variant not in BWD_VARIANT_IDS:
        raise ValueError(f"unknown backward variant {variant!r} (known: {BWD_VARIANTS})")
    return _bwd(q, k, v, o, do, variant, shape, q_offset, kv_len, mask_type,
                window, prefix_len, scale, softcap)


def _bwd(q, k, v, o, do, variant, shape, q_offset, kv_len, mask_type, window,
         prefix_len, scale, softcap):
    B, Sq, Sk, H, K, D = shape
    for name, x in (("q_offset", q_offset), ("kv_len", kv_len)):
        if isinstance(x, torch.Tensor):
            raise ValueError(f"flash_attention backward: {name} must be an "
                             f"int (per-row tensors are the serve path's, "
                             f"which has no backward)")
    qo, kl = int(q_offset), min(int(kv_len), Sk)
    # the first key the last query sees (local: its window's start)
    last_first = max(0, qo + Sq - int(window)) if mask_type == "local" else 0
    if qo < 0 or kl < 1 or last_first >= kl or (mask_type == "local" and window < 1):
        raise ValueError(f"flash_attention backward: some query sees no key "
                         f"(q_offset {qo}, kv_len {kl}, {mask_type} "
                         f"window {window}): its gradient is undefined here")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dev = q.device
    lib = bwd_library()
    qchunk = items = 0
    if variant == "tc":
        qchunk = bwd_chunk_tiles(B, Sq, Sk, H, K, mask_type, int(window), int(prefix_len),
                                 qo, kl)
        items = bwd_dkv_blocks(Sq, Sk, H // K, qo, kl, mask_type, int(window),
                               int(prefix_len), qchunk)
    # lse, delta and the dk/dv partials of the query chunks (csrc's layout)
    scratch = torch.empty(lib.fa_bwd_scratch_floats(B, Sq, Sk, H, K, D,
                                                    BWD_VARIANT_IDS[variant], items),
                          dtype=torch.float32, device=dev)
    switch = (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
              else contextlib.nullcontext())
    with switch:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fa_backward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), do.data_ptr(), dq.data_ptr(),
                             dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
                             B, Sq, Sk, H, K, D,
                             MASK_IDS[mask_type], int(window), int(prefix_len),
                             qo, kl, float(scale), float(softcap),
                             int(q.dtype == torch.bfloat16),
                             BWD_VARIANT_IDS[variant], qchunk, items, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel ({variant}) launch "
                           f"failed: CUDA error {rc}")
    return dq, dk, dv


#: backward calls that launched the kernel (its passes and combine are one call)
flash_attention_bwd_cuda.launches = 0
#: the same calls by variant
flash_attention_bwd_cuda.launches_by_variant = dict.fromkeys(BWD_VARIANTS, 0)
