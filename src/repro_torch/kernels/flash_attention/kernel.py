"""The hand-written CUDA flash-attention kernel: build, load, launch.

Port of the Pallas TPU kernel ``repro.kernels.flash_attention.kernel.
flash_attention_bh``; the source and its design note are in
``src/repro_torch/csrc/flash_attention.cu``.  It is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface and bound
with ``ctypes``.  The build happens at first use, never at import: the
library lands in ``build/`` at the root of the checkout under a name keyed
by the source's hash, so a changed source rebuilds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
MASK_IDS = {"full": 0, "causal": 1, "local": 2, "prefix": 3}
MAX_HEAD_DIM = 256

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: the last build's {"seconds", "ptxas", "path"} (chip_smoke prints it)
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the flash-attention kernel is built "
                       "from source at first use on a CUDA machine")


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
        path = BUILD_DIR / f"{NAME}-{digest}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, str(SOURCE)]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                os.remove(tmp)
                raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n"
                                   f"{r.stderr[-4000:]}")
            os.replace(tmp, path)
            build_info.update(seconds=time.perf_counter() - t0,
                              ptxas=r.stderr.strip(), path=str(path))
        else:
            build_info.setdefault("seconds", 0.0)
            build_info.setdefault("path", str(path))
        lib = ctypes.CDLL(str(path))
        fn = lib.fa_forward
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fa_smem_bytes.argtypes = [ctypes.c_int]
        lib.fa_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
        return lib


def shared_memory_bytes(head_dim: int) -> int:
    """Dynamic shared memory one block of the kernel takes at ``head_dim``."""
    return int(library().fa_smem_bytes(head_dim))


def _check_rows(name: str, t: torch.Tensor, B: int, device) -> None:
    if t.device != device or t.dtype != torch.int32 or t.shape != (B,) \
            or not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be a contiguous "
                         f"int32 ({B},) tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         q_offset: torch.Tensor, kv_len: torch.Tensor,
                         mask_type: str, window: int, prefix_len: int,
                         scale: float, softcap: float) -> torch.Tensor:
    """Launch the kernel: q (B, Sq, H, D), k/v (B, Sk, K, D) contiguous CUDA
    tensors of one dtype (bf16 or fp32); ``q_offset``/``kv_len`` int32 (B,)
    on the same device.  Returns a new (B, Sq, H, D) tensor."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         f"(bf16 or fp32)")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {dev}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d")
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    if k.shape != (B, Sk, K, D) or v.shape != k.shape or H % K:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if D % 4 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} must be a multiple "
                         f"of 4 and at most {MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if mask_type not in MASK_IDS:
        raise ValueError(f"unknown mask_type {mask_type!r}")
    _check_rows("q_offset", q_offset, B, dev)
    _check_rows("kv_len", kv_len, B, dev)
    out = torch.empty_like(q)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), q_offset.data_ptr(),
                            kv_len.data_ptr(), B, Sq, Sk, H, K, D,
                            MASK_IDS[mask_type], int(window), int(prefix_len),
                            float(scale), float(softcap),
                            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"CUDA error {rc}")
    flash_attention_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
flash_attention_cuda.launches = 0
