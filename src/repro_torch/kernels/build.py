"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` source under ``src/repro_torch/csrc/`` with a
plain C interface, and includes no header of the repository: the library
is keyed by that one file's hash.  Flash attention keeps its three
variants (tensor-core prefill, split-KV decode, the CUDA-core kernel) in
one file for that reason.  ``CudaLibrary.load()`` compiles it with ``nvcc`` for
``sm_90a`` into a shared library and binds it with ``ctypes``.  The build
happens at first use, never at import: the library lands in ``build/`` at
the root of the checkout under a name keyed by the source's hash, so a
changed source rebuilds.  Libraries build independently (one lock each),
so callers may build several at once from threads: ``nvcc`` runs as a
subprocess and the threads wait on it without holding the GIL.
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
from typing import Callable, Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use on a CUDA machine")


class CudaLibrary:
    """One kernel source built into one shared library.

    ``bind(lib)`` sets the ``argtypes``/``restype`` of the library's C
    functions once it is loaded.  ``build_info`` holds the last build's
    ``seconds``, ``ptxas`` report (registers, spills, shared memory) and
    ``path``.
    """

    def __init__(self, name: str, source: Path,
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = source
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_info: Dict[str, object] = {}

    def load(self) -> ctypes.CDLL:
        """Build (once per source hash) and load the library."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
            path = BUILD_DIR / f"{self.name}-{digest}.so"
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                       "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v", "-o", tmp, str(self.source)]
                t0 = time.perf_counter()
                r = subprocess.run(cmd, capture_output=True, text=True)
                if r.returncode != 0:
                    os.remove(tmp)
                    raise RuntimeError(f"nvcc failed for {self.source.name}:\n"
                                       f"{r.stderr[-4000:]}")
                os.replace(tmp, path)
                self.build_info.update(seconds=time.perf_counter() - t0,
                                       ptxas=r.stderr.strip(), path=str(path))
            else:
                self.build_info.setdefault("seconds", 0.0)
                self.build_info.setdefault("path", str(path))
            lib = ctypes.CDLL(str(path))
            self._bind(lib)
            self._lib = lib
            return lib
