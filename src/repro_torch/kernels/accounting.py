"""Work accounting for the port's kernel calls (for the profiler).

The CUDA kernels launch through ctypes, which neither a
``TorchDispatchMode`` nor an op record of ``torch.profiler`` sees; on the
CPU the same calls run their plain versions as many aten ops.
``kernel_scope`` makes one kernel call one unit of account on both:

* while an analysis pass is open (``core.hloanalysis.analyze_step``), the
  call reports its flops and bytes (the kernel's ``cost()``) to the pass
  as attention work, and the pass ignores the aten ops inside the call;
* while ``torch.profiler`` records a CPU call, the call is a range named
  ``SCOPE_PREFIX + name``, so a trace counts the plain version's ops as
  attention (``profiler.attribution.trace_device_time``; on the card the
  kernels' own names say so).

Where scopes open: inside the implementations of the custom ops
``kernels/library.py`` registers (namespace ``OP_NAMESPACE``), the CUDA
launch on the card and the plain version on the CPU, and nowhere else.
An op's implementation runs when the op runs, never while
``torch.compile`` traces a step (the trace sees the op's fake), so a
scope's checks and ``cost()``, which may read per-row offsets back from
the device, stay out of every compiled graph, and a compiled step's calls
are counted as an eager step's.  The passes' modes see the op call
itself too and leave it to the scope.

Outside both a scope costs two checks, and ``cost`` is not called.

The open passes are a process-wide list, not thread-local state: on the
card autograd runs the backward, and so the backward kernel's scope, on
its own thread.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Tuple

import torch

#: a CPU trace's range of one plain-version kernel call starts with this
SCOPE_PREFIX = "repro_torch.kernel::"

#: the namespace of the kernels' custom ops (``torch.ops.repro_torch``)
OP_NAMESPACE = "repro_torch"


def is_kernel_op(func) -> bool:
    """Whether ``func`` (an op a dispatch or torch-function mode sees) is
    one of the kernels' custom ops, which report through their scope."""
    return getattr(func, "namespace", None) == OP_NAMESPACE

#: the analysis passes open now, innermost last
_passes: List = []


@contextlib.contextmanager
def accounting(pass_) -> Iterator[None]:
    """Open ``pass_`` (an object with ``add_kernel(name, flops, bytes)``
    and an int ``depth``) to the kernel calls made inside the block."""
    _passes.append(pass_)
    try:
        yield
    finally:
        _passes.remove(pass_)


def kernel_scope(name: str, cost: Callable[[], Tuple[float, float]],
                 device: torch.device):
    """The context one kernel call on ``device`` runs in (see the module
    docstring); ``cost()`` gives the call's (flops, bytes)."""
    active = _passes[-1] if _passes else None
    ranged = device.type == "cpu" and torch.autograd._profiler_enabled()
    if active is None and not ranged:
        return contextlib.nullcontext()
    return _scope(name, cost, active, ranged)


@contextlib.contextmanager
def _scope(name, cost, active, ranged) -> Iterator[None]:
    if active is not None:
        active.depth += 1          # cost()'s own ops are not the call's work
    try:
        if active is not None:
            active.add_kernel(name, *cost())
        if ranged:
            with torch.profiler.record_function(SCOPE_PREFIX + name):
                yield
        else:
            yield
    finally:
        if active is not None:
            active.depth -= 1
