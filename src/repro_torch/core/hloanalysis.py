"""Op-class cost analysis of one eager step (port of
``repro.core.hloanalysis``).

There is no HLO in eager PyTorch: the reference parses a compiled XLA
module; the port runs the step once, untimed, and counts what it
executes.  ``analyze_step`` runs it under a ``TorchDispatchMode`` that
sees every aten op after autograd (the backward's too, and each
recomputation under ``torch.utils.checkpoint``):

* flops from ``torch.utils.flop_counter``'s formulas (matmuls and
  convolutions), else one per output element (the reference's
  elementwise estimate);
* bytes as the inputs plus outputs of each op that is not a view, which
  is what eager HBM traffic is, since nothing fuses (a gather reads only
  the rows it outputs, a copy or scatter writes only what it is given, a
  fill only writes);
* the port's own kernels (flash attention forward and backward, the SSD,
  the RG-LRU) launch through ctypes, which no dispatch mode sees: each
  call reports its kernel's ``cost()`` to the pass as attention work
  (``kernels.accounting``, from inside the custom op), and neither the op
  itself nor the aten ops of its plain version on the CPU are counted
  again.

``HloCost`` keeps the reference's fields and invariants:
``sum(flops_by_class) == flops`` and ``sum(bytes_by_class) ==
bytes_accessed``.  ``op_class`` names the class of an aten op
(``aten::mm`` / ``aten.mm.default``) or of a CUDA kernel by its name, as
``torch.profiler`` reports it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels.accounting import accounting, is_kernel_op

#: time-attribution op classes (profiler subsystem, src/repro_torch/profiler/):
#:   matmul      matrix products (cuBLAS on the card)
#:   attention   the port's own kernels: flash attention, SSD, RG-LRU
#:   collective  inter-card communication
#:   elementwise pointwise ops, casts and copies
#:   other       everything else (reductions, indexing, scans, ...)
OP_CLASSES = ("matmul", "attention", "collective", "elementwise", "other")


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)
    # per-op-class tallies (see OP_CLASSES); invariants kept by tally_*:
    # sum(flops_by_class) == flops, sum(bytes_by_class) == bytes_accessed
    flops_by_class: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_class: Dict[str, float] = dataclasses.field(default_factory=dict)

    def tally_flops(self, cls: str, flops: float) -> None:
        self.flops += flops
        self.flops_by_class[cls] = self.flops_by_class.get(cls, 0.0) + flops

    def tally_bytes(self, cls: str, nbytes: float) -> None:
        self.bytes_accessed += nbytes
        self.bytes_by_class[cls] = self.bytes_by_class.get(cls, 0.0) + nbytes


# ---- op classes ------------------------------------------------------------

_MATMUL_OPS = frozenset((
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "matmul", "linear", "einsum",
    "mv", "addmv", "dot", "vdot", "_scaled_mm", "convolution", "_convolution",
    "conv1d", "conv2d", "convolution_backward"))
_COPY_OPS = frozenset((
    "copy_", "copy", "_to_copy", "to", "clone", "contiguous", "fill_", "zero_",
    "zeros_like", "ones_like", "full_like", "lift_fresh_copy"))
_COLLECTIVE_RE = re.compile(r"nccl|all_?reduce|all_?gather|reduce_scatter|all_?to_?all",
                            re.IGNORECASE)
# the port's kernels: every __global__ of src/repro_torch/csrc/*.cu starts so
_PORT_KERNEL_RE = re.compile(r"(?<!\w)(fa|ssd|rglru)_\w")
_KERNEL_MATMUL = ("gemm", "gemv", "xmma", "nvjet", "cutlass", "sm90_", "sm80_",
                  "splitkreduce", "cublas")
_KERNEL_ELEMENTWISE = ("elementwise", "vectorized", "unrolled", "copy", "cast",
                       "multi_tensor_apply", "memcpy", "memset", "fill")
# Inductor's generated Triton kernels by kind: pointwise, reduction,
# persistent reduction, template (a matrix product of max-autotune)
_INDUCTOR_RE = re.compile(r"(?<![a-z])triton_(poi|red|per|tem)_")
_INDUCTOR_CLASS = {"poi": "elementwise", "red": "other", "per": "other", "tem": "matmul"}


@functools.lru_cache(maxsize=4096)
def op_class(name: str) -> str:
    """The attribution class (see OP_CLASSES) of an aten op, named
    ``aten::mm`` or ``aten.mm.default``, or of a CUDA kernel, named as
    ``torch.profiler`` reports it (a demangled signature).  A compiled
    step's kernels: Inductor's Triton kernels by their kind
    (``triton_poi_*`` pointwise: elementwise; ``triton_red_*`` and
    ``triton_per_*`` reductions: other; ``triton_tem_*`` a template
    product: matmul), and the library calls its code makes
    (``extern_kernels.mm``) as the aten op of that name."""
    if _COLLECTIVE_RE.search(name):
        return "collective"
    for prefix in ("aten::", "aten.", "extern_kernels."):
        if name.startswith(prefix):
            return _aten_class(name[len(prefix):].split(".")[0])
    inductor = _INDUCTOR_RE.search(name)
    if inductor:
        return _INDUCTOR_CLASS[inductor.group(1)]
    if _PORT_KERNEL_RE.search(name):
        return "attention"
    low = name.lower()
    if any(key in low for key in _KERNEL_MATMUL):
        return "matmul"
    if any(key in low for key in _KERNEL_ELEMENTWISE):
        return "elementwise"
    return "other"


def _aten_class(base: str) -> str:
    if base in _MATMUL_OPS:
        return "matmul"
    if base in _COPY_OPS or base.startswith("_foreach_"):
        return "elementwise"
    packet = getattr(torch.ops.aten, base, None)
    if packet is not None:
        for overload in packet.overloads():
            if torch.Tag.pointwise in getattr(packet, overload).tags:
                return "elementwise"
    return "other"


# ---- the analysis pass -----------------------------------------------------

# allocations, reshapes and host reads besides the views: no bytes move
_FREE_OPS = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "_local_scalar_dense", "set_", "resize_"))
# read the rows they output (and the indices): 2 x output bytes + indices
_GATHER_OPS = frozenset(("embedding", "index_select", "gather", "index", "take"))
# write into the first argument only what the others give: 2 x their bytes
_WRITE_INTO_OPS = frozenset((
    "copy_", "index_copy_", "index_copy", "index_put_", "index_put", "scatter_", "scatter",
    "index_add_", "index_add", "scatter_add_", "scatter_add", "masked_scatter_"))
# write their output without reading an input
_WRITE_ONLY_OPS = frozenset((
    "fill_", "zero_", "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
    "new_zeros", "new_ones", "new_full", "arange", "normal_", "uniform_", "random_",
    "scalar_tensor"))


def _nbytes(x: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _first_numel(x: Any) -> int:
    return next((t.numel() for t in tree_leaves(x) if isinstance(t, torch.Tensor)), 0)


class _StepCost(TorchDispatchMode):
    """Counts the flops and bytes of every aten op it sees, by class; the
    port's kernel calls report to it through ``kernels.accounting``
    (``depth`` > 0 inside one: its plain version's ops are not counted)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.cost = HloCost()
        self.depth = 0
        self.kernels: Dict[str, int] = {}

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.cost.tally_flops("attention", flops)
        self.cost.tally_bytes("attention", nbytes)
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth == 0 and not is_kernel_op(func):
            self._tally(func, args, kwargs, out)
        return out

    def _tally(self, func, args, kwargs, out) -> None:
        name = func._schema.name
        base = name.split("::")[-1]
        if func.is_view or base in _FREE_OPS:
            return
        cls = op_class(name)
        packet = func.overloadpacket
        if packet in self.flop_registry:
            flops = float(self.flop_registry[packet](*args, **kwargs, out_val=out))
        else:
            flops = float(_first_numel(out))
        if base in _GATHER_OPS:
            nbytes = 2 * _nbytes(out) + sum(
                t.numel() * t.element_size() for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor) and not t.is_floating_point())
        elif base in _WRITE_INTO_OPS:
            nbytes = 2 * _nbytes((args[1:], kwargs))
        elif base in _WRITE_ONLY_OPS:
            nbytes = _nbytes(out)
        else:
            nbytes = _nbytes((args, kwargs)) + _nbytes(out)
        self.cost.tally_flops(cls, flops)
        self.cost.tally_bytes(cls, float(nbytes))


def _snapshot(x: Any, tensors: list, bindings: list) -> None:
    """Record every tensor reachable from ``x`` (a module's parameters and
    buffers, containers' entries) with a host copy of its values, and
    every mutable container with its entries."""
    if isinstance(x, torch.Tensor):
        tensors.append((x, x.detach().to("cpu", copy=True)))
    elif isinstance(x, torch.nn.Module):
        for t in list(x.parameters()) + list(x.buffers()):
            tensors.append((t, t.detach().to("cpu", copy=True)))
    elif isinstance(x, dict):
        bindings.append((x, dict(x)))
        for v in x.values():
            _snapshot(v, tensors, bindings)
    elif isinstance(x, (list, tuple)):
        if isinstance(x, list):
            bindings.append((x, list(x)))
        for v in x:
            _snapshot(v, tensors, bindings)


@contextlib.contextmanager
def preserved(args: Sequence, mutable: Tuple[int, ...]) -> Iterator[None]:
    """Leave the argument slots ``mutable`` of ``args`` (a donated cache,
    a train state) as they were across the block, which runs a step on
    them: their values are copied to the host before it and written back
    after it, and their containers' entries put back, without a second
    copy on the card.  The block's work on the cards of ``args`` is waited
    for before the write-back, so a fault of it raises here."""
    tensors: list = []
    bindings: list = []
    for i in mutable:
        _snapshot(args[i], tensors, bindings)
    try:
        yield
        devices = {t.device for t in tree_leaves(list(args))
                   if isinstance(t, torch.Tensor) and t.is_cuda}
        for d in devices:
            torch.cuda.synchronize(d)
    finally:
        for container, entries in bindings:
            if isinstance(container, dict):
                container.clear()
                container.update(entries)
            else:
                container[:] = entries
        with torch.no_grad():
            for t, saved in tensors:
                t.copy_(saved)


def analyze_step(fn: Callable, args: Sequence = (),
                 mutable: Tuple[int, ...] = ()) -> HloCost:
    """The op-class cost of one call ``fn(*args)``, run once, untimed.

    ``mutable`` are the argument slots the call updates in place: the
    pass leaves them as it found them (``preserved``)."""
    counter = _StepCost()
    with preserved(args, mutable), accounting(counter), counter:
        fn(*args)
    if counter.kernels:
        counter.cost.notes.append(
            "kernel calls: " + ", ".join(f"{k} {n}" for k, n in sorted(counter.kernels.items())))
    return counter.cost
