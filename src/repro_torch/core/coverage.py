"""API-surface coverage analysis (port of ``repro.core.coverage``; the
paper's central claim, adapted).

TorchBench's key differentiator is covering 2.3x more of the PyTorch API
surface than MLPerf.  The reference's two layers are the port's two:

* **torch API surface** — the set of ``torch.*`` functions and ``Tensor``
  methods (property reads among them) a benchmark's step calls, as a
  ``TorchFunctionMode`` sees them and ``torch.overrides.resolve_name``
  names them (``torch.Tensor.add``, ``torch.nn.functional.gelu``): what the
  model code exercises, TorchBench's own ``api-coverage`` method, and the
  analogue of the reference's jaxpr primitives;
* **ATen op surface** — the set of ops a ``TorchDispatchMode`` sees, by
  schema name (``aten::mm``), after autograd, so the backward's ops too:
  what the backend stack must handle, the analogue of the reference's
  StableHLO ops.

Each of the port's kernel calls is one op of both surfaces, named
``repro_torch.kernel::<name>`` (``kernels.accounting``), and the ops
inside it are not counted: on the card its ctypes launch shows through
neither mode, on the CPU its plain version would show as many ops.  So a
step's surfaces are the same on either device.

The reference traces abstractly; the port's pass runs the step once,
untimed, and leaves the argument slots the step updates in place as it
found them (``hloanalysis.preserved``).  On the card the pass launches
kernels, and its errors are raised, not swallowed.

``coverage_report`` computes per-benchmark sets, the suite union, and the
coverage ratio of the suite vs. any single benchmark / sub-suite — the
quantitative form of the paper's "2.3x MLPerf" comparison (the
MLPerf-proxy is the single-arch {gemma-2b} sub-suite: one dense LM, which
is what a small cross-framework suite typically includes).  Its keys are
the reference's: ``*_primitives`` count the torch API surface and
``*_stablehlo_ops`` the ATen op surface.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from torch.overrides import TorchFunctionMode, resolve_name
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.hloanalysis import preserved
from repro_torch.device import DeviceLike
from repro_torch.kernels.accounting import SCOPE_PREFIX, accounting


def api_name(func: Callable) -> str:
    """The torch API name of a function a ``TorchFunctionMode`` sees
    (``torch.overrides``' name; else module and name, as for
    ``torch._foreach_add_``)."""
    name = resolve_name(func)
    if name is None:
        module = getattr(func, "__module__", None) or "torch"
        name = f"{module}.{getattr(func, '__name__', repr(func))}"
    return name


class _Surfaces:
    """The two surfaces of one run; ``depth`` and ``add_kernel`` make it a
    pass of ``kernels.accounting`` (``depth`` > 0 inside a kernel call)."""

    def __init__(self):
        self.api: Set[str] = set()
        self.aten: Set[str] = set()
        self.depth = 0

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.api.add(SCOPE_PREFIX + name)
        self.aten.add(SCOPE_PREFIX + name)


class _ApiMode(TorchFunctionMode):
    def __init__(self, surfaces: _Surfaces):
        super().__init__()
        self.surfaces = surfaces

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if self.surfaces.depth == 0:
            self.surfaces.api.add(api_name(func))
        return func(*args, **(kwargs or {}))


class _AtenMode(TorchDispatchMode):
    def __init__(self, surfaces: _Surfaces):
        super().__init__()
        self.surfaces = surfaces

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.surfaces.depth == 0:
            self.surfaces.aten.add(func._schema.name)
        return func(*args, **(kwargs or {}))


def step_surfaces(fn: Callable, args: Sequence = (),
                  mutable: Tuple[int, ...] = ()) -> Tuple[Set[str], Set[str]]:
    """-> (torch API set, ATen op set) of one call ``fn(*args)``, run once;
    ``mutable`` are the argument slots the call updates in place, left as
    they were."""
    surfaces = _Surfaces()
    with preserved(args, mutable), accounting(surfaces), _AtenMode(surfaces), \
            _ApiMode(surfaces):
        fn(*args)
    return surfaces.api, surfaces.aten


def benchmark_surfaces(bench, *, batch: int = 2, seq: int = 32, built=None,
                       device: DeviceLike = "cuda") -> Tuple[Set[str], Set[str]]:
    """-> (torch API set, ATen op set) for a suite Benchmark's step, on
    arguments made for this call (a train step works on a copy of the
    build's weights).

    ``built`` takes a cached arch build (``suite.Built``) so a runner-driven
    report never re-initialises weights just to see the surface;
    ``device`` is used only without it."""
    step, args, _ = bench.make(batch=batch, seq=seq, built=built, device=device)
    return step_surfaces(step, args)


def coverage_report(benches: List, *, baseline_archs: Iterable[str] = ("gemma-2b",),
                    batch: int = 2, seq: int = 32, runner=None,
                    device: Optional[DeviceLike] = None) -> Dict[str, Any]:
    """Per-benchmark surfaces, their union and the suite's ratio over the
    ``baseline_archs`` sub-suite.  ``runner`` lends its cached builds and
    its device; without one the builds are made on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = device or (runner.device if runner is not None else "cuda")
    per: Dict[str, Dict[str, Any]] = {}
    union_prims: Set[str] = set()
    union_ops: Set[str] = set()
    base_prims: Set[str] = set()
    base_ops: Set[str] = set()
    for b in benches:
        built = runner.built_for(b.arch) if runner is not None else None
        prims, ops = benchmark_surfaces(b, batch=batch, seq=seq, built=built, device=device)
        per[b.name] = {"n_primitives": len(prims), "n_stablehlo_ops": len(ops),
                       "primitives": sorted(prims), "stablehlo_ops": sorted(ops)}
        union_prims |= prims
        union_ops |= ops
        if b.arch in baseline_archs:
            base_prims |= prims
            base_ops |= ops
    return {
        "per_benchmark": per,
        "suite_primitives": len(union_prims),
        "suite_stablehlo_ops": len(union_ops),
        "baseline_primitives": len(base_prims),
        "baseline_stablehlo_ops": len(base_ops),
        "coverage_x_primitives": (len(union_prims) / len(base_prims)) if base_prims else 0.0,
        "coverage_x_stablehlo": (len(union_ops) / len(base_ops)) if base_ops else 0.0,
        "union_primitives": sorted(union_prims),
    }
